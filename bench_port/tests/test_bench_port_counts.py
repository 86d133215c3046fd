"""The operation and byte counts against hand counts."""

import json

import pytest

from conftest import BENCH_DIR
from benchlib import counts
from benchlib.peaks import H100_SXM


def config(name):
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


def brute_pairs(start, n, window):
    return sum(1 for q in range(start, start + n) for k in range(q + 1)
               if window is None or q - k < window)


@pytest.mark.parametrize("start,n,window", [(0, 8, None), (5, 9, None), (0, 40, 16),
                                            (10, 30, 16), (20, 5, 16), (0, 1, 1)])
def test_visible_pairs_brute(start, n, window):
    assert counts.visible_pairs(start, n, window) == brute_pairs(start, n, window)


def test_causal_hand_count():
    assert counts.visible_pairs(0, 8, None) == 36             # 1 + 2 + ... + 8
    assert counts.visible_pairs(0, 4096, None) == 4096 * 4097 // 2


def test_window_4096_at_8192():
    # the first 4,096 queries see p + 1 keys, the other 4,096 see 4,096 each
    assert counts.visible_pairs(0, 8192, 4096) == 4096 * 4097 // 2 + 4096 * 4096
    chunked = sum(counts.visible_pairs(s, n, 4096) for s, n in counts.chunks(0, 8192, 512))
    assert chunked == 25_167_872


def test_decode_over_known_lengths():
    cfg = config("mistral-7b-v0.1")             # window 4,096, 32 q / 8 kv heads, d 128
    flops, byts = counts.decode_attn_work(cfg, [10, 5000])
    seen = 10 + 4096
    assert flops == 4 * 128 * 32 * seen
    per_token = 8 * 2 * (128 + 4)              # K and V int8 payloads and fp32 scales
    assert byts == seen * per_token + 2 * (2 * 32 * 128 * 2)
    cfg = config("deepseek-llm-7b")             # causal, 32 kv heads
    flops, byts = counts.decode_attn_work(cfg, [3000])
    assert flops == 4 * 128 * 32 * 3000
    assert byts == 3000 * 32 * 2 * (128 + 4) + 2 * 32 * 128 * 2


def test_prefill_keys_read_once():
    cfg = config("mistral-7b-v0.1")
    assert counts.keys_needed(4000, 512, 4096) == 4512
    assert counts.keys_needed(5000, 512, 4096) == 5512 - 905
    flops, byts = counts.prefill_attn_work(cfg, 5000, 512)
    assert flops == 4 * 128 * 32 * 512 * 4096
    assert byts == 2 * 512 * 32 * 128 * 2 + 4607 * counts.kv_token_bytes(cfg)


def test_model_flops_and_bound():
    cfg = config("deepseek-llm-7b")
    per_layer = 4 * 4096 * 4096 + 3 * 4096 * 11008
    assert counts.layer_matmul_params(cfg) == per_layer
    assert counts.token_flops(cfg, True) == 2 * 30 * per_layer + 2 * 102400 * 4096
    step = counts.decode_flops(cfg, [100, 200])
    assert step == 2 * counts.token_flops(cfg, True) + 4 * 128 * 32 * 300 * 30
    assert counts.prefill_flops(cfg, 0, 10) == (10 * counts.token_flops(cfg, False)
                                               + 4 * 128 * 32 * 55 * 30 + 2 * 102400 * 4096)
    assert counts.bound_seconds(989e12, 0, H100_SXM) == pytest.approx(1.0)
    assert counts.bound_seconds(0, 3.35e12, H100_SXM) == pytest.approx(1.0)
