"""The plain reference against the port's own plain path at a tiny size on
the CPU: the training forward (no cache) and the serving engine's greedy
tokens through the int8 cache, causal and under a window."""

import json

import numpy as np
import pytest
import torch

from conftest import BENCH_DIR, TINY
from benchlib import bench, program, weights as W

REF = bench.reference(BENCH_DIR.parent, {"reference": "decoder"})


def tiny(window=None):
    cfg = json.loads((BENCH_DIR / "configs" / "mistral-7b-v0.1.json").read_text())
    cfg.update(TINY, sliding_window=window, torch_dtype="float32")
    return cfg


@pytest.mark.parametrize("window", [None, 5])
def test_matches_the_port_forward(window):
    from tf_flash_attention_tpu_torch.models.transformer import forward
    cfg = tiny(window)
    mcfg = program.model_config(cfg)
    w = W.generate(cfg, 3_000_000_011, "cpu")
    params = program.transformer(mcfg, w, "cpu", master=True)
    tokens = torch.randint(0, cfg["vocab_size"], (1, 24), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ours = forward(mcfg, params, tokens)[0]
    ref = REF.logits(cfg, w, tokens[0], torch.arange(24), kv_int8=False)
    assert torch.allclose(ours, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [None, 12])
def test_matches_the_engine_through_the_int8_cache(window):
    cfg = tiny(window)
    mix = {"max_seqs": 2, "page_size": 8, "n_pages": 20, "max_pages_per_seq": 8,
           "prefill_chunk": 8}
    eng = program.build_engine(cfg, mix, 3_000_000_012, "cpu")
    prompt = np.random.default_rng(0).integers(0, cfg["vocab_size"], 19)
    rid = eng.submit(prompt.tolist(), max_new_tokens=20)
    served = np.asarray(eng.run()[rid][len(prompt):])
    w = W.generate(cfg, 3_000_000_012, "cpu")
    seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]))
    pos = torch.arange(len(prompt) - 1, len(seq))
    ref = REF.logits(cfg, w, seq, pos)
    # float32 on both sides, one int8 cache: the served tokens are the
    # reference's first choice up to rounding
    gap = (ref.max(-1).values - ref.gather(1, torch.as_tensor(served)[:, None])[:, 0]).max()
    assert float(gap) < 1e-4
    # without the int8 round trip the reference is another model
    plain = REF.logits(cfg, w, seq, pos, kv_int8=False)
    assert float((plain - ref).abs().max()) > 1e-4


def test_fp8_control_departs():
    cfg = tiny()
    w = W.generate(cfg, 5, "cpu")
    seq = torch.arange(30) % cfg["vocab_size"]
    ref = REF.logits(cfg, w, seq, torch.arange(30))
    low = REF.logits(cfg, w, seq, torch.arange(30), fp8=True)
    assert float((low - ref).abs().max()) > 10 * 1e-4
