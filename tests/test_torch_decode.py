"""The port's paged decode attention against the JAX kernel, on the CPU.

The JAX side runs its Pallas decode kernel in interpret mode; the port
runs its plain PyTorch version (its CUDA kernel is checked against that
version on the card by ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.mask_rules import LocalRule as JLocalRule
from tf_flash_attention_tpu.serving import decode as jdec
from tf_flash_attention_tpu_torch.mask_rules import LocalRule
from tf_flash_attention_tpu_torch.serving import decode as tdec

from _torch_parity import cache_cfgs, caches_from, random_state

# float32 with an unquantized cache: only the summation order differs
TOL_F32 = 2e-5
# int8 cache: both round q, K, V and p to bf16 before the products; a p
# element whose float32 value differs in the last bit may round to the
# neighbouring bf16 value (2**-8 relative), which moves o by far less
TOL_INT8 = 1e-3


def _run(quantized, n_q, lengths, rule_pair=(None, None), seed=0):
    rng = np.random.default_rng(seed)
    jcfg, tcfg = cache_cfgs(quantized, max_pages_per_seq=4)
    jc, tc = caches_from(random_state(tcfg, rng, lengths), jcfg, tcfg)
    q = rng.uniform(-1, 1, (len(lengths), n_q, 32)).astype(np.float32)
    jkw = {} if rule_pair[0] is None else {"rule": rule_pair[0]}
    tkw = {} if rule_pair[1] is None else {"rule": rule_pair[1]}
    want = np.asarray(jdec.paged_decode_attention(q, jc, jcfg, interpret=True, **jkw))
    got = tdec.paged_decode_attention(torch.from_numpy(q), tc, tcfg, **tkw).numpy()
    return got, want


# GQA (4 q / 2 kv heads), lengths off page multiples, one on a page
# boundary, and an empty slot
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_matches_jax(quantized):
    got, want = _run(quantized, 4, [150, 64, 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_INT8 if quantized else TOL_F32)
    np.testing.assert_array_equal(got[2], 0.0)      # empty slot: exact zeros


@pytest.mark.parametrize("n_q", [2, 8])
def test_paged_decode_group_sizes(n_q):
    got, want = _run(False, n_q, [1, 255, 97], seed=n_q)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("w,s", [(16, 0), (8, 2)])
def test_paged_decode_local_rule(w, s):
    # window rules skip the pages below the oldest row's window
    rules = (JLocalRule(window_size=w, log2_stride_size=s, is_causal=True),
             LocalRule(window_size=w, log2_stride_size=s, is_causal=True))
    got, want = _run(False, 4, [200, 90, 0], rules, seed=5)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


def test_first_live_page_and_visibility_match_jax():
    lengths = np.array([0, 1, 63, 64, 65, 300], np.int32)
    for jr, tr in ((JLocalRule(8, 0, True), LocalRule(8, 0, True)),
                   (JLocalRule(4, 3, True), LocalRule(4, 3, True))):
        want = np.asarray(jdec._first_live_page(jr, lengths, 1, 64))
        got = tdec._first_live_page(tr, torch.from_numpy(lengths), 1, 64).numpy()
        np.testing.assert_array_equal(got, want)
        q_pos, kv_pos = np.arange(70)[:, None], np.arange(70)[None, :]
        np.testing.assert_array_equal(
            tdec._rule_visible(tr, torch.from_numpy(q_pos), torch.from_numpy(kv_pos)).numpy(),
            np.asarray(jdec._rule_visible(jr, q_pos, kv_pos)))


def test_cpu_tensors_take_the_plain_version():
    from tf_flash_attention_tpu_torch import native
    before = native.LAUNCHES["paged_decode"]
    _run(False, 4, [10, 0, 0])
    assert native.LAUNCHES["paged_decode"] == before
