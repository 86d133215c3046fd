"""The port's paged prefill attention against the JAX kernel, on the CPU.

The JAX side runs its Pallas prefill kernel in interpret mode; the port
runs its plain PyTorch version.  Rows past ``true_len`` are padding and
are compared by neither side's contract.  ``quantized`` is False
(unquantized), True (int8) or a payload name (fp8 e4m3, e5m2, int4).
"""

import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.mask_rules import LocalRule as JLocalRule
from tf_flash_attention_tpu.serving import prefill as jpre
from tf_flash_attention_tpu_torch.mask_rules import LocalRule
from tf_flash_attention_tpu_torch.serving import prefill as tpre

from _torch_parity import cache_cfgs, caches_from, random_state

TOL_F32 = 2e-5   # float32, unquantized cache: summation order only
TOL_INT8 = 1e-3  # int8 cache: a bf16-rounded p element may round the other way
TOL_Q = 2e-3     # fp8/int4: the same, at outputs up to ~2.5 (fp8 spans its range)
QUANTIZED = [False, True, "e4m3", "e5m2", "int4"]


def _run(quantized, start, chunk, true_len, n_q=4, rules=(None, None), seed=0, page_size=64,
         max_pages=4):
    rng = np.random.default_rng(seed)
    jcfg, tcfg = cache_cfgs(quantized, page_size=page_size, max_pages_per_seq=max_pages,
                            n_pages=3 * max_pages + 4)
    jc, tc = caches_from(random_state(tcfg, rng, [0, start + true_len, 0]), jcfg, tcfg)
    q = rng.uniform(-1, 1, (chunk, n_q, 32)).astype(np.float32)
    jkw = {} if rules[0] is None else {"rule": rules[0]}
    tkw = {} if rules[1] is None else {"rule": rules[1]}
    want = np.asarray(jpre.paged_prefill_attention(q, jc, jcfg, 1, start, true_len,
                                                   interpret=True, **jkw))
    got = tpre.paged_prefill_attention(torch.from_numpy(q), tc, tcfg, 1, start,
                                       true_len, **tkw).numpy()
    return got[:true_len], want[:true_len]


# start > 0 is a cached prefix; true_len < chunk leaves padding rows
@pytest.mark.parametrize("quantized", QUANTIZED)
@pytest.mark.parametrize("start,chunk,true_len", [(0, 64, 64), (70, 48, 40), (128, 96, 77)])
def test_paged_prefill_matches_jax(quantized, start, chunk, true_len):
    got, want = _run(quantized, start, chunk, true_len)
    tol = TOL_F32 if not quantized else TOL_INT8 if quantized is True else TOL_Q
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_paged_prefill_gqa_8_to_2():
    got, want = _run(False, 100, 32, 32, n_q=8, seed=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


@pytest.mark.parametrize("quantized", ["e4m3", "int4"])
def test_paged_prefill_gqa_8_to_2_quantized(quantized):
    got, want = _run(quantized, 100, 32, 31, n_q=8, seed=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_Q)


@pytest.mark.parametrize("w,s", [(32, 0), (8, 2)])
def test_paged_prefill_local_rule(w, s):
    rules = (JLocalRule(window_size=w, log2_stride_size=s, is_causal=True),
             LocalRule(window_size=w, log2_stride_size=s, is_causal=True))
    got, want = _run(False, 150, 48, 40, rules=rules, seed=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


# pages smaller than the kernel's 32-key sub-tile, and a ragged last
# sub-tile: every page size the JAX engine takes
@pytest.mark.parametrize("quantized", [False, True, "int4"])
@pytest.mark.parametrize("page_size", [8, 16, 48])
def test_paged_prefill_small_pages_match_jax(quantized, page_size):
    got, want = _run(quantized, 70, 48, 40, seed=4, page_size=page_size,
                     max_pages=-(-110 // page_size))
    tol = TOL_F32 if not quantized else TOL_INT8 if quantized is True else TOL_Q
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
