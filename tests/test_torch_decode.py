"""The port's paged decode attention against the JAX kernel, on the CPU.

The JAX side runs its Pallas decode kernel in interpret mode; the port
runs its plain PyTorch version (its CUDA kernel is checked against that
version on the card by ``chip_smoke.py``).  Single-token decode and
multi-token (speculative verification) decode, on every payload:
``quantized`` is False (unquantized), True (int8) or a payload name.
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
# fp8 and int4 caches: the same bf16 rounding, at outputs up to ~2.5 (the
# random fp8 payloads span the type's range); int4 sums its page as two
# halves in the reference, in token order here
TOL_Q = 2e-3
QUANTIZED = [False, True, "e4m3", "e5m2", "int4"]


def _tol(quantized):
    return TOL_F32 if not quantized else TOL_INT8 if quantized is True else TOL_Q


def _run(quantized, n_q, lengths, rule_pair=(None, None), seed=0, gamma=None,
         page_size=64):
    """gamma None: single-token decode; else multi-token decode of gamma rows."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = cache_cfgs(quantized, max_pages_per_seq=4, page_size=page_size)
    jc, tc = caches_from(random_state(tcfg, rng, lengths), jcfg, tcfg)
    shape = (len(lengths), n_q, 32) if gamma is None else (len(lengths), gamma, n_q, 32)
    q = rng.uniform(-1, 1, shape).astype(np.float32)
    jkw = {} if rule_pair[0] is None else {"rule": rule_pair[0]}
    tkw = {} if rule_pair[1] is None else {"rule": rule_pair[1]}
    jfn, tfn = ((jdec.paged_decode_attention, tdec.paged_decode_attention) if gamma is None
                else (jdec.paged_multitoken_decode, tdec.paged_multitoken_decode))
    want = np.asarray(jfn(q, jc, jcfg, interpret=True, **jkw))
    got = tfn(torch.from_numpy(q), tc, tcfg, **tkw).numpy()
    return got, want


# GQA (4 q / 2 kv heads), lengths off page multiples, one on a page
# boundary, and an empty slot; int4 at an odd length masks the last byte
# row's high nibble by position
@pytest.mark.parametrize("quantized", QUANTIZED)
def test_paged_decode_matches_jax(quantized):
    got, want = _run(quantized, 4, [151, 64, 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(quantized))
    np.testing.assert_array_equal(got[2], 0.0)      # empty slot: exact zeros


# gamma 1 to 4 drafts per slot, GQA 4/2, every payload; lengths count the
# drafts, one slot is empty
@pytest.mark.parametrize("gamma", [1, 2, 3, 4])
@pytest.mark.parametrize("quantized", QUANTIZED)
def test_multitoken_decode_matches_jax(quantized, gamma):
    got, want = _run(quantized, 4, [151, 66, 0], seed=10 + gamma, gamma=gamma)
    assert got.shape == (3, gamma, 4, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(quantized))
    np.testing.assert_array_equal(got[2], 0.0)


@pytest.mark.parametrize("n_q", [2, 8])
def test_multitoken_decode_group_sizes(n_q):
    got, want = _run("int8", n_q, [1 + 3, 255, 97], seed=n_q, gamma=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_INT8)


@pytest.mark.parametrize("quantized", [False, "int4"])
def test_multitoken_gamma_1_is_single_token_decode(quantized):
    rng = np.random.default_rng(7)
    jcfg, tcfg = cache_cfgs(quantized)
    _, tc = caches_from(random_state(tcfg, rng, [150, 3, 0]), jcfg, tcfg)
    q = torch.from_numpy(rng.uniform(-1, 1, (3, 4, 32)).astype(np.float32))
    np.testing.assert_array_equal(
        tdec.paged_multitoken_decode(q[:, None], tc, tcfg)[:, 0].numpy(),
        tdec.paged_decode_attention(q, tc, tcfg).numpy())


@pytest.mark.parametrize("w,s", [(16, 0), (8, 2)])
def test_multitoken_decode_local_rule(w, s):
    # the oldest draft row (at length - gamma) sets the first live page
    rules = (JLocalRule(window_size=w, log2_stride_size=s, is_causal=True),
             LocalRule(window_size=w, log2_stride_size=s, is_causal=True))
    got, want = _run(False, 4, [200, 90, 0], rules, seed=6, gamma=4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_F32)


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
        for gamma in (1, 4):
            want = np.asarray(jdec._first_live_page(jr, lengths, gamma, 64))
            got = tdec._first_live_page(tr, torch.from_numpy(lengths), gamma, 64).numpy()
            np.testing.assert_array_equal(got, want)
        q_pos, kv_pos = np.arange(70)[:, None], np.arange(70)[None, :]
        np.testing.assert_array_equal(
            tdec._rule_visible(tr, torch.from_numpy(q_pos), torch.from_numpy(kv_pos)).numpy(),
            np.asarray(jdec._rule_visible(jr, q_pos, kv_pos)))


def test_cpu_tensors_take_the_plain_version():
    from tf_flash_attention_tpu_torch import native
    before = dict(native.LAUNCHES)
    _run(False, 4, [10, 0, 0])
    _run("int4", 4, [10, 0, 0], gamma=2)
    assert native.LAUNCHES == before


# more than 16 query rows per kv head (GQA 8 at gamma 4, MQA 32/1) and a
# stored width above 256 (head_dim 320 stores 384): the CUDA kernel takes
# them in groups of rows; the plain version and JAX take them whole
@pytest.mark.parametrize("n_q,n_kv,gamma,head_dim,quantized",
                         [(16, 2, 4, 320, True), (32, 1, 1, 384, False), (32, 1, 2, 128, "int4")])
def test_decode_many_rows_and_wide_heads_match_jax(n_q, n_kv, gamma, head_dim, quantized):
    rng = np.random.default_rng(n_q + gamma)
    jcfg, tcfg = cache_cfgs(quantized, n_kv=n_kv, head_dim=head_dim, max_pages_per_seq=4)
    assert tcfg.head_dim_store == -(-head_dim // 128) * 128
    jc, tc = caches_from(random_state(tcfg, rng, [151, 70, 0]), jcfg, tcfg)
    q = rng.uniform(-1, 1, (3, gamma, n_q, head_dim)).astype(np.float32)
    want = np.asarray(jdec.paged_multitoken_decode(q, jc, jcfg, interpret=True))
    got = tdec.paged_multitoken_decode(torch.from_numpy(q), tc, tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(quantized))
    np.testing.assert_array_equal(got[2], 0.0)
