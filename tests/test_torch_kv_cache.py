"""The port's paged KV cache against the JAX package's, on the CPU.

Cache writes hold the bit-for-bit contract on every payload (int8, fp8
e4m3 and e5m2, int4, unquantized): the same inputs give identical pages
(fp8 compared as raw bytes), scales and lengths (the trash page excepted).
The JAX side runs its XLA scatter specification, as on any non-TPU
backend.  ``quantized`` is False (unquantized), True (int8) or a payload
name of ``_torch_parity.PAYLOADS``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.serving import kv_cache as jkv
from tf_flash_attention_tpu_torch.serving import kv_cache as tkv

from _torch_parity import (KINDS, PAYLOADS, assert_same_cache, cache_cfgs, caches_from,
                           random_state, raw)

QUANTIZED = [False, True, "e4m3", "e5m2", "int4"]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_tokens_bit_identical(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 40, 48)).astype(np.float32) * rng.uniform(0.01, 5, (3, 40, 1))
    x[0, 5] = 0.0                                  # amax == 0 -> scale 1
    x[1, 7, :4] = [63.5, -63.5, 0.5, 1.5]          # exact halves: round to even
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xt = torch.from_numpy(x)
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
    qj, sj = jkv._quantize_tokens(xj)
    qt, st = tkv._quantize_tokens(xt)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("payload", ["e4m3", "e5m2", "int4"])
def test_quantize_payloads_bit_identical(payload, dtype):
    """fp8 round to nearest even from the IEEE quotient x / scale; int4
    rounds half to even and clamps to +-7.  The amax token lands on +-qmax
    (or one rounding of the quotient off it, which the cast takes back)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 64, 40)).astype(np.float32) * rng.uniform(1e-3, 50, (2, 64, 1))
    x[0, 3] = 0.0
    x[1, 9, :3] = [-0.0, 2.5, -3.5]
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xt = torch.from_numpy(x)
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
    jq, tq = PAYLOADS[payload]
    qj, sj = jkv._quantize_tokens(xj, jq)
    qt, st = tkv._quantize_tokens(xt, tq)
    np.testing.assert_array_equal(raw(qj), raw(qt))
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    amax = np.abs(qt.float().numpy()).max(axis=-1)
    np.testing.assert_array_equal(amax[amax > 0], tkv._quant_max(tq))
    if payload == "int4":
        np.testing.assert_array_equal(raw(jkv._pack_nibbles(qj)), raw(tkv._pack_nibbles(qt)))
        even, odd = tkv._unpack_nibbles(tkv._pack_nibbles(qt))
        np.testing.assert_array_equal(even.numpy(), qt[..., 0::2, :].numpy())
        np.testing.assert_array_equal(odd.numpy(), qt[..., 1::2, :].numpy())


# chunk smaller than, equal to and larger than the 64-token page
@pytest.mark.parametrize("quantized", QUANTIZED)
@pytest.mark.parametrize("chunk", [32, 64, 96])
def test_write_tokens_at_matches_jax(quantized, chunk):
    rng = np.random.default_rng(1)
    jcfg, tcfg = cache_cfgs(quantized)
    trash = tcfg.n_pages - 1
    jc, tc = caches_from(random_state(tcfg, rng, [0, 0, 0]), jcfg, tcfg)
    # a prompt of 200 tokens in chunks, the last one padded (true_len < chunk)
    start, total = 0, 200
    while start < total:
        n = min(chunk, total - start)
        k = rng.uniform(-2, 2, (2, chunk, 32)).astype(np.float32)
        v = rng.uniform(-2, 2, (2, chunk, 32)).astype(np.float32)
        jc = jkv.write_tokens_at(jc, jcfg, 1, start, jnp.asarray(k), jnp.asarray(v), n, trash)
        tkv.write_tokens_at(tc, tcfg, 1, start, torch.from_numpy(k), torch.from_numpy(v),
                            n, trash)
        start += n
    assert int(tc.lengths[1]) == total
    assert_same_cache(jc, tc, trash)


# the engine's chunk write: K/V as the projection leaves them, (chunk, n_kv,
# d), transposed to (n_kv, chunk, d) without a copy
@pytest.mark.parametrize("quantized", QUANTIZED)
def test_write_tokens_at_transposed_view_matches_jax(quantized):
    rng = np.random.default_rng(7)
    jcfg, tcfg = cache_cfgs(quantized)
    trash = tcfg.n_pages - 1
    jc, tc = caches_from(random_state(tcfg, rng, [0, 0, 0]), jcfg, tcfg)
    start = 0
    for n in (64, 64, 37):              # the last chunk padded, odd
        k = rng.uniform(-2, 2, (64, 2, 32)).astype(np.float32)
        v = rng.uniform(-2, 2, (64, 2, 32)).astype(np.float32)
        jc = jkv.write_tokens_at(jc, jcfg, 2, start, jnp.asarray(k.transpose(1, 0, 2)),
                                 jnp.asarray(v.transpose(1, 0, 2)), n, trash)
        kt, vt = torch.from_numpy(k).transpose(0, 1), torch.from_numpy(v).transpose(0, 1)
        assert not kt.is_contiguous()
        tkv.write_tokens_at(tc, tcfg, 2, start, kt, vt, n, trash)
        start += n
    assert int(tc.lengths[2]) == start
    assert_same_cache(jc, tc, trash)


# int4: the appends land on both nibbles of a byte row
@pytest.mark.parametrize("quantized", QUANTIZED)
def test_append_tokens_batched_matches_jax(quantized):
    rng = np.random.default_rng(2)
    jcfg, tcfg = cache_cfgs(quantized)
    trash = tcfg.n_pages - 1
    # slot 0 crosses a page boundary during the appends; slot 2 is inactive
    jc, tc = caches_from(random_state(tcfg, rng, [61, 130, 0]), jcfg, tcfg)
    active = np.array([True, True, False])
    for _ in range(6):
        k = rng.uniform(-2, 2, (3, 2, 32)).astype(np.float32)
        v = rng.uniform(-2, 2, (3, 2, 32)).astype(np.float32)
        jc = jkv.append_tokens_batched(jc, jcfg, jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(active), trash)
        tkv.append_tokens_batched(tc, tcfg, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(active), trash)
    np.testing.assert_array_equal(tc.lengths.numpy(), [67, 136, 0])
    assert_same_cache(jc, tc, trash)


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k or "unquantized")
def test_append_token_matches_jax(kind):
    """One token a call for one slot, bit for bit on the cache bytes: slot 0
    starts at an odd offset and crosses a page boundary, slot 1 starts
    even (int4: the even append owns the byte, the odd one keeps it)."""
    rng = np.random.default_rng(7)
    jcfg, tcfg = cache_cfgs(kind)
    jc, tc = caches_from(random_state(tcfg, rng, [61, 130, 0]), jcfg, tcfg)
    for slot in (0, 1, 0, 0, 1, 0, 0, 1):
        k, v = (rng.uniform(-2, 2, (2, 32)).astype(np.float32) for _ in range(2))
        jc = jkv.append_token(jc, jcfg, slot, jnp.asarray(k), jnp.asarray(v))
        assert tkv.append_token(tc, tcfg, slot, torch.from_numpy(k), torch.from_numpy(v)) is tc
    np.testing.assert_array_equal(tc.lengths.numpy(), [66, 133, 0])
    assert_same_cache(jc, tc, tcfg.n_pages)


@pytest.mark.parametrize("quantized", QUANTIZED)
def test_write_prompt_and_gather_match_jax(quantized):
    rng = np.random.default_rng(3)
    jcfg, tcfg = cache_cfgs(quantized)
    jc, tc = jkv.PagedKVCache.create(jcfg), tkv.PagedKVCache.create(tcfg, "cpu")
    k = rng.uniform(-1, 1, (2, 150, 32)).astype(np.float32)
    v = rng.uniform(-1, 1, (2, 150, 32)).astype(np.float32)
    pages = np.array([5, 2, 9])
    jc = jkv.write_prompt(jc, jcfg, 2, pages, jnp.asarray(k), jnp.asarray(v))
    tkv.write_prompt(tc, tcfg, 2, pages, torch.from_numpy(k), torch.from_numpy(v))
    assert_same_cache(jc, tc, tcfg.n_pages - 1)
    jc = jkv.assign_page(jc, 2, 3, 11)
    tkv.assign_page(tc, 2, 3, 11)
    np.testing.assert_array_equal(np.asarray(jc.page_tables), tc.page_tables.numpy())
    for got, want in zip(tkv.gather_sequence_kv(tc, tcfg, 2),
                         jkv.gather_sequence_kv(jc, jcfg, 2)):
        assert got.shape == (2, 150, 32)
        np.testing.assert_array_equal(got, want)


def test_page_allocator_matches_jax():
    ja, ta = jkv.PageAllocator(10), tkv.PageAllocator(10)
    for op, args in [("alloc", (0, 3)), ("alloc", (1, 2)), ("free", (0,)),
                     ("alloc", (2, 4)), ("owned", (2,)), ("free", (1,))]:
        assert getattr(ja, op)(*args) == getattr(ta, op)(*args), op
        assert ja.free_pages == ta.free_pages


@pytest.mark.parametrize("true_len", [37, 40])
def test_int4_odd_lengths_match_jax(true_len):
    """An odd true_len leaves the last byte row's high nibble to the
    padding token; the appends that follow overwrite it nibble by nibble,
    and a byte row goes to the trash page only if both tokens are padding."""
    rng = np.random.default_rng(6)
    jcfg, tcfg = cache_cfgs("int4")
    trash = tcfg.n_pages - 1
    jc, tc = caches_from(random_state(tcfg, rng, [0, 0, 0]), jcfg, tcfg)
    start = 0
    for n in (64, true_len):
        k = rng.uniform(-2, 2, (2, 64, 32)).astype(np.float32)
        v = rng.uniform(-2, 2, (2, 64, 32)).astype(np.float32)
        jc = jkv.write_tokens_at(jc, jcfg, 1, start, jnp.asarray(k), jnp.asarray(v), n, trash)
        tkv.write_tokens_at(tc, tcfg, 1, start, torch.from_numpy(k), torch.from_numpy(v),
                            n, trash)
        start += n
    assert_same_cache(jc, tc, trash)
    active = np.array([False, True, False])
    for _ in range(3):
        k = rng.uniform(-2, 2, (3, 2, 32)).astype(np.float32)
        v = rng.uniform(-2, 2, (3, 2, 32)).astype(np.float32)
        jc = jkv.append_tokens_batched(jc, jcfg, jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(active), trash)
        tkv.append_tokens_batched(tc, tcfg, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(active), trash)
        assert_same_cache(jc, tc, trash)
    for got, want in zip(tkv.gather_sequence_kv(tc, tcfg, 1),
                         jkv.gather_sequence_kv(jc, jcfg, 1)):
        assert got.shape == (2, 64 + true_len + 3, 32)
        np.testing.assert_array_equal(got, want)
    # a prompt of odd length through write_prompt
    jc, tc = jkv.PagedKVCache.create(jcfg), tkv.PagedKVCache.create(tcfg, "cpu")
    k = rng.uniform(-1, 1, (2, 101, 32)).astype(np.float32)
    jc = jkv.write_prompt(jc, jcfg, 0, np.array([4, 7]), jnp.asarray(k), jnp.asarray(-k))
    tkv.write_prompt(tc, tcfg, 0, np.array([4, 7]), torch.from_numpy(k), torch.from_numpy(-k))
    assert_same_cache(jc, tc, trash)


@pytest.mark.parametrize("quantized", QUANTIZED)
def test_cache_layout_matches_jax(quantized):
    jcfg, tcfg = cache_cfgs(quantized)
    jc, tc = jkv.PagedKVCache.create(jcfg), tkv.PagedKVCache.create(tcfg, "cpu")
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(jc, name), getattr(tc, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape), name
            np.testing.assert_array_equal(raw(a), raw(b))
    assert tcfg.tok_pack == jcfg.tok_pack and tcfg.page_rows == jcfg.page_rows


def test_int4_rejects_odd_chunks():
    _, tcfg = cache_cfgs("int4")
    tc = tkv.PagedKVCache.create(tcfg, "cpu")
    k = torch.zeros((2, 33, 32))
    with pytest.raises(ValueError, match="even"):
        tkv.write_tokens_at(tc, tcfg, 0, 0, k, k, 33, tcfg.n_pages - 1)
    with pytest.raises(ValueError, match="even"):
        tkv.write_tokens_at(tc, tcfg, 0, 3, k[:, :32], k[:, :32], 32, tcfg.n_pages - 1)


def test_cache_defaults_to_the_card():
    _, tcfg = cache_cfgs(True)
    if torch.cuda.is_available():
        assert tkv.PagedKVCache.create(tcfg).k_pages.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tkv.PagedKVCache.create(tcfg)


@pytest.mark.parametrize("head_dim,dtype,view,body", [
    (128, torch.bfloat16, "rows", "vector"),
    (256, torch.float32, "rows", "vector"),
    (128, torch.bfloat16, "transposed", "vector"),
    (96, torch.float32, "transposed", "vector"),      # stored at 128: 4 features a lane
    (30, torch.bfloat16, "rows", "scalar"),           # not a multiple of 4 features
    (384, torch.bfloat16, "rows", "scalar"),          # a stored width of no vector body
    (128, torch.bfloat16, "offset", "scalar"),        # rows not aligned to a lane's load
])
def test_kv_write_body_rule(head_dim, dtype, view, body):
    """The body the KV writes' C rule (``kv_vec``) takes for these K/V, as
    ``native.kv_write_body`` names it: the vector body at a stored width of
    128 or 256 when each lane's ``head_dim_store / 32`` features load
    aligned from every source row; else the scalar body."""
    from tf_flash_attention_tpu_torch import native
    cfg = tkv.KVCacheConfig(n_kv_heads=4, head_dim=head_dim, page_size=16, n_pages=9,
                            max_seqs=2, max_pages_per_seq=4)
    if view == "transposed":          # the projection's (chunk, n_kv, d), as the engine passes it
        k = torch.zeros((8, 4, head_dim), dtype=dtype).transpose(0, 1)
    elif view == "offset":            # a 4-byte offset into rows of d + 2
        k = torch.zeros((2, 4, head_dim + 2), dtype=dtype)[..., 2:]
    else:
        k = torch.zeros((2, 4, head_dim), dtype=dtype)
    assert native.kv_write_body(k, k.clone() if view == "rows" else k, cfg) == body
