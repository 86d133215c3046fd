"""The port's paged KV cache against the JAX package's, on the CPU.

Cache writes hold the bit-for-bit contract: the same inputs give identical
pages, scales and lengths (the trash page excepted).  The JAX side runs
its XLA scatter specification, as on any non-TPU backend.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_flash_attention_tpu.serving import kv_cache as jkv
from tf_flash_attention_tpu_torch.serving import kv_cache as tkv

from _torch_parity import assert_same_cache, cache_cfgs, caches_from, random_state


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


# chunk smaller than, equal to and larger than the 64-token page
@pytest.mark.parametrize("quantized", [False, True])
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


@pytest.mark.parametrize("quantized", [False, True])
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


@pytest.mark.parametrize("quantized", [False, True])
def test_write_prompt_and_gather_match_jax(quantized):
    rng = np.random.default_rng(3)
    jcfg, tcfg = cache_cfgs(quantized)
    jc, tc = jkv.PagedKVCache.create(jcfg), tkv.PagedKVCache.create(tcfg)
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


@pytest.mark.parametrize("qdtype", ["int4", torch.float8_e4m3fn])
def test_unported_payloads_raise(qdtype):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tkv.KVCacheConfig(n_kv_heads=2, head_dim=32, quant_dtype=qdtype)
