"""Shared set-up for the PyTorch port's parity tests (``test_torch_*.py``).

One numpy state of a paged KV cache is loaded into both packages'
caches, so a JAX function and its port see the same inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from tf_flash_attention_tpu.serving import kv_cache as jkv
from tf_flash_attention_tpu_torch.serving import kv_cache as tkv

_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def cache_cfgs(quantized, n_kv=2, head_dim=32, page_size=64, n_pages=16,
               max_seqs=3, max_pages_per_seq=4, dtype=jnp.float32):
    """Matching (JAX, port) KVCacheConfigs."""
    kw = dict(n_kv_heads=n_kv, head_dim=head_dim, page_size=page_size,
              n_pages=n_pages, max_seqs=max_seqs,
              max_pages_per_seq=max_pages_per_seq, quantized=quantized)
    return (jkv.KVCacheConfig(**kw, dtype=dtype),
            tkv.KVCacheConfig(**kw, dtype=_TORCH_DTYPE[dtype]))


def random_state(tcfg, rng, lengths):
    """Random cache contents; slot s maps pages s*mp .. s*mp+mp-1 shuffled."""
    shape = (tcfg.n_kv_heads, tcfg.n_pages, tcfg.page_size, tcfg.head_dim_store)
    state = {}
    for name in ("k", "v"):
        if tcfg.quantized:
            state[name + "_pages"] = rng.integers(-127, 128, shape).astype(np.int8)
            state[name + "_scales"] = rng.uniform(
                0.005, 0.02, (tcfg.n_kv_heads, tcfg.n_pages, 1, tcfg.page_size)
            ).astype(np.float32)
        else:
            pages = rng.uniform(-1, 1, shape).astype(np.float32)
            pages[..., tcfg.head_dim:] = 0.0   # the padded feature lanes
            state[name + "_pages"] = pages
            state[name + "_scales"] = None
    S, mp = tcfg.max_seqs, tcfg.max_pages_per_seq
    perm = rng.permutation(tcfg.n_pages - 1)[:S * mp]
    state["page_tables"] = perm.reshape(S, mp).astype(np.int32)
    state["lengths"] = np.asarray(lengths, np.int32)
    return state


def caches_from(state, jcfg, tcfg):
    """(JAX cache, port cache) holding ``state``."""
    j = jkv.PagedKVCache(**{k: None if v is None else jnp.asarray(v)
                            for k, v in state.items()})
    if not jcfg.quantized:
        j = dataclasses.replace(j, k_pages=j.k_pages.astype(jcfg.dtype),
                                v_pages=j.v_pages.astype(jcfg.dtype))
    t = tkv.PagedKVCache(**{k: None if v is None else torch.from_numpy(v.copy())
                            for k, v in state.items()})
    if not tcfg.quantized:
        t.k_pages = t.k_pages.to(tcfg.dtype)
        t.v_pages = t.v_pages.to(tcfg.dtype)
    return j, t


def assert_same_cache(jc, tc, trash_page):
    """Identical payloads, scales, tables and lengths; the trash page, which
    several writers may hit at once, is left out."""
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(jc, name), getattr(tc, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a = np.asarray(a.astype(jnp.float32))[:, :trash_page]
        b = b.float().numpy()[:, :trash_page]
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(np.asarray(jc.page_tables), tc.page_tables.numpy())
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
