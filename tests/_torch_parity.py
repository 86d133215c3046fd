"""Shared set-up for the PyTorch port's parity tests (``test_torch_*.py``).

One numpy state of a paged KV cache is loaded into both packages'
caches, so a JAX function and its port see the same inputs.  numpy has no
fp8 type of its own: fp8 payloads travel as raw bytes (``uint8``) and are
viewed as fp8 on each side.
"""

import dataclasses
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tf_flash_attention_tpu.serving import kv_cache as jkv
from tf_flash_attention_tpu_torch.serving import kv_cache as tkv

_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

#: quantized payloads by name: (JAX quant_dtype, port quant_dtype)
PAYLOADS = {"int8": (jnp.int8, torch.int8),
            "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
            "e5m2": (jnp.float8_e5m2, torch.float8_e5m2),
            "int4": ("int4", "int4")}
#: every cache kind: None is unquantized (the model dtype)
KINDS = [None, "int8", "e4m3", "e5m2", "int4"]


#: aten ops that read a device value on the host or make a tensor from host
#: data: what a CUDA graph's capture refuses
FORBIDDEN = {"aten._local_scalar_dense", "aten.item", "aten.nonzero", "aten.lift_fresh",
             "aten.lift_fresh_copy"}


class _OpLog(TorchDispatchMode):
    """Every aten op dispatched under it, by packet name."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module's port computations, restored after
    it: they are many small CPU ops, and a thread pool per test worker
    oversubscribes the cores (a module imports this fixture as autouse)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payload(kind):
    """True means int8, as in the tests written before fp8 and int4."""
    return "int8" if kind is True else (kind or None)


def cache_cfgs(kind, n_kv=2, head_dim=32, page_size=64, n_pages=16,
               max_seqs=3, max_pages_per_seq=4, dtype=jnp.float32):
    """Matching (JAX, port) KVCacheConfigs; ``kind`` is a ``PAYLOADS`` name,
    True (int8), or None/False (unquantized)."""
    kind = _payload(kind)
    kw = dict(n_kv_heads=n_kv, head_dim=head_dim, page_size=page_size,
              n_pages=n_pages, max_seqs=max_seqs,
              max_pages_per_seq=max_pages_per_seq, quantized=kind is not None)
    jq, tq = PAYLOADS[kind] if kind else (jnp.int8, torch.int8)
    return (jkv.KVCacheConfig(**kw, quant_dtype=jq, dtype=dtype),
            tkv.KVCacheConfig(**kw, quant_dtype=tq, dtype=_TORCH_DTYPE[dtype]))


def _fp8_bytes(tdtype, rng, shape):
    """Random fp8 payload bytes: values across the type's range, no NaN."""
    qmax = tkv._quant_max(tdtype)
    x = rng.uniform(-1, 1, shape).astype(np.float32) ** 3 * qmax
    return torch.from_numpy(x).to(tdtype).view(torch.uint8).numpy()


def random_state(tcfg, rng, lengths):
    """Random cache contents; slot s maps pages s*mp .. s*mp+mp-1 shuffled."""
    shape = (tcfg.n_kv_heads, tcfg.n_pages, tcfg.page_rows, tcfg.head_dim_store)
    state = {}
    for name in ("k", "v"):
        if tcfg.is_int4:
            state[name + "_pages"] = rng.integers(-128, 128, shape).astype(np.int8)
        elif tcfg.quantized and tcfg.quant_dtype == torch.int8:
            state[name + "_pages"] = rng.integers(-127, 128, shape).astype(np.int8)
        elif tcfg.quantized:
            state[name + "_pages"] = _fp8_bytes(tcfg.quant_dtype, rng, shape)
        else:
            pages = rng.uniform(-1, 1, shape).astype(np.float32)
            pages[..., tcfg.head_dim:] = 0.0   # the padded feature lanes
            state[name + "_pages"] = pages
        state[name + "_scales"] = rng.uniform(
            0.005, 0.02, (tcfg.n_kv_heads, tcfg.n_pages, tcfg.tok_pack, tcfg.page_rows)
        ).astype(np.float32) if tcfg.quantized else None
        if tcfg.quantized and tcfg.quant_dtype != torch.int8 and not tcfg.is_int4:
            # fp8 payloads of up to 448 / 57344 carry scales near 1 / qmax
            state[name + "_scales"] *= 127.0 / tkv._quant_max(tcfg.quant_dtype)
    S, mp = tcfg.max_seqs, tcfg.max_pages_per_seq
    perm = rng.permutation(tcfg.n_pages - 1)[:S * mp]
    state["page_tables"] = perm.reshape(S, mp).astype(np.int32)
    state["lengths"] = np.asarray(lengths, np.int32)
    return state


def caches_from(state, jcfg, tcfg):
    """(JAX cache, port cache) holding ``state``."""
    j = jkv.PagedKVCache(**{k: None if v is None else jnp.asarray(v)
                            for k, v in state.items()})
    t = tkv.PagedKVCache(**{k: None if v is None else torch.from_numpy(v.copy())
                            for k, v in state.items()})
    if not jcfg.quantized:
        j = dataclasses.replace(j, k_pages=j.k_pages.astype(jcfg.dtype),
                                v_pages=j.v_pages.astype(jcfg.dtype))
        t.k_pages = t.k_pages.to(tcfg.dtype)
        t.v_pages = t.v_pages.to(tcfg.dtype)
    elif tcfg.payload_dtype not in (torch.int8,):
        j = dataclasses.replace(
            j, k_pages=jnp.asarray(state["k_pages"].view(jcfg.quant_dtype)),
            v_pages=jnp.asarray(state["v_pages"].view(jcfg.quant_dtype)))
        t.k_pages = t.k_pages.view(tcfg.quant_dtype)
        t.v_pages = t.v_pages.view(tcfg.quant_dtype)
    return j, t


def raw(x):
    """A cache tensor of either package as numpy, one-byte payloads as their
    raw bytes (fp8 bit patterns compare exactly, -0 and all)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy() if x.element_size() == 1 else x.float().numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 else x.astype(np.float32)


def assert_same_cache(jc, tc, trash_page):
    """Identical payloads, scales, tables and lengths; the trash page, which
    several writers may hit at once, is left out."""
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        a, b = getattr(jc, name), getattr(tc, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        np.testing.assert_array_equal(raw(a)[:, :trash_page], raw(b)[:, :trash_page],
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(jc.page_tables), tc.page_tables.numpy())
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
