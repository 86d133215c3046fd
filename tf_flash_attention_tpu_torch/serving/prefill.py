"""Paged prefill attention (one prompt chunk of one sequence, causal).

Counterpart of ``paged_prefill_attention`` in the JAX package's
``serving/prefill.py``, on every payload (int8, fp8, int4, unquantized).
On a CUDA tensor it launches the ``paged_prefill`` kernel; on the CPU it
runs ``_paged_prefill_plain``, which keeps the reference kernel's
arithmetic (see ``decode.py``; int4 pages are unpacked into token order,
the reference's even and odd halves under one online softmax).  The
wrapper prescales q by ``scale * LOG2E`` and rounds it back to q's dtype,
as the reference does; that rounding is part of the reference's result.

Sequence sharding (``seq_sharded_decode.py``): ``returning_l_m`` also
returns each row's ``l`` and ``m`` (float32, base-2), and ``page_stride``/
``page_offset`` say that this cache holds every ``page_stride``-th global
page starting at ``page_offset``; key positions are global, the page count
and first live page local.  On a CUDA tensor this launches the same
kernel with those arguments, counted as ``paged_prefill[cp]``.

The per-call scalars reach the kernel as the JAX kernel's scalar prefetch
does, one int32 ``meta`` vector on the device (``prefill_meta``: slot,
local page count, total, start, first live local page, page offset), and
the kernel reads the slot's table row itself, so one CUDA graph of the
engine's chunked prefill serves every chunk; ``slot``, ``start`` and
``true_len`` may be Python ints or 0-d tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..mask_rules import CausalRule, MaskRule
from ..ops.kernel_common import LOG2E, NEG_INF_F32
from .decode import _compute_dtype, _first_live_page, _rule_visible, _softmax_page
from .kv_cache import KVCacheConfig, PagedKVCache, _page_tokens, device_scalar, meta_device

__all__ = ["paged_prefill_attention", "prefill_meta"]


def prefill_meta(cfg: KVCacheConfig, slot, start, true_len, rule: MaskRule = CausalRule(),
                 page_stride: int = 1, device=None) -> torch.Tensor:
    """The prefill's scalars, a row a shard: int32 (page_stride, 6) rows
    ``[slot, count, total, start, first_live, r]`` for the shard of page
    offset r, as the JAX wrapper builds its ``meta`` (prefill.py:241-257):
    ``count`` the local pages of the chunk's sequence (the shard owns global
    pages g with g % page_stride == r), ``first_live`` the first local page
    the rule lets the chunk's first row see.  On ``device`` (the CPU by
    default), by device arithmetic from 0-d tensors (no host sync), or on
    the host from ints (``kv_cache.meta_device``)."""
    device = torch.device("cpu" if device is None else device)
    on = meta_device((slot, start, true_len), device)
    slot, start, true_len = (device_scalar(x, on) for x in (slot, start, true_len))
    total = start + true_len
    offsets = torch.arange(page_stride, dtype=torch.int32, device=on)
    n_global = (total + cfg.page_size - 1) // cfg.page_size
    count = torch.where(n_global > offsets, (n_global - offsets + page_stride - 1) // page_stride,
                        0)
    first = _first_live_page(rule, start + 1, 1, cfg.page_size, page_stride, offsets)
    cols = (slot, count, total, start, first, offsets)
    meta = torch.stack([c.expand(page_stride) for c in cols], dim=1).to(torch.int32)
    return meta.to(device, non_blocking=True)


def _paged_prefill_plain(qs, cache, cfg, meta, rule, returning_l_m=False, page_stride=1):
    """The prefill of ``meta`` (one row of ``prefill_meta``) in plain
    PyTorch (the CPU's path); reads ``meta`` back to the host."""
    slot, count, total, start, first, page_offset = meta.tolist()
    chunk, n_q, d = qs.shape
    n_kv, D, ps, mp = cfg.n_kv_heads, cfg.head_dim_store, cfg.page_size, cfg.max_pages_per_seq
    g = n_q // n_kv
    cdt = _compute_dtype(cache, cfg)
    # (chunk, n_kv, g, d) -> (n_kv, g, chunk, D)
    qg = F.pad(qs.reshape(chunk, n_kv, g, d).permute(1, 2, 0, 3), (0, D - d))
    qg = qg.to(cdt).float()
    q_pos = (start + torch.arange(chunk, device=qs.device))[:, None]
    state = (torch.full((n_kv, g, chunk, 1), NEG_INF_F32, device=qs.device),
             torch.zeros((n_kv, g, chunk, 1), device=qs.device),
             torch.zeros((n_kv, g, chunk, D), device=qs.device))
    table = cache.page_tables[slot].long()
    for lp in range(first, count):
        phys = table[lp % mp]
        kv = []
        for pages, scales in ((cache.k_pages, cache.k_scales), (cache.v_pages, cache.v_scales)):
            x, sc = _page_tokens(pages[:, phys], None if scales is None else scales[:, phys],
                                 cfg)                                   # (n_kv, ps, D), (n_kv, ps)
            kv.append((x.to(cdt).float()[:, None], sc))
        (k, ks), (v, vs) = kv                                           # k, v (n_kv, 1, ps, D)
        s = qg @ k.transpose(-1, -2)                                    # (n_kv, g, chunk, ps)
        if cfg.quantized:
            s = s * ks[:, None, None, :]
            vs = vs[:, None, None, :]
        gp = lp * page_stride + page_offset                             # global page
        kv_pos = gp * ps + torch.arange(ps, device=qs.device)
        vis = (kv_pos < total) & _rule_visible(rule, q_pos, kv_pos)     # (chunk, ps)
        s = s.masked_fill(~vis, NEG_INF_F32)
        state = _softmax_page(state, s, v, vs, cdt)
    m, l, acc = state
    o = acc / torch.where(l == 0.0, torch.ones_like(l), l)

    def rows(x):     # (n_kv, g, chunk, w) -> (chunk, n_q, w)
        return x.permute(2, 0, 1, 3).reshape(chunk, n_q, x.shape[-1])

    o = rows(o[..., :d]).to(qs.dtype)
    return (o, rows(l)[..., 0], rows(m)[..., 0]) if returning_l_m else o


def paged_prefill_attention(q: torch.Tensor, cache: PagedKVCache, cfg: KVCacheConfig, slot,
                            start, true_len, *, scale: Optional[float] = None,
                            rule: MaskRule = CausalRule(), returning_l_m: bool = False,
                            page_stride: int = 1, page_offset: int = 0):
    """Causal attention of a prompt chunk against one sequence's paged cache.
    ``slot``, ``start`` and ``true_len`` are Python ints or 0-d tensors, as
    the JAX entry takes Python or traced scalars (``prefill_meta``).

    ``q``: (chunk, n_q_heads, head_dim), queries at absolute positions
    ``start .. start + chunk``.  The chunk's own K/V must already be in the
    cache (``kv_cache.write_tokens_at``).  Rows past ``true_len`` are
    padding: their output is garbage and the caller slices it off.

    ``returning_l_m``: return ``(o, l, m)``, l and m float32 (chunk,
    n_q_heads), m base-2.  Sequence sharding: this cache holds every
    ``page_stride``-th global page of the sequence from ``page_offset``.
    """
    if not 0 <= page_offset < page_stride:
        raise ValueError(f"page offset {page_offset} outside stride {page_stride}")
    meta = prefill_meta(cfg, slot, start, true_len, rule, page_stride, q.device)
    return prefill_with_meta(q, cache, cfg, meta[page_offset], scale=scale, rule=rule,
                             returning_l_m=returning_l_m, page_stride=page_stride)


def prefill_with_meta(q: torch.Tensor, cache: PagedKVCache, cfg: KVCacheConfig,
                      meta: torch.Tensor, *, scale: Optional[float] = None,
                      rule: MaskRule = CausalRule(), returning_l_m: bool = False,
                      page_stride: int = 1):
    """``paged_prefill_attention`` with its scalars in ``meta``, a row of
    ``prefill_meta`` on q's device (the engine builds the rows once a
    chunk): ``paged_prefill`` on a CUDA tensor, the plain version on the
    CPU."""
    chunk, n_q, d = q.shape
    if n_q % cfg.n_kv_heads:
        raise ValueError(f"q heads {n_q} not a multiple of kv heads {cfg.n_kv_heads}")
    if d != cfg.head_dim:
        raise ValueError(f"q head_dim {d}, cache head_dim {cfg.head_dim}")
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    # Q prescale in float32, rounded back to q's dtype (prefill.py:238); the
    # factor rounded to float32 on the host, as a float32 tensor holds it
    qs = (q.float() * float(np.float32(scale * LOG2E))).to(q.dtype)
    if q.device.type == "cpu":
        return _paged_prefill_plain(qs, cache, cfg, meta, rule, returning_l_m, page_stride)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return native.paged_prefill(qs.contiguous(), cache, cfg, meta, rule, returning_l_m,
                                page_stride)
