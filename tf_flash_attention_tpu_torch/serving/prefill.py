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
from .kv_cache import KVCacheConfig, PagedKVCache, _page_tokens

__all__ = ["paged_prefill_attention"]


def _page_range(cfg, start, true_len, rule, page_stride, page_offset):
    """(first live local page, local page count) of the chunk's sequence,
    as the JAX wrapper computes them (prefill.py:241-253): the shard owns
    global pages g with g % page_stride == page_offset."""
    n_global = -(-(start + true_len) // cfg.page_size)
    count = ((n_global - page_offset + page_stride - 1) // page_stride
             if n_global > page_offset else 0)
    first = int(_first_live_page(rule, torch.tensor(start + 1), 1, cfg.page_size, page_stride,
                                 page_offset))
    return first, count


def _paged_prefill_plain(qs, cache, cfg, slot, start, true_len, rule, returning_l_m=False,
                         page_stride=1, page_offset=0):
    chunk, n_q, d = qs.shape
    n_kv, D, ps, mp = cfg.n_kv_heads, cfg.head_dim_store, cfg.page_size, cfg.max_pages_per_seq
    g = n_q // n_kv
    cdt = _compute_dtype(cache, cfg)
    # (chunk, n_kv, g, d) -> (n_kv, g, chunk, D)
    qg = F.pad(qs.reshape(chunk, n_kv, g, d).permute(1, 2, 0, 3), (0, D - d))
    qg = qg.to(cdt).float()
    total = start + true_len
    first, count = _page_range(cfg, start, true_len, rule, page_stride, page_offset)
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


def paged_prefill_attention(q: torch.Tensor, cache: PagedKVCache,
                            cfg: KVCacheConfig, slot: int, start: int,
                            true_len: int, *, scale: Optional[float] = None,
                            rule: MaskRule = CausalRule(), returning_l_m: bool = False,
                            page_stride: int = 1, page_offset: int = 0):
    """Causal attention of a prompt chunk against one sequence's paged cache.

    ``q``: (chunk, n_q_heads, head_dim), queries at absolute positions
    ``start .. start + chunk``.  The chunk's own K/V must already be in the
    cache (``kv_cache.write_tokens_at``).  Rows past ``true_len`` are
    padding: their output is garbage and the caller slices it off.

    ``returning_l_m``: return ``(o, l, m)``, l and m float32 (chunk,
    n_q_heads), m base-2.  Sequence sharding: this cache holds every
    ``page_stride``-th global page of the sequence from ``page_offset``.
    """
    chunk, n_q, d = q.shape
    if n_q % cfg.n_kv_heads:
        raise ValueError(f"q heads {n_q} not a multiple of kv heads {cfg.n_kv_heads}")
    if d != cfg.head_dim:
        raise ValueError(f"q head_dim {d}, cache head_dim {cfg.head_dim}")
    if not 0 <= page_offset < page_stride:
        raise ValueError(f"page offset {page_offset} outside stride {page_stride}")
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    # Q prescale in float32, rounded back to q's dtype (prefill.py:238)
    qs = (q.float() * torch.tensor(scale * LOG2E, dtype=torch.float32)).to(q.dtype)
    if q.device.type == "cpu":
        return _paged_prefill_plain(qs, cache, cfg, slot, start, true_len, rule, returning_l_m,
                                    page_stride, page_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    first, count = _page_range(cfg, start, true_len, rule, page_stride, page_offset)
    return native.paged_prefill(qs.contiguous(), cache, cfg, slot, start, start + true_len,
                                first, count, rule, returning_l_m, page_stride, page_offset)
