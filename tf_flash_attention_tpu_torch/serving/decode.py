"""Paged decode attention (int8/fp8/int4 or unquantized KV, GQA).

Counterpart of ``paged_decode_attention`` (one query token per slot) and
``paged_multitoken_decode`` (``gamma`` draft tokens per slot, speculative
verification) in the JAX package's ``serving/decode.py``.  On a CUDA tensor
they launch the ``paged_decode`` and ``paged_multitoken_decode`` kernels
(``csrc/serving_kernels.cu``); on the CPU they run ``_paged_decode_plain``
and ``_paged_multitoken_decode_plain``, a dense gather over the page table
that keeps the reference kernel's arithmetic: a log2-domain online softmax page by page, K scales folded into
the logits and V scales into the probabilities (post-scaling), and, for a
quantized cache, bf16 rounding of q, K, V and p before the two products
(every int8, fp8 and int4 payload is exact in bf16).  An int4 page holds
token ``2r + nibble`` in byte row ``r``; the plain version unpacks it into
token order, which is the reference's even and odd halves under one
softmax.

Sequence sharding (``seq_sharded_decode.py``): ``returning_l_m`` also
returns each row's online-softmax statistics ``l`` and ``m`` (float32, ``m``
in the kernels' base-2 domain), and ``page_stride``/``page_offset`` with
``global_lengths`` say that this cache holds every ``page_stride``-th global
page starting at ``page_offset``: masking and the window's first page use
global positions, page counts the local lengths.  On a CUDA tensor these
launch the same kernels with those arguments, counted as
``paged_decode[cp]`` and ``paged_multitoken_decode[cp]``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..mask_rules import CausalRule, LocalRule, MaskRule
from ..ops.kernel_common import LOG2E, NEG_INF_F32
from .kv_cache import KVCacheConfig, PagedKVCache, _page_tokens

__all__ = ["paged_decode_attention", "paged_multitoken_decode"]


def _rule_visible(rule, q_pos, kv_pos):
    """May kv_pos feed the query row at q_pos?  Left-to-right ordering is
    always enforced; a ``LocalRule`` adds its strided window."""
    ok = kv_pos <= q_pos
    if isinstance(rule, LocalRule):
        diff = q_pos - kv_pos
        ok = ok & ((diff >> rule.log2_stride_size) < rule.window_size)
        if rule.log2_stride_size:
            ok = ok & ((diff & rule.remainder_mask) == 0)
    return ok


def _first_live_page(rule, lengths, gamma, page_size, stride=1, offset=0):
    """Per-slot LOCAL index of the first page the rule can see: a
    LocalRule's oldest query row (at GLOBAL position ``length - gamma``)
    sees nothing below ``oldest - (strided_window - 1)``.  With sequence
    sharding local page j holds global page ``j * stride + offset``, so the
    first live local page is the count of local pages below the global
    first live page."""
    if isinstance(rule, LocalRule):
        lo = torch.clamp(lengths - gamma - (rule.strided_window_size - 1), min=0)
        gfp = lo // page_size
        if stride == 1:
            return gfp
        return torch.where(gfp > offset, (gfp - offset + stride - 1) // stride,
                           torch.zeros_like(gfp))
    return torch.zeros_like(lengths)


def _compute_dtype(cache: PagedKVCache, cfg: KVCacheConfig) -> torch.dtype:
    # the JAX kernels cast quantized pages to bf16 and q to the pages' dtype
    return torch.bfloat16 if cfg.quantized else cache.k_pages.dtype


def _softmax_page(state, s, v, vs, cdt, live=None):
    """One page of the log2-domain online softmax: ``s`` (..., rows, page)
    logits, ``v`` (..., page, d) values, ``vs`` (..., 1, page) V scales or
    None.  ``state`` = (m, l, acc); rows where ``live`` is False keep it."""
    m, l, acc = state
    m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp2(m - m_next)
    # a row with no visible key yet has m_next == NEG_INF; zero it
    row_live = m_next > NEG_INF_F32 * 0.5
    pw = torch.where(row_live, torch.exp2(s - m_next), torch.zeros_like(s))
    l_add = pw.sum(dim=-1, keepdim=True)
    if vs is not None:
        pw = pw * vs
    pv = pw.to(cdt).float() @ v
    m_new, l_new, acc_new = m_next, alpha * l + l_add, acc * alpha + pv
    if live is not None:
        m_new = torch.where(live, m_new, m)
        l_new = torch.where(live, l_new, l)
        acc_new = torch.where(live, acc_new, acc)
    return m_new, l_new, acc_new


def _paged_multitoken_decode_plain(q, cache, cfg, scale, rule, returning_l_m=False,
                                   page_stride=1, page_offset=0, global_lengths=None):
    """q (S, gamma, n_q, d): row (i, head) of slot s sits at GLOBAL position
    ``global_length - gamma + i`` and sees keys up to and including itself;
    local page j holds global page ``j * page_stride + page_offset``.
    Returns o, or with ``returning_l_m`` (o, l, m), l and m float32 (S,
    gamma, n_q)."""
    S, gamma, n_q, d = q.shape
    n_kv, D, ps, mp = cfg.n_kv_heads, cfg.head_dim_store, cfg.page_size, cfg.max_pages_per_seq
    g = n_q // n_kv
    rows = g * gamma
    cdt = _compute_dtype(cache, cfg)
    # gamma-minor rows, as the reference: row r = head_in_group * gamma + draft
    qg = q.reshape(S, gamma, n_kv, g, d).permute(0, 2, 3, 1, 4).reshape(S, n_kv, rows, d)
    qg = F.pad(qg, (0, D - d)).to(cdt).float()
    lengths = cache.lengths.long()
    glob = lengths if global_lengths is None else global_lengths.long()
    counts = (lengths + ps - 1) // ps
    starts = _first_live_page(rule, glob, gamma, ps, page_stride, page_offset)
    q_pos = (glob - gamma)[:, None] + torch.arange(rows, device=q.device) % gamma
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    state = (torch.full((S, n_kv, rows, 1), NEG_INF_F32, device=q.device),
             torch.zeros((S, n_kv, rows, 1), device=q.device),
             torch.zeros((S, n_kv, rows, D), device=q.device))
    n_steps = int((counts - starts).max()) if S else 0
    for p in range(n_steps):
        lp = starts + p
        live = (lp < counts)[:, None, None, None]
        lpc = torch.clamp(torch.minimum(lp, counts - 1), min=0)
        phys = cache.page_tables.long().gather(1, (lpc % mp)[:, None])[:, 0]
        kv = []
        for pages, scales in ((cache.k_pages, cache.k_scales), (cache.v_pages, cache.v_scales)):
            x, sc = _page_tokens(pages[:, phys].transpose(0, 1),
                                 None if scales is None else scales[:, phys].transpose(0, 1),
                                 cfg)                          # (S, n_kv, ps, D), (S, n_kv, ps)
            kv.append((x.to(cdt).float(), sc))
        (k, ks), (v, vs) = kv
        s = qg @ k.transpose(-1, -2)                           # (S, n_kv, rows, ps)
        if cfg.quantized:
            s = s * (ks[:, :, None, :] * c)
            vs = vs[:, :, None, :]
        else:
            s = s * c
        gp = lp * page_stride + page_offset                  # global page
        kv_pos = gp[:, None] * ps + torch.arange(ps, device=q.device)
        vis = _rule_visible(rule, q_pos[:, :, None], kv_pos[:, None, :])[:, None]
        s = s.masked_fill(~vis, NEG_INF_F32)
        state = _softmax_page(state, s, v, vs, cdt, live)
    m, l, acc = state
    o = acc / torch.where(l == 0.0, torch.ones_like(l), l)

    def split(x):     # (S, n_kv, rows, w) -> (S, gamma, n_q, w)
        w = x.shape[-1]
        return x.reshape(S, n_kv, g, gamma, w).permute(0, 3, 1, 2, 4).reshape(S, gamma, n_q, w)

    o = split(o[..., :d]).to(q.dtype)
    return (o, split(l)[..., 0], split(m)[..., 0]) if returning_l_m else o


def _paged_decode_plain(q, cache, cfg, scale, rule, returning_l_m=False, page_stride=1,
                        page_offset=0, global_lengths=None):
    """q (S, n_q, d): gamma 1 of the multi-token version."""
    out = _paged_multitoken_decode_plain(q[:, None], cache, cfg, scale, rule, True,
                                         page_stride, page_offset, global_lengths)
    o, l, m = (x[:, 0] for x in out)
    return (o, l, m) if returning_l_m else o


def _check(q_heads: int, d: int, cfg: KVCacheConfig) -> None:
    if q_heads % cfg.n_kv_heads:
        raise ValueError(f"q heads {q_heads} not a multiple of kv heads {cfg.n_kv_heads}")
    if d != cfg.head_dim:
        raise ValueError(f"q head_dim {d}, cache head_dim {cfg.head_dim}")


def _check_shard(q, page_stride, page_offset, global_lengths):
    if not 0 <= page_offset < page_stride:
        raise ValueError(f"page offset {page_offset} outside stride {page_stride}")
    if global_lengths is not None and (global_lengths.shape != (q.shape[0],)
                                       or global_lengths.device != q.device):
        raise ValueError(f"global_lengths {tuple(global_lengths.shape)} on "
                         f"{global_lengths.device}, q on {q.device}")


def paged_decode_attention(q: torch.Tensor, cache: PagedKVCache,
                           cfg: KVCacheConfig, *, scale: Optional[float] = None,
                           rule: MaskRule = CausalRule(), returning_l_m: bool = False,
                           page_stride: int = 1, page_offset: int = 0,
                           global_lengths: Optional[torch.Tensor] = None):
    """One decode step of attention against the paged cache.

    ``q``: (max_seqs, n_q_heads, head_dim), the current token's queries;
    ``cache.lengths`` already counts that token.  Returns ``o`` of the same
    shape and dtype; a slot of length 0 gives exact zeros.

    ``returning_l_m``: return ``(o, l, m)``, l and m float32 (max_seqs,
    n_q_heads), m base-2, for an exact merge of partials over disjoint KV
    shards.  Sequence sharding: this cache holds every ``page_stride``-th
    global page from ``page_offset``; ``global_lengths`` (max_seqs,) int32
    gives the sequences' global lengths for masking and window skipping.
    A slot with no local page gives o = 0, l = 0 and m = NEG_INF.
    """
    S, n_q, d = q.shape
    _check(n_q, d, cfg)
    _check_shard(q, page_stride, page_offset, global_lengths)
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    if q.device.type == "cpu":
        return _paged_decode_plain(q, cache, cfg, scale, rule, returning_l_m, page_stride,
                                   page_offset, global_lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return native.paged_decode(q.contiguous(), cache, cfg, scale * LOG2E, rule, returning_l_m,
                               page_stride, page_offset, global_lengths)


def paged_multitoken_decode(q: torch.Tensor, cache: PagedKVCache,
                            cfg: KVCacheConfig, *, scale: Optional[float] = None,
                            rule: MaskRule = CausalRule(), returning_l_m: bool = False,
                            page_stride: int = 1, page_offset: int = 0,
                            global_lengths: Optional[torch.Tensor] = None):
    """Speculative verification attention: ``gamma`` tokens per slot.

    ``q``: (max_seqs, gamma, n_q_heads, head_dim), the queries of the
    tokens at positions ``length - gamma .. length - 1`` of each slot,
    whose K/V are already appended (``cache.lengths`` counts them).  Draft
    ``i`` sees keys up to and including its own position, under the rule.
    Returns (max_seqs, gamma, n_q_heads, head_dim); gamma 1 is
    ``paged_decode_attention``, whose sharding arguments it takes (l and m
    then (max_seqs, gamma, n_q_heads)).
    """
    S, gamma, n_q, d = q.shape
    _check(n_q, d, cfg)
    _check_shard(q, page_stride, page_offset, global_lengths)
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    if q.device.type == "cpu":
        return _paged_multitoken_decode_plain(q, cache, cfg, scale, rule, returning_l_m,
                                              page_stride, page_offset, global_lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return native.paged_multitoken_decode(q.contiguous(), cache, cfg, scale * LOG2E, rule,
                                          returning_l_m, page_stride, page_offset,
                                          global_lengths)
