"""Paged decode attention (one query token per slot, int8 or unquantized KV, GQA).

Counterpart of ``paged_decode_attention`` in the JAX package's
``serving/decode.py`` at gamma = 1.  On a CUDA tensor it launches the
``paged_decode`` kernel (``csrc/serving_kernels.cu``); on the CPU it runs
``_paged_decode_plain``, a dense gather over the page table that keeps the
reference kernel's arithmetic: a log2-domain online softmax page by page,
K scales folded into the logits and V scales into the probabilities
(post-scaling), and, for an int8 cache, bf16 rounding of q, K, V and p
before the two products.

Not ported yet (ROADMAP queue 2): gamma > 1 (``paged_multitoken_decode``),
the ``(l, m)`` outputs and sequence sharding.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..mask_rules import CausalRule, LocalRule, MaskRule
from ..ops.kernel_common import LOG2E, NEG_INF_F32
from .kv_cache import KVCacheConfig, PagedKVCache

__all__ = ["paged_decode_attention"]


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


def _first_live_page(rule, lengths, gamma, page_size):
    """Per-slot index of the first page the rule can see: a LocalRule's
    oldest query row (at ``length - gamma``) sees nothing below
    ``oldest - (strided_window - 1)``."""
    if isinstance(rule, LocalRule):
        lo = torch.clamp(lengths - gamma - (rule.strided_window_size - 1), min=0)
        return lo // page_size
    return torch.zeros_like(lengths)


def _compute_dtype(cache: PagedKVCache, cfg: KVCacheConfig) -> torch.dtype:
    # the JAX kernels cast int8 pages to bf16 and q to the pages' dtype
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


def _paged_decode_plain(q, cache, cfg, scale, rule):
    S, n_q, d = q.shape
    n_kv, D, ps, mp = cfg.n_kv_heads, cfg.head_dim_store, cfg.page_size, cfg.max_pages_per_seq
    g = n_q // n_kv
    cdt = _compute_dtype(cache, cfg)
    qg = F.pad(q.reshape(S, n_kv, g, d), (0, D - d)).to(cdt).float()
    lengths = cache.lengths.long()
    counts = (lengths + ps - 1) // ps
    starts = _first_live_page(rule, lengths, 1, ps)
    q_pos = (lengths - 1)[:, None]
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    state = (torch.full((S, n_kv, g, 1), NEG_INF_F32, device=q.device),
             torch.zeros((S, n_kv, g, 1), device=q.device),
             torch.zeros((S, n_kv, g, D), device=q.device))
    n_steps = int((counts - starts).max()) if S else 0
    for p in range(n_steps):
        lp = starts + p
        live = (lp < counts)[:, None, None, None]
        lpc = torch.clamp(torch.minimum(lp, counts - 1), min=0)
        phys = cache.page_tables.long().gather(1, (lpc % mp)[:, None])[:, 0]
        k = cache.k_pages[:, phys].transpose(0, 1).to(cdt).float()   # (S, n_kv, ps, D)
        v = cache.v_pages[:, phys].transpose(0, 1).to(cdt).float()
        s = qg @ k.transpose(-1, -2)                                   # (S, n_kv, g, ps)
        if cfg.quantized:
            ks = cache.k_scales[:, phys, 0].transpose(0, 1)[:, :, None, :]
            vs = cache.v_scales[:, phys, 0].transpose(0, 1)[:, :, None, :]
            s = s * (ks * c)
        else:
            vs = None
            s = s * c
        kv_pos = lp[:, None] * ps + torch.arange(ps, device=q.device)
        vis = _rule_visible(rule, q_pos, kv_pos)[:, None, None, :]
        s = s.masked_fill(~vis, NEG_INF_F32)
        state = _softmax_page(state, s, v, vs, cdt, live)
    _, l, acc = state
    o = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return o[..., :d].reshape(S, n_q, d).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, cache: PagedKVCache,
                           cfg: KVCacheConfig, *, scale: Optional[float] = None,
                           rule: MaskRule = CausalRule()) -> torch.Tensor:
    """One decode step of attention against the paged cache.

    ``q``: (max_seqs, n_q_heads, head_dim), the current token's queries;
    ``cache.lengths`` already counts that token.  Returns ``o`` of the same
    shape and dtype; a slot of length 0 gives exact zeros.
    """
    S, n_q, d = q.shape
    if n_q % cfg.n_kv_heads:
        raise ValueError(f"q heads {n_q} not a multiple of kv heads {cfg.n_kv_heads}")
    if d != cfg.head_dim:
        raise ValueError(f"q head_dim {d}, cache head_dim {cfg.head_dim}")
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    if q.device.type == "cpu":
        return _paged_decode_plain(q, cache, cfg, scale, rule)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    o = native.paged_decode(q.contiguous(), cache, cfg, scale * LOG2E, rule)
    return o
