"""Paged prefill attention (one prompt chunk of one sequence, causal).

Counterpart of ``paged_prefill_attention`` in the JAX package's
``serving/prefill.py``.  On a CUDA tensor it launches the
``paged_prefill`` kernel; on the CPU it runs ``_paged_prefill_plain``,
which keeps the reference kernel's arithmetic (see ``decode.py``).  The
wrapper prescales q by ``scale * LOG2E`` and rounds it back to q's dtype,
as the reference does; that rounding is part of the reference's result.

Not ported yet (ROADMAP queue 2): the ``(l, m)`` outputs and sequence
sharding.
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
from .kv_cache import KVCacheConfig, PagedKVCache

__all__ = ["paged_prefill_attention"]


def _paged_prefill_plain(qs, cache, cfg, slot, start, true_len, rule):
    chunk, n_q, d = qs.shape
    n_kv, D, ps, mp = cfg.n_kv_heads, cfg.head_dim_store, cfg.page_size, cfg.max_pages_per_seq
    g = n_q // n_kv
    cdt = _compute_dtype(cache, cfg)
    # (chunk, n_kv, g, d) -> (n_kv, g, chunk, D)
    qg = F.pad(qs.reshape(chunk, n_kv, g, d).permute(1, 2, 0, 3), (0, D - d))
    qg = qg.to(cdt).float()
    total = start + true_len
    count = -(-total // ps)
    first = int(_first_live_page(rule, torch.tensor(start + 1), 1, ps))
    q_pos = (start + torch.arange(chunk, device=qs.device))[:, None]
    state = (torch.full((n_kv, g, chunk, 1), NEG_INF_F32, device=qs.device),
             torch.zeros((n_kv, g, chunk, 1), device=qs.device),
             torch.zeros((n_kv, g, chunk, D), device=qs.device))
    table = cache.page_tables[slot].long()
    for lp in range(first, count):
        phys = table[lp % mp]
        k = cache.k_pages[:, phys].to(cdt).float()[:, None]            # (n_kv, 1, ps, D)
        v = cache.v_pages[:, phys].to(cdt).float()[:, None]
        s = qg @ k.transpose(-1, -2)                                    # (n_kv, g, chunk, ps)
        vs = None
        if cfg.quantized:
            s = s * cache.k_scales[:, phys, 0][:, None, None, :]
            vs = cache.v_scales[:, phys, 0][:, None, None, :]
        kv_pos = lp * ps + torch.arange(ps, device=qs.device)
        vis = (kv_pos < total) & _rule_visible(rule, q_pos, kv_pos)     # (chunk, ps)
        s = s.masked_fill(~vis, NEG_INF_F32)
        state = _softmax_page(state, s, v, vs, cdt)
    _, l, acc = state
    o = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return o[..., :d].permute(2, 0, 1, 3).reshape(chunk, n_q, d).to(qs.dtype)


def paged_prefill_attention(q: torch.Tensor, cache: PagedKVCache,
                            cfg: KVCacheConfig, slot: int, start: int,
                            true_len: int, *, scale: Optional[float] = None,
                            rule: MaskRule = CausalRule()) -> torch.Tensor:
    """Causal attention of a prompt chunk against one sequence's paged cache.

    ``q``: (chunk, n_q_heads, head_dim), queries at absolute positions
    ``start .. start + chunk``.  The chunk's own K/V must already be in the
    cache (``kv_cache.write_tokens_at``).  Rows past ``true_len`` are
    padding: their output is garbage and the caller slices it off.
    """
    chunk, n_q, d = q.shape
    if n_q % cfg.n_kv_heads:
        raise ValueError(f"q heads {n_q} not a multiple of kv heads {cfg.n_kv_heads}")
    if d != cfg.head_dim:
        raise ValueError(f"q head_dim {d}, cache head_dim {cfg.head_dim}")
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    # Q prescale in float32, rounded back to q's dtype (prefill.py:238)
    qs = (q.float() * torch.tensor(scale * LOG2E, dtype=torch.float32)).to(q.dtype)
    if q.device.type == "cpu":
        return _paged_prefill_plain(qs, cache, cfg, slot, start, true_len, rule)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    total = start + true_len
    first = int(_first_live_page(rule, torch.tensor(start + 1), 1, cfg.page_size))
    o = native.paged_prefill(qs.contiguous(), cache, cfg, slot, start, total,
                             first, -(-total // cfg.page_size), rule)
    return o
