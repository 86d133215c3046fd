"""Flash-structured attention in plain PyTorch with O(block) memory (port of
``ops/chunked.py``).

The float64 path.  The CUDA reference compiles real float64 kernels; the
JAX package runs float64 through this recurrence in plain XLA, because
the TPU has no float64 matrix unit, and so does the port: the same online
softmax as the kernels, over the live tiles of the block-skip schedule
(``schedule.py``, the NumPy classifier), with each tile's products as
``torch.matmul`` (cuBLAS DGEMM on the card).  No score tensor of
``q_len x k_len`` is ever built.

The JAX path is ``lax.scan`` over kv steps inside ``lax.map`` over q
blocks.  ``lax.map`` is sequential, but no q block depends on another, so
the port runs a group of q blocks at once in each kv step: step ``s``
gathers kv block ``kv_table[qi, s]`` for every q block ``qi`` of the group.
A group holds at most ``_GROUP_ELEMS`` score elements, so a call launches
O(kv steps x groups) kernels, not O(q blocks x kv steps), and its live
memory stays O(block) beside the operands.

Gradients come from a ``torch.autograd.Function`` that mirrors the JAX
``custom_vjp``: a dQ pass over the forward table and a dK/dV pass over the
transposed table, both recomputing P from ``(Q, K, l, m)``; the loop is
never differentiated through.

Numeric contract (the dense oracle's and the kernels'): logits scaled by
``scale`` after the product in the compute dtype, masked logits at the
finite ``neg_inf_approx``, a fully masked row gives ``o = 0, l = 0,
m = neg_inf_approx``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..block_sizes import pad_to
from ..mask_rules import MaskRule
from ..schedule import build_schedule
from ..sync_modes import SyncPack
from ..utils.dtypes import neg_inf_approx
from .kernel_common import build_tile_mask

__all__ = ["flash_attention_xla"]

#: score elements (batch x q rows x kv columns) of one group's tile
_GROUP_ELEMS = 1 << 21


def _groups(n_blocks: int, batch: int, block_a: int, block_b: int):
    """Ranges of at most ``_GROUP_ELEMS // (batch * block_a * block_b)``
    blocks (at least one) covering ``range(n_blocks)``."""
    size = max(1, _GROUP_ELEMS // (batch * block_a * block_b))
    return [range(lo, min(lo + size, n_blocks)) for lo in range(0, n_blocks, size)]


def _blocks(x: torch.Tensor, idx: torch.Tensor, block: int) -> torch.Tensor:
    """Blocks ``idx`` (n,) of ``x`` (B, padded, c) as (B, n, block, c)."""
    B, n_pad, c = x.shape
    return x.view(B, n_pad // block, block, c)[:, idx]


def _tile_masks(pack, rule, qb, kb, block_q, block_kv, q_len, k_len, q_pad, k_pad):
    """Visibility of tiles (qb[i], kb[i]) as (n, block_q, block_kv), or None
    when nothing can be masked."""
    dev = qb.device
    q_pos = qb.view(-1, 1, 1) * block_q + torch.arange(block_q, device=dev).view(1, -1, 1)
    k_pos = kb.view(-1, 1, 1) * block_kv + torch.arange(block_kv, device=dev).view(1, 1, -1)
    return build_tile_mask(pack, rule, q_pos, k_pos, q_len, k_len, q_pad, k_pad)


def _steps(sched, grp):
    """The kv steps a group of rows ``grp`` takes: ``(step, live, masked)``
    with ``live`` the rows (numpy bool) that have a tile at ``step`` and
    ``masked`` whether any live tile needs the element mask.  Steps past
    every row's count and masks of fully visible tiles change nothing (the
    JAX scan keeps its carry there, and an all-true mask is no mask), so
    they are skipped, from the host's schedule alone."""
    counts = sched.kv_counts[grp.start:grp.stop]
    for step in range(int(counts.max(initial=0))):
        live = counts > step
        yield step, live, bool(sched.needs_mask[grp.start:grp.stop, step][live].any())


def _keep_live(live, new, old):
    """``new`` in the live rows, ``old`` in the others (rows on axis 1)."""
    if live.all():
        return new
    return torch.where(torch.from_numpy(live).to(new.device).view(1, -1, 1, 1), new, old)


def _masked_scores(q_blk, k_blk, mask, scale, neg):
    s = torch.matmul(q_blk, k_blk.transpose(-1, -2)) * scale
    return s if mask is None else torch.where(mask, s, torch.full_like(s, neg))


def _keep(mask, p):
    return p if mask is None else p * mask


def _fwd(q, k, v, pack, rule, scale, block_q, block_kv, sched, q_len, k_len):
    """(o, l, m) on padded (B, q_pad, d) / (B, k_pad, *) tensors."""
    dtype, dev = q.dtype, q.device
    neg = neg_inf_approx(dtype)
    B, q_pad, _ = q.shape
    k_pad, v_d = k.shape[1], v.shape[2]
    nq = q_pad // block_q
    table = torch.from_numpy(sched.kv_table).to(dev, torch.long)
    o = torch.empty((B, nq, block_q, v_d), dtype=dtype, device=dev)
    l = torch.empty((B, nq, block_q), dtype=dtype, device=dev)
    m = torch.empty((B, nq, block_q), dtype=dtype, device=dev)
    for grp in _groups(nq, B, block_q, block_kv):
        qi = torch.arange(grp.start, grp.stop, device=dev)
        q_blk = q.view(B, nq, block_q, -1)[:, grp.start:grp.stop]
        n = len(grp)
        m_prev = torch.full((B, n, block_q, 1), neg, dtype=dtype, device=dev)
        l_prev = torch.zeros((B, n, block_q, 1), dtype=dtype, device=dev)
        acc = torch.zeros((B, n, block_q, v_d), dtype=dtype, device=dev)
        for step, live, masked in _steps(sched, grp):
            kb = table[qi, step]
            mask = (_tile_masks(pack, rule, qi, kb, block_q, block_kv, q_len, k_len, q_pad, k_pad)
                    if masked else None)
            s = _masked_scores(q_blk, _blocks(k, kb, block_kv), mask, scale, neg)
            m_curr = s.amax(dim=-1, keepdim=True)
            m_next = torch.maximum(m_prev, m_curr)
            # guard exp against the all-dead case (m_next == neg): shift by 0
            m_safe = torch.where(m_next <= neg, torch.zeros_like(m_next), m_next)
            alpha = torch.exp(m_prev - m_safe) * (m_prev > neg)
            p = _keep(mask, torch.exp(s - m_safe))
            l_next = alpha * l_prev + p.sum(dim=-1, keepdim=True)
            acc_next = acc * alpha + torch.matmul(p, _blocks(v, kb, block_kv))
            m_prev = _keep_live(live, m_next, m_prev)
            l_prev = _keep_live(live, l_next, l_prev)
            acc = _keep_live(live, acc_next, acc)
        dead = m_prev <= neg
        l_fin = torch.where(dead, torch.zeros_like(l_prev), l_prev)
        l_safe = torch.where(l_fin == 0.0, torch.ones_like(l_fin), l_fin)
        o[:, grp.start:grp.stop] = torch.where(dead, torch.zeros_like(acc), acc / l_safe)
        l[:, grp.start:grp.stop] = l_fin[..., 0]
        m[:, grp.start:grp.stop] = torch.where(dead, torch.full_like(m_prev, neg), m_prev)[..., 0]
    return o.view(B, q_pad, v_d), l.view(B, q_pad), m.view(B, q_pad)


def _recompute_p(q_blk, k_blk, m_row, l_row, mask, scale, neg):
    s = _masked_scores(q_blk, k_blk, mask, scale, neg)
    m_safe = torch.where(m_row <= neg, torch.zeros_like(m_row), m_row)
    p = _keep(mask, torch.exp(s - m_safe))
    zero = l_row == 0.0
    l_inv = torch.where(zero, torch.zeros_like(l_row),
                        1.0 / torch.where(zero, torch.ones_like(l_row), l_row))
    return p * l_inv


def _bwd(q, k, v, o, l, m, do, pack, rule, scale, block_q, block_kv, sched, q_len, k_len):
    dtype, dev = q.dtype, q.device
    neg = neg_inf_approx(dtype)
    B, q_pad, d = q.shape
    k_pad, v_d = k.shape[1], v.shape[2]
    nq, nk = q_pad // block_q, k_pad // block_kv
    delta = (do * o).sum(dim=-1)                          # (B, q_pad)
    rows = lambda x, idx: _blocks(x[..., None], idx, block_q)   # (B, n, block_q, 1)

    table = torch.from_numpy(sched.kv_table).to(dev, torch.long)
    dq = torch.empty_like(q)
    for grp in _groups(nq, B, block_q, block_kv):
        qi = torch.arange(grp.start, grp.stop, device=dev)
        n = len(grp)
        q_blk, do_blk = _blocks(q, qi, block_q), _blocks(do, qi, block_q)
        m_row, l_row, d_row = rows(m, qi), rows(l, qi), rows(delta, qi)
        acc = torch.zeros((B, n, block_q, d), dtype=dtype, device=dev)
        for step, live, masked in _steps(sched, grp):
            kb = table[qi, step]
            k_blk, v_blk = _blocks(k, kb, block_kv), _blocks(v, kb, block_kv)
            mask = (_tile_masks(pack, rule, qi, kb, block_q, block_kv, q_len, k_len, q_pad, k_pad)
                    if masked else None)
            p = _recompute_p(q_blk, k_blk, m_row, l_row, mask, scale, neg)
            ds = p * (torch.matmul(do_blk, v_blk.transpose(-1, -2)) - d_row)
            acc = acc + _keep_live(live, torch.matmul(ds, k_blk), 0.0)
        dq.view(B, nq, block_q, d)[:, grp.start:grp.stop] = acc * scale

    sched_t = sched.transpose()
    table_t = torch.from_numpy(sched_t.kv_table).to(dev, torch.long)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for grp in _groups(nk, B, block_kv, block_q):
        ki = torch.arange(grp.start, grp.stop, device=dev)
        n = len(grp)
        k_blk, v_blk = _blocks(k, ki, block_kv), _blocks(v, ki, block_kv)
        dk_acc = torch.zeros((B, n, block_kv, d), dtype=dtype, device=dev)
        dv_acc = torch.zeros((B, n, block_kv, v_d), dtype=dtype, device=dev)
        for step, live, masked in _steps(sched_t, grp):
            qb = table_t[ki, step]
            q_blk, do_blk = _blocks(q, qb, block_q), _blocks(do, qb, block_q)
            mask = (_tile_masks(pack, rule, qb, ki, block_q, block_kv, q_len, k_len, q_pad, k_pad)
                    if masked else None)
            p = _recompute_p(q_blk, k_blk, rows(m, qb), rows(l, qb), mask, scale, neg)
            dv_upd = torch.matmul(p.transpose(-1, -2), do_blk)
            ds = p * (torch.matmul(do_blk, v_blk.transpose(-1, -2)) - rows(delta, qb))
            dk_upd = torch.matmul(ds.transpose(-1, -2), q_blk)
            dk_acc = dk_acc + _keep_live(live, dk_upd, 0.0)
            dv_acc = dv_acc + _keep_live(live, dv_upd, 0.0)
        dk.view(B, nk, block_kv, d)[:, grp.start:grp.stop] = dk_acc * scale
        dv.view(B, nk, block_kv, v_d)[:, grp.start:grp.stop] = dv_acc
    return dq, dk, dv


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (B, len, ...) zero-padded along the sequence to ``n``."""
    if x.shape[1] == n:
        return x.contiguous()
    pad = x.new_zeros((x.shape[0], n - x.shape[1]) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


class _AttendXLA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pack, rule, scale, block_q, block_kv):
        q_len, k_len = q.shape[1], v.shape[1]
        q_pad, k_pad = pad_to(q_len, block_q), pad_to(k_len, block_kv)
        sched = build_schedule(pack, rule, block_q, block_kv)
        o, lv, mv = _fwd(_pad_seq(q, q_pad), _pad_seq(k, k_pad), _pad_seq(v, k_pad), pack, rule,
                         scale, block_q, block_kv, sched, q_len, k_len)
        o, lv, mv = o[:, :q_len], lv[:, :q_len], mv[:, :q_len]
        ctx.save_for_backward(q, k, v, o, lv, mv)
        ctx.args = (pack, rule, scale, block_q, block_kv, sched)
        ctx.mark_non_differentiable(lv, mv)
        return o, lv, mv

    @staticmethod
    def backward(ctx, do, dl, dm):
        # gradients flow from o only: l and m are backward caches (the
        # reference's gradient registration ignores their cotangents)
        del dl, dm
        q, k, v, o, lv, mv = ctx.saved_tensors
        pack, rule, scale, block_q, block_kv, sched = ctx.args
        q_len, k_len = q.shape[1], v.shape[1]
        q_pad, k_pad = pad_to(q_len, block_q), pad_to(k_len, block_kv)
        pq, pk = (lambda x: _pad_seq(x, q_pad)), (lambda x: _pad_seq(x, k_pad))
        dq, dk, dv = _bwd(pq(q), pk(k), pk(v), pq(o), pq(lv), pq(mv), pq(do), pack, rule,
                          scale, block_q, block_kv, sched, q_len, k_len)
        return dq[:, :q_len], dk[:, :k_len], dv[:, :k_len], None, None, None, None, None


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, pack: SyncPack,
                        rule: MaskRule, scale: Optional[float] = None, block_q: int = 512,
                        block_kv: int = 512):
    """Differentiable chunked attention on sequence-major tensors.

    The ``(B, seq, channel) -> (o, l, m)`` contract of
    ``ops.forward.flash_forward``, computed in the input dtype for float32
    and float64 inputs (float64 at the reference's 1e-9 internal-test
    precision class).  Inputs under 32 bits run in float32 (the online
    carries must not run at half precision), with ``o`` cast back to the
    input dtype and ``l``/``m`` left in float32.  Gradients flow from the
    ``o`` cotangent only."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    block_q = min(block_q, pad_to(q.shape[1], 8))
    block_kv = min(block_kv, pad_to(v.shape[1], 8))
    in_dtype = q.dtype
    if in_dtype.itemsize < 4:
        f32 = lambda x: x.to(torch.float32)
        o, l, m = _AttendXLA.apply(f32(q), f32(k), f32(v), pack, rule, float(scale),
                                   int(block_q), int(block_kv))
        return o.to(in_dtype), l, m
    return _AttendXLA.apply(q, k, v, pack, rule, float(scale), int(block_q), int(block_kv))
