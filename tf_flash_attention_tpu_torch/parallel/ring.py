"""Ring attention: context parallelism, forward and backward (PyTorch port
of the JAX package's ``parallel/ring.py``).

The sequence is split into ``n`` equal shards, one a device of a
``context`` axis, for q and for K/V alike.  K/V shards rotate around the
ring while every device runs the port's flash kernels on the shard in
front of it, and merges the pair's ``(o, l, m)`` into its running output
with the kernels' own online recurrence:

    m' = max(m, m_s);  l' = e^(m-m')·l + e^(m_s-m')·l_s
    O' = (e^(m-m')·l·O + e^(m_s-m')·l_s·O_s) / l'

Causal masking decomposes over aligned equal shards: an earlier K/V shard
is fully visible (the full rule), the diagonal shard is locally causal and
a later one is skipped.  A local rule runs the banded shard schedule
(``_local_live_steps``): only the steps its window reaches are visited,
each shard pair masked at its global positions (``_offset_pack``).  2d
sequences shard along dim 0 (row slabs of the row-major flattening).

Either kind of mesh (``parallel/mesh.py``).  Single-controller, one
process drives every shard, and JAX's ``ppermute`` is a rotation of a list
of tensors, each moved to the device of its new slot; the shards may share
a device (``cuda:0`` four times).  Over a process group each rank passes
its own shard and the rotation is ``collectives.ppermute`` over the
``context`` line; every rank takes every rotation of the static schedule
(``_visits``), so the ranks' sends and receives pair up.  The ring is one
``torch.autograd.Function`` over the shards a process holds, the
counterpart of the JAX package's ``custom_vjp``: its forward saves each
shard's ``(q, k, v, o)`` and the *global* ``(l, m)``; its backward runs its
own ring, calling ``flash_backward`` on each visited pair with those global
stats, and the dK/dV partials rotate with their K/V shards until they are
home.  The merge
and the float32 gradient sums are plain torch, as they are ``jnp`` outside
any kernel in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..block_sizes import BlockConfig, choose_block_config
from ..mask_rules import CausalRule, FullRule, LocalRule
from ..ops.backward import flash_backward
from ..ops.forward import flash_forward
from ..serving.graphs import graph_callable
from ..sync_modes import SeqDescriptor, SyncPack, make_sync_pack
from ..utils.dtypes import MASK_VALUE_F32
from .collectives import LOCAL, Axis, ppermute
from .mesh import AXIS_CONTEXT, AXIS_DATA, AXIS_MODEL, Mesh, shard, unshard

__all__ = ["ring_attention_local", "ring_flash_attention"]


@dataclasses.dataclass(frozen=True)
class _RingParams:
    axis_size: int
    causal: bool
    scale: float
    block_config: BlockConfig
    local_rule: Optional[LocalRule] = None  # local rule over the ring
    #: local (per-shard) sequence shape; ndim > 1 means a 2d sequence
    #: sharded along dim 0 (row slabs of the flattened layout)
    seq_shape: tuple = ()


def _shift(xs: Sequence[torch.Tensor], delta: int, axis: Axis, n: int) -> List[torch.Tensor]:
    """``ppermute`` by ``delta`` around the ring of ``n``: shard ``i``'s
    tensor moves to slot ``(i + delta) % n``, on that slot's device (the
    caller's shards ``xs``: all of them in process, its own over a process
    group)."""
    return ppermute(xs, axis, [(i, (i + delta) % n) for i in range(n)])


def _branch_index(src: int, my: int) -> int:
    return 1 if src == my else (2 if src > my else 0)


def _offset_pack(seq_shape, q_off0: int, k_off0: int) -> SyncPack:
    """Sync pack placing the two shards at their *global* positions.

    ``seq_shape`` is the local per-shard sequence shape; shards are offset
    along dimension 0 only (the sharded dimension).  Order coordinates
    become global sequence positions (offset + index), so the rule
    predicates and the block-skip schedule see exactly the global geometry
    of the shard pair.
    """
    pow2 = lambda n: 1 << (int(n) - 1).bit_length()
    top0 = max(q_off0, k_off0) + seq_shape[0]
    ref = (pow2(top0),) + tuple(pow2(s) for s in seq_shape[1:])
    ndim = len(seq_shape)
    q_off = (int(q_off0),) + (0,) * (ndim - 1)
    k_off = (int(k_off0),) + (0,) * (ndim - 1)
    return SyncPack(
        reference_shape=ref,
        q=SeqDescriptor(tuple(seq_shape), (1,) * ndim, q_off),
        k=SeqDescriptor(tuple(seq_shape), (1,) * ndim, k_off),
    )


def _local_live_steps(rule, n: int, r0: int):
    """Static per-step liveness of the banded shard schedule.

    ``r0`` is the per-shard extent of the sharded sequence dimension
    (dim 0; the whole sequence for 1d).  At ring step ``t`` a device sees
    the shard ``t`` positions behind it (or ``n - t`` ahead, for devices
    that wrapped).  A shard pair can contain a visible element iff the
    per-dim window reaches across the dim-0 gap:
    ``gap*r0 - (r0-1) <= strided_window - 1`` (the remaining dimensions
    always overlap — shards span them fully).  Steps where neither the
    behind nor (non-causal) ahead case is live are dropped entirely — the
    rotation jumps straight to the next live step.
    """
    sw = rule.strided_window_size
    steps = []
    for t in range(n):
        behind = (t * r0) <= sw + r0 - 2
        ahead = (not rule.is_causal) and t > 0 and ((n - t) * r0) <= sw + r0 - 2
        if t == 0 or behind or ahead:
            steps.append((t, behind or t == 0, ahead))
    return steps


def _merge(state, part):
    """The online (m, l, O) merge of a shard pair's float32 ``part``; a
    skipped pair (``part`` None) merges as ``(0, 0, MASK_VALUE_F32)``, as in
    the JAX package."""
    o, l, m = state
    if part is None:
        o_s, l_s, m_s = torch.zeros_like(o), torch.zeros_like(l), torch.full_like(m, MASK_VALUE_F32)
    else:
        o_s, l_s, m_s = part
    m_new = torch.maximum(m, m_s)
    a = torch.exp(m - m_new)
    b_w = torch.exp(m_s - m_new)
    l_new = a * l + b_w * l_s
    l_safe = torch.where(l_new == 0.0, torch.ones_like(l_new), l_new)
    o = ((a * l)[..., None] * o + (b_w * l_s)[..., None] * o_s) / l_safe[..., None]
    return o, l_new, m_new


def _visits(p: _RingParams, n: int):
    """The ring's steps: ``(t, parts)``, K/V rotated by ``t`` in all before
    step ``t``, ``parts[my]`` device ``my``'s pair as ``(pack, rule)``, or
    None where the pair is skipped."""
    seq_shape = p.seq_shape
    if p.local_rule is not None:
        r0 = seq_shape[0]
        for t, behind_live, ahead_live in _local_live_steps(p.local_rule, n, r0):
            behind = (_offset_pack(seq_shape, t * r0, 0), p.local_rule) if behind_live else None
            ahead = (_offset_pack(seq_shape, 0, (n - t) * r0), p.local_rule) if ahead_live else None
            # device my sees shard my - t (no wrap) behind it, else ahead
            yield t, [behind if my >= t else ahead for my in range(n)]
        return
    # diagonal-shard pack in *local* coordinates: row-major flattening is
    # monotone in the dim-0 coordinate, so slab-local order comparisons
    # equal global ones (both operands share the same dim-0 offset)
    pack = make_sync_pack("none_front", seq_shape, seq_shape)
    rules = (FullRule(), CausalRule(), None)
    for step in range(n):
        picked = [rules[_branch_index((my - step) % n, my)] if p.causal else rules[0]
                  for my in range(n)]
        yield step, [None if r is None else (pack, r) for r in picked]


def _mine(parts, axis: Axis, qs):
    """The caller's pairs of a ``_visits`` step, one a shard it holds."""
    return parts[axis.index:axis.index + len(qs)]


def _ring_forward(qs, ks, vs, p: _RingParams, axis: Axis):
    """The caller's shards' ``(o, l, m)``: ``o`` in q's dtype, the global
    stats in float32."""
    n = p.axis_size
    state = [(torch.zeros((*q.shape[:2], v.shape[-1]), dtype=torch.float32, device=q.device),
              torch.zeros(q.shape[:2], dtype=torch.float32, device=q.device),
              torch.full(q.shape[:2], MASK_VALUE_F32, dtype=torch.float32, device=q.device))
             for q, v in zip(qs, vs)]
    k_cur, v_cur, rot = list(ks), list(vs), 0
    for t, parts in _visits(p, n):
        if t != rot:
            k_cur, v_cur = _shift(k_cur, t - rot, axis, n), _shift(v_cur, t - rot, axis, n)
            rot = t
        for my, part in enumerate(_mine(parts, axis, qs)):
            if part is not None:
                o_s, l_s, m_s = flash_forward(qs[my], k_cur[my], v_cur[my], pack=part[0],
                                              rule=part[1], config=p.block_config, scale=p.scale)
                part = (o_s.float(), l_s, m_s)
            state[my] = _merge(state[my], part)
    return [(o.to(q.dtype), l, m) for (o, l, m), q in zip(state, qs)]


def _ring_backward(qs, ks, vs, os_, ls, ms, dos, p: _RingParams, axis: Axis):
    """The caller's shards' ``(dq, dk, dv)``: dK/dV partials ride with their
    K/V shards and are rotated home after the last visit."""
    n = p.axis_size
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dk_cur = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dv_cur = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
    k_cur, v_cur, rot = list(ks), list(vs), 0
    for t, parts in _visits(p, n):
        if t != rot:
            k_cur, v_cur = _shift(k_cur, t - rot, axis, n), _shift(v_cur, t - rot, axis, n)
            dk_cur, dv_cur = _shift(dk_cur, t - rot, axis, n), _shift(dv_cur, t - rot, axis, n)
            rot = t
        for my, part in enumerate(_mine(parts, axis, qs)):
            if part is None:
                continue   # a skipped pair's gradients are exact zeros
            dq_s, dk_s, dv_s = flash_backward(qs[my], k_cur[my], v_cur[my], os_[my], ls[my],
                                              ms[my], dos[my], pack=part[0], rule=part[1],
                                              config=p.block_config, scale=p.scale)
            dq[my] = dq[my] + dq_s.float()
            dk_cur[my] = dk_cur[my] + dk_s.float()
            dv_cur[my] = dv_cur[my] + dv_s.float()
    if rot % n:
        home = (n - rot) % n
        dk_cur, dv_cur = _shift(dk_cur, home, axis, n), _shift(dv_cur, home, axis, n)
    return ([x.to(q.dtype) for x, q in zip(dq, qs)], [x.to(k.dtype) for x, k in zip(dk_cur, ks)],
            [x.to(v.dtype) for x, v in zip(dv_cur, vs)])


class _RingAttend(torch.autograd.Function):
    """The ring over the caller's shards (all ``n`` in process, its own over
    a process group): inputs ``(params, axis, *qs, *ks, *vs)``, outputs the
    caller's output shards."""

    @staticmethod
    def forward(ctx, params: _RingParams, axis: Axis, *qkv):
        n = len(qkv) // 3
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        outs = _ring_forward(qs, ks, vs, params, axis)
        os_ = [o for o, _, _ in outs]
        ctx.params, ctx.axis = params, axis
        ctx.save_for_backward(*qs, *ks, *vs, *os_, *(l for _, l, _ in outs),
                              *(m for _, _, m in outs))
        return tuple(os_)

    @staticmethod
    def backward(ctx, *dos):
        saved = ctx.saved_tensors
        n = len(saved) // 6
        qs, ks, vs, os_, ls, ms = (saved[i * n:(i + 1) * n] for i in range(6))
        dq, dk, dv = _ring_backward(qs, ks, vs, os_, ls, ms, dos, ctx.params, ctx.axis)
        return (None, None, *dq, *dk, *dv)


def ring_attention_local(
    q: Sequence[torch.Tensor],
    k: Sequence[torch.Tensor],
    v: Sequence[torch.Tensor],
    *,
    causal: bool = True,
    rule=None,
    seq_shape=None,
    scale: Optional[float] = None,
    block_config: Optional[BlockConfig] = None,
    axis: Axis = LOCAL,
) -> List[torch.Tensor]:
    """Ring attention over the shards of one context axis; differentiable.

    ``q, k, v``: the ``n`` local shards ``(B, s, d)`` (``k``/``v`` may have
    ``B / g`` rows: grouped-query attention), shard ``i`` holding sequence
    positions ``[i·s, (i+1)·s)``, each on its device (the JAX function's
    ``shard_map`` body over an axis of ``n``, seen from all devices at
    once).  Over a process group (``axis`` a process-group mesh's
    ``context`` axis, ``Mesh.axis``) each list holds the caller's own shard
    and the ring spans the axis's ranks.  ``rule`` may be Full/Causal (overrides ``causal``) or a
    :class:`LocalRule`, which runs the banded shard schedule.
    ``seq_shape`` is the *local* (per-shard) sequence shape for 2d
    sequences sharded along dim 0 (``s`` must equal its product); omit for
    1d.  Returns the caller's output shards ``(B, s, v_d)``.
    """
    if not q or len(k) != len(q) or len(v) != len(q):
        raise ValueError(f"{len(q)} q, {len(k)} k and {len(v)} v shards")
    n = axis.size if axis.group is not None else len(q)
    if axis.group is not None and len(q) != 1:
        raise ValueError(f"{len(q)} shards on a process-group axis: a rank passes its own")
    B, s, d = q[0].shape
    seq_shape = tuple(int(x) for x in (seq_shape or (s,)))
    if int(np.prod(seq_shape)) != s:
        raise ValueError(f"seq_shape {seq_shape} does not flatten to {s}")
    if block_config is None:
        block_config = choose_block_config(d, v[0].shape[-1])
    local_rule = None
    if rule is not None:
        if isinstance(rule, LocalRule):
            local_rule = rule
        elif isinstance(rule, CausalRule):
            causal = True
        elif isinstance(rule, FullRule):
            causal = False
        else:
            raise ValueError(f"unsupported ring rule {rule!r}")
    params = _RingParams(axis_size=n, causal=bool(causal),
                         scale=1.0 / math.sqrt(d) if scale is None else float(scale),
                         block_config=block_config, local_rule=local_rule,
                         seq_shape=seq_shape)
    return list(_RingAttend.apply(params, axis, *q, *k, *v))


def ring_flash_attention(
    mesh: Mesh,
    *,
    causal: bool = True,
    rule=None,
    seq_shape=None,
    scale: Optional[float] = None,
    block_config: Optional[BlockConfig] = None,
    data_axis: str = AXIS_DATA,
    model_axis: str = AXIS_MODEL,
    context_axis: str = AXIS_CONTEXT,
):
    """A context-parallel ring-attention callable over ``mesh``.

    Input layout ``(batch, heads, seq, head_dim)``: batch on ``data``,
    heads on ``model``, sequence on ``context`` (missing axes count as size
    1).  For 2d sequences pass the *global* ``seq_shape``; the ``seq`` axis
    carries the row-major flattening and is sharded along sequence dim 0
    (dim 0 must divide by the context axis size).  The callable takes and
    returns whole tensors (the output on q's device) and is differentiable
    end to end; over a process group every rank passes the whole inputs
    (JAX's global arrays), runs the ring on its own block with its
    ``context`` line, and gets the whole output and the whole input
    gradients.  Where the devices the caller drives are CUDA devices (one
    card, or several) it is a ``serving.graphs.GraphedFunction`` (JAX's
    ``jit``): a forward and a backward CUDA graph per input signature, each
    across the cards, the first call eager.
    """
    axis_size = int(mesh.shape.get(context_axis, 1))
    local_seq_shape = None
    if seq_shape is not None:
        seq_shape = tuple(int(x) for x in seq_shape)
        if seq_shape[0] % axis_size:
            raise ValueError(
                f"sequence dim 0 ({seq_shape[0]}) must divide by the "
                f"context axis size ({axis_size})")
        local_seq_shape = (seq_shape[0] // axis_size,) + seq_shape[1:]
    spec = (data_axis, model_axis, context_axis, None)

    ax = mesh.axis(context_axis)

    def local_fn(qs, ks, vs):
        b, h, s, d = qs[0].shape
        os_ = ring_attention_local(
            [x.reshape(b * h, s, d) for x in qs], [x.reshape(b * h, s, d) for x in ks],
            [x.reshape(b * h, s, x.shape[-1]) for x in vs], causal=causal, rule=rule,
            seq_shape=local_seq_shape, scale=scale, block_config=block_config, axis=ax)
        return [o.reshape(b, h, s, -1) for o in os_]

    def fn(q, k, v):
        qb, kb, vb = (shard(x, mesh, spec) for x in (q, k, v))
        if mesh.process_group:
            return unshard(local_fn([qb], [kb], [vb])[0], spec, q.device, mesh)
        out = [[local_fn(*blocks) for blocks in zip(*rows)] for rows in zip(qb, kb, vb)]
        return unshard(out, spec, q.device)

    return graph_callable(fn, mesh)
