"""Ulysses sequence parallelism: head <-> sequence resharding (PyTorch port
of the JAX package's ``parallel/ulysses.py``).

The second context-parallel strategy beside the ring (``parallel/ring.py``).
Inputs arrive sequence-sharded over the ``context`` axis; an all-to-all
turns them into *head*-sharded tensors holding the **full** sequence, each
device runs the local flash kernels (``ops/attend.py``) on its head group,
and a second all-to-all turns the output back to sequence shards:

    (b, H, S/cp, d) --a2a(heads->seq)--> (b, H/cp, S, d)
        --local flash attention--> (b, H/cp, S, v_d)
        --a2a(seq->heads)--> (b, H, S/cp, v_d)

Every mask rule and sync mode works unchanged, since each device sees the
whole sequence; the context axis is bounded by the head counts.

Either kind of mesh, as the ring: the all-to-all is ``collectives.py``'s,
in process a split of every shard's heads and a concatenation of the
pieces, in mesh-axis order, on the receiving device, over a process group
an ``all_to_all`` over the ``context`` line whose backward is the inverse
one.  Both are differentiable, and the local attention is the
``autograd.Function`` of ``ops/attend.py``, so gradients need no backward
of this module's own.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..block_sizes import BlockConfig, choose_block_config
from ..mask_rules import MaskRule
from ..ops.attend import AttendParams, attend
from ..serving.graphs import graph_callable
from ..sync_modes import make_sync_pack
from .collectives import LOCAL, Axis, all_to_all
from .mesh import AXIS_CONTEXT, AXIS_DATA, AXIS_MODEL, Mesh, shard, unshard

__all__ = ["ulysses_attention_local", "ulysses_flash_attention"]


def ulysses_attention_local(
    q: Sequence[torch.Tensor],
    k: Sequence[torch.Tensor],
    v: Sequence[torch.Tensor],
    *,
    rule: MaskRule,
    sync_mode: str = "none_front",
    q_seq_shape=None,
    k_seq_shape=None,
    scale: Optional[float] = None,
    block_config: Optional[BlockConfig] = None,
    axis: Axis = LOCAL,
) -> List[torch.Tensor]:
    """Ulysses over the shards of one context axis; differentiable.

    ``q``: the ``cp`` shards ``(b, Hq, sq_local, d)``; ``k``/``v``: ``(b,
    Hkv, skv_local, *)``, each on its device, shard ``i`` holding the
    ``i``-th slice of the sequence (row slabs of dim 0 for 2d sequences,
    whose *global* shapes are ``q_seq_shape``/``k_seq_shape``).  Over a
    process group (``axis`` a process-group mesh's ``context`` axis) each
    list holds the caller's own shard.  Both head counts must divide by
    ``cp``.  Returns the caller's output shards ``(b, Hq, sq_local, v_d)``.
    """
    cp = axis.size if axis.group is not None else len(q)
    b, hq, sq_loc, d = q[0].shape
    _, hkv, skv_loc, _ = k[0].shape
    if hq % cp or hkv % cp:
        raise ValueError(
            f"Ulysses needs head counts divisible by the context axis size: "
            f"q heads {hq}, kv heads {hkv}, axis {cp} (use ring attention "
            f"when cp exceeds the KV head count)")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")

    sq, skv = sq_loc * cp, skv_loc * cp
    q_seq_shape = tuple(int(x) for x in (q_seq_shape or (sq,)))
    k_seq_shape = tuple(int(x) for x in (k_seq_shape or (skv,)))
    if int(np.prod(q_seq_shape)) != sq or int(np.prod(k_seq_shape)) != skv:
        raise ValueError(
            f"global seq shapes {q_seq_shape}/{k_seq_shape} do not flatten "
            f"to {sq}/{skv}")

    if cp > 1:
        # heads -> sequence: split the head axis over the shards, gather the
        # full sequence in shard order (= global sequence order)
        q, k, v = (all_to_all(x, axis, 1, 2) for x in (q, k, v))
    hq_loc, hkv_loc = hq // cp, hkv // cp
    if block_config is None:
        block_config = choose_block_config(d, v[0].shape[-1])
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    params = AttendParams(pack=make_sync_pack(sync_mode, q_seq_shape, k_seq_shape), rule=rule,
                          config=block_config, scale=float(scale))
    # GQA runs in the kernels: query row b·hq + h reads kv row (b·hq + h) // g
    o = [attend(qi.reshape(b * hq_loc, sq, d), ki.reshape(b * hkv_loc, skv, d),
                vi.reshape(b * hkv_loc, skv, vi.shape[-1]), params)[0].reshape(b, hq_loc, sq, -1)
         for qi, ki, vi in zip(q, k, v)]
    if cp > 1:
        # sequence -> heads, back to the caller's layout
        o = all_to_all(o, axis, 2, 1)
    return o


def ulysses_flash_attention(
    mesh: Mesh,
    rule: MaskRule,
    *,
    sync_mode: str = "none_front",
    q_seq_shape=None,
    k_seq_shape=None,
    scale: Optional[float] = None,
    block_config: Optional[BlockConfig] = None,
    data_axis: str = AXIS_DATA,
    model_axis: str = AXIS_MODEL,
    context_axis: str = AXIS_CONTEXT,
):
    """A Ulysses context-parallel attention callable over ``mesh``.

    Input layout ``(batch, heads, seq, head_dim)``: batch on ``data``,
    heads on ``model``, sequence on ``context`` (the ``seq`` axis carries
    the row-major flattening of 2d sequences, sharded along dim 0, whose
    *global* shapes are ``q_seq_shape``/``k_seq_shape``).  The local head
    count (after any ``model`` sharding) must divide by the context axis
    size.  The callable takes and returns whole tensors (the output on q's
    device) and is differentiable end to end; over a process group every
    rank passes the whole inputs (JAX's global arrays), runs its own block
    with its ``context`` line, and gets the whole output and the whole input
    gradients.  Where the devices the caller drives are CUDA devices (one
    card, or several) it is a ``serving.graphs.GraphedFunction`` (JAX's
    ``jit``): a forward and a backward CUDA graph per input signature, each
    across the cards, the first call eager.
    """
    spec = (data_axis, model_axis, context_axis, None)
    ax = mesh.axis(context_axis)

    def local_fn(qs, ks, vs):
        return ulysses_attention_local(qs, ks, vs, rule=rule, sync_mode=sync_mode,
                                       q_seq_shape=q_seq_shape, k_seq_shape=k_seq_shape,
                                       scale=scale, block_config=block_config, axis=ax)

    def fn(q, k, v):
        blocks = [shard(x, mesh, spec) for x in (q, k, v)]
        if mesh.process_group:
            return unshard(local_fn(*([b] for b in blocks))[0], spec, q.device, mesh)
        out = [[local_fn(*b) for b in zip(*rows)] for rows in zip(*blocks)]
        return unshard(out, spec, q.device)

    return graph_callable(fn, mesh)
