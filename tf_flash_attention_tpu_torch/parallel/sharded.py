"""Multi-head attention layer (PyTorch port of ``parallel/sharded.py``).

``mha`` is the ``(batch, heads, seq, head_dim)`` GQA layer the model calls,
on one device.  ``sharded_flash_attention`` runs it over a ``(data,
model)`` mesh: batch sharded on ``data``, heads on ``model``, each block's
``mha`` on its device, with no communication inside attention.  GQA keeps
each KV head with its query-head group.  Either kind of mesh
(``parallel/mesh.py``): single-controller, one process drives every block;
over a process group, each rank its own block, the whole gathered at the
edges.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..block_sizes import BlockConfig, choose_block_config
from ..mask_rules import MaskRule
from ..ops.attend import AttendParams, attend
from ..serving.graphs import graph_callable
from ..sync_modes import make_sync_pack
from .mesh import AXIS_DATA, AXIS_MODEL, Mesh, shard, unshard

__all__ = ["mha", "sharded_flash_attention"]


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, rule: MaskRule,
        sync_mode: str = "none_front", scale: Optional[float] = None,
        block_config: Optional[BlockConfig] = None, return_stats: bool = False):
    """Multi-head attention on ``(batch, heads, seq, head_dim)`` tensors.

    GQA/MQA: ``k``/``v`` may have fewer heads than ``q`` when
    ``num_q_heads % num_kv_heads == 0``; with heads minor in the flattened
    batch, query row ``b·hq + h`` reads kv row ``(b·hq + h) // (hq / hkv)``
    inside the kernels, so no kv head is repeated in memory.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if dk != d:
        raise ValueError(f"head_dim mismatch: {d} vs {dk}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if block_config is None:
        block_config = choose_block_config(d, v.shape[-1])
    pack = make_sync_pack(sync_mode, (sq,), (skv,))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    params = AttendParams(pack=pack, rule=rule, config=block_config, scale=float(scale))
    o, l, m = attend(q.reshape(b * hq, sq, d), k.reshape(b * hkv, skv, d),
                     v.reshape(b * hkv, skv, v.shape[-1]), params)
    o = o.reshape(b, hq, sq, -1)
    if return_stats:
        return o, l.reshape(b, hq, sq), m.reshape(b, hq, sq)
    return o


def sharded_flash_attention(mesh: Mesh, rule: MaskRule, *, sync_mode: str = "none_front",
                            scale: Optional[float] = None,
                            block_config: Optional[BlockConfig] = None,
                            data_axis: str = AXIS_DATA, model_axis: str = AXIS_MODEL):
    """A head- and data-sharded attention callable over ``mesh``.

    Input layout ``(batch, heads, seq, head_dim)``; batch sharded over
    ``data_axis``, heads over ``model_axis``; sequence and head_dim
    replicated.  Each block runs ``mha`` on its device.  The callable takes
    and returns whole tensors (the output on q's device) and is
    differentiable; over a process group every rank passes the whole inputs
    (JAX's global arrays), runs its own block and gets the whole output and
    the whole input gradients.  Where the devices the caller drives are
    CUDA devices (one card, or several) it is a
    ``serving.graphs.GraphedFunction`` (JAX's ``jit``): a forward and a
    backward CUDA graph per input signature, each across the cards, the
    first call eager.
    """
    spec = (data_axis, model_axis, None, None)
    attend = lambda qb, kb, vb: mha(qb, kb, vb, rule=rule, sync_mode=sync_mode, scale=scale,
                                    block_config=block_config)

    def fn(q, k, v):
        blocks = [shard(x, mesh, spec) for x in (q, k, v)]
        if mesh.process_group:
            return unshard(attend(*blocks), spec, q.device, mesh)
        out = [[attend(*b) for b in zip(*rows)] for rows in zip(*blocks)]
        return unshard(out, spec, q.device)

    return graph_callable(fn, mesh)
