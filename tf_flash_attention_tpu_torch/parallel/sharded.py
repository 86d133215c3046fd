"""Multi-head attention layer (PyTorch port of ``parallel/sharded.py``).

``mha`` is the ``(batch, heads, seq, head_dim)`` GQA layer the model calls,
on one device.  ``sharded_flash_attention`` (heads and batch sharded over a
mesh) needs ``torch.distributed`` and is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..block_sizes import BlockConfig, choose_block_config
from ..mask_rules import MaskRule
from ..ops.attend import AttendParams, attend
from ..sync_modes import make_sync_pack

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


def sharded_flash_attention(*args, **kwargs):
    """Head- and data-sharded attention over a device mesh: not ported yet."""
    raise NotImplementedError("sharded attention needs torch.distributed and is not ported "
                              "yet (ROADMAP queue 1 item 11)")
