"""Numeric constants and the rule predicate of the attention kernels.

``NEG_INF_F32`` is the finite float32 value of the byte pattern 0xFA
repeated (the JAX package's ``utils/dtypes.py`` masking value), not
``-inf``: a masked logit then gives ``exp2(s - m) == 0``, never NaN, even
when ``m`` is itself the masking value.

``kernel_orders`` and ``build_tile_mask`` are the torch forms of the JAX
package's in-kernel mask expression (``ops/kernel_common.py:48-104``), used
by the plain versions of the kernels.  The CUDA kernels evaluate the same
predicate on the device (``visible`` in ``csrc/attention_common.cuh``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..mask_rules import MaskRule
from ..sync_modes import SeqDescriptor, SyncPack, ref_log2

__all__ = ["kernel_orders", "build_tile_mask", "NEG_INF_F32", "LOG2E", "INV_LOG2E"]

#: The kernels run the online softmax in the log2 domain:
#: ``p = exp2(s * (scale * LOG2E) - m)``; public ``m`` is converted back to
#: the natural-log domain with ``INV_LOG2E``.
LOG2E = float(math.log2(math.e))
INV_LOG2E = 1.0 / LOG2E

NEG_INF_F32 = float(np.frombuffer(b"\xfa" * 4, np.float32)[0])


def kernel_orders(desc: SeqDescriptor, logs: Tuple[int, ...], pos: torch.Tensor):
    """Order coordinates and flattened order of flattened positions ``pos``
    (an int tensor); returns ``(coords, flat)``."""
    ndim = len(desc.shape)
    shifts = [sum(logs[d + 1:]) for d in range(ndim)]
    coords = []
    rem = pos
    for d in range(ndim):
        inner = math.prod(desc.shape[d + 1:])
        idx_d = rem // inner if inner > 1 else rem
        if d + 1 < ndim:
            rem = rem - idx_d * inner
        coords.append(idx_d * desc.stride[d] + desc.offset[d])
    flat = coords[0] << shifts[0] if shifts[0] else coords[0]
    for d in range(1, ndim):
        flat = flat + (coords[d] << shifts[d] if shifts[d] else coords[d])
    return coords, flat


def build_tile_mask(pack: SyncPack, rule: MaskRule, q_pos: torch.Tensor,
                    k_pos: torch.Tensor, q_len: int, k_len: int, q_len_padded: int,
                    k_len_padded: int) -> Optional[torch.Tensor]:
    """Boolean visibility of a (q, k) tile, or ``None`` when nothing can be
    masked.  ``q_pos``/``k_pos`` are global flattened positions as column
    and row int tensors, or any pair of int tensors that broadcast together
    (a stack of tiles: ``(n, rows, 1)`` and ``(n, 1, cols)``)."""
    mask = None
    if not rule.is_full:
        logs = ref_log2(pack.reference_shape)
        q_coords, q_flat = kernel_orders(pack.q, logs, q_pos)
        k_coords, k_flat = kernel_orders(pack.k, logs, k_pos)
        mask = rule.check(pack, q_coords, k_coords, q_flat, k_flat)
    if q_len_padded > q_len:
        bounds_q = q_pos < q_len
        mask = bounds_q if mask is None else (mask & bounds_q)
    if k_len_padded > k_len:
        bounds_k = k_pos < k_len
        mask = bounds_k if mask is None else (mask & bounds_k)
    if mask is None:
        return None
    return torch.broadcast_to(mask, torch.broadcast_shapes(q_pos.shape, k_pos.shape))
