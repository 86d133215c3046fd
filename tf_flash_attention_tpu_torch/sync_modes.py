"""Sequence-synchronisation ("sync mode") engine.

A carried copy of ``tf_flash_attention_tpu/sync_modes.py`` (numpy only),
kept for the same reason as ``mask_rules.py``; ``tests/test_torch_host.py``
holds it equal to the original.

TPU-native re-design of the reference's CuTe-based sync-method engine
(``kernel/sync_methods.{h,cc}``).  The reference builds CuTe order-map
tensors on the host and evaluates them inside the CUDA kernel; on TPU the
same information is a tiny, static, affine description that is consumed at
trace time (by the block-skip schedule builder and by the in-kernel mask
expression).  Shapes are static under ``jit``, so everything here is plain
Python/NumPy executed once per compiled specialisation.

Semantics (``sync_methods.cc:8-111``): for each sequence dimension, with
``max_dim = max(Q_dim, K_dim)`` and ``ref_dim`` the smallest power of two
``>= max_dim``:

* ``none_front``  — ``stride = 1,             offset = 0``
* ``scale_front`` — ``stride = max_dim // dim, offset = 0``
* ``scale_end``   — ``stride = max_dim // dim, offset = stride - 1``

An entry at per-dimension index ``i`` occupies *order coordinate*
``offset + stride * i`` on the shared reference grid, and its flattened
*order* is the row-major index of that coordinate in the power-of-two
reference shape (``sync_methods.h:70-85``; the power-of-two rounding makes
the flattening a shift/mask codec, ``flash_attention.h:11-41``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "SeqDescriptor",
    "SyncPack",
    "SYNC_MODES",
    "make_sync_pack",
    "order_coords",
    "flatten_orders",
    "unflatten_order",
    "ref_log2",
]


@dataclasses.dataclass(frozen=True)
class SeqDescriptor:
    """Affine placement of one sequence on the reference grid.

    Per dimension ``d``: entries sit at order coordinates
    ``offset[d] + stride[d] * i`` for ``i in range(shape[d])``.
    Mirror of ``SequenceDescriptor`` (``sync_methods.h:11-30``).
    """

    shape: Tuple[int, ...]
    stride: Tuple[int, ...]
    offset: Tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)


@dataclasses.dataclass(frozen=True)
class SyncPack:
    """Reference grid + Q/K placements (``SequenceDescriptorPack``)."""

    reference_shape: Tuple[int, ...]  # power-of-two per dimension
    q: SeqDescriptor
    k: SeqDescriptor

    @property
    def ndim(self) -> int:
        return len(self.reference_shape)


def _next_pow2(n: int) -> int:
    if n < 1:
        raise ValueError(f"dimension size must be >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def _make_descriptors(q_shape, k_shape, scaled: bool, at_end: bool) -> SyncPack:
    if len(q_shape) != len(k_shape):
        raise ValueError(
            f"Q and K sequence ranks differ: {len(q_shape)} vs {len(k_shape)}"
        )
    ref, qs, qst, qo, ks, kst, ko = [], [], [], [], [], [], []
    for q_dim, k_dim in zip(q_shape, k_shape):
        q_dim, k_dim = int(q_dim), int(k_dim)
        max_dim = max(q_dim, k_dim)
        ref.append(_next_pow2(max_dim))
        q_stride = max_dim // q_dim if scaled else 1
        k_stride = max_dim // k_dim if scaled else 1
        qs.append(q_dim)
        qst.append(q_stride)
        qo.append(q_stride - 1 if at_end else 0)
        ks.append(k_dim)
        kst.append(k_stride)
        ko.append(k_stride - 1 if at_end else 0)
    return SyncPack(
        reference_shape=tuple(ref),
        q=SeqDescriptor(tuple(qs), tuple(qst), tuple(qo)),
        k=SeqDescriptor(tuple(ks), tuple(kst), tuple(ko)),
    )


SYNC_MODES = ("none_front", "scale_front", "scale_end")


def make_sync_pack(sync_mode: str, q_seq_shape: Sequence[int], k_seq_shape: Sequence[int]) -> SyncPack:
    """Build the sync pack for ``sync_mode`` (name table: ``sync_methods.cc:113-117``)."""
    if sync_mode == "none_front":
        return _make_descriptors(q_seq_shape, k_seq_shape, scaled=False, at_end=False)
    if sync_mode == "scale_front":
        return _make_descriptors(q_seq_shape, k_seq_shape, scaled=True, at_end=False)
    if sync_mode == "scale_end":
        return _make_descriptors(q_seq_shape, k_seq_shape, scaled=True, at_end=True)
    raise ValueError(f"unknown sync_mode {sync_mode!r}; expected one of {SYNC_MODES}")


def ref_log2(reference_shape: Sequence[int]) -> Tuple[int, ...]:
    """log2 of each (power-of-two) reference dimension."""
    out = []
    for s in reference_shape:
        b = int(s).bit_length() - 1
        if (1 << b) != s:
            raise ValueError(f"reference dimension {s} is not a power of two")
        out.append(b)
    return tuple(out)


def order_coords(desc: SeqDescriptor) -> Tuple[np.ndarray, ...]:
    """Per-dimension order coordinates for every index of the sequence.

    Returns one int32 vector per dimension: ``coords[d][i] = offset[d] +
    stride[d] * i``.
    """
    return tuple(
        (desc.offset[d] + desc.stride[d] * np.arange(desc.shape[d], dtype=np.int64)).astype(np.int32)
        for d in range(desc.ndim)
    )


def flatten_orders(reference_shape: Sequence[int], per_dim_orders: Sequence[np.ndarray]) -> np.ndarray:
    """Row-major flattened orders for the cartesian grid of per-dim orders.

    ``result[i0, i1, ...] = sum_d per_dim_orders[d][i_d] << shift_d`` where
    the shifts come from the power-of-two reference shape — the NumPy analog
    of ``AttentionPolicy::MapToOrder`` (``flash_attention.h:27-41``).
    Returns an array of shape ``tuple(len(o) for o in per_dim_orders)``.
    """
    logs = ref_log2(reference_shape)
    ndim = len(logs)
    shifts = [sum(logs[d + 1:]) for d in range(ndim)]
    total = np.zeros((), dtype=np.int64)
    for d in range(ndim):
        axis_shape = [1] * ndim
        axis_shape[d] = -1
        total = total + (per_dim_orders[d].astype(np.int64) << shifts[d]).reshape(axis_shape)
    return np.ascontiguousarray(total.astype(np.int32))


def unflatten_order(reference_shape: Sequence[int], order) -> Tuple[np.ndarray, ...]:
    """Decode flattened orders back to per-dimension coordinates.

    NumPy analog of ``AttentionPolicy::MapToCoords``
    (``flash_attention.h:11-25``): pure shift/mask arithmetic on the
    power-of-two reference shape.
    """
    logs = ref_log2(reference_shape)
    ndim = len(logs)
    shifts = [sum(logs[d + 1:]) for d in range(ndim)]
    order = np.asarray(order, dtype=np.int64)
    return tuple(
        ((order >> shifts[d]) & ((1 << logs[d]) - 1)).astype(np.int32) for d in range(ndim)
    )
