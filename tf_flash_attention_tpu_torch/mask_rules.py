"""Rule-based masking policies (full / causal / local).

A carried copy of ``tf_flash_attention_tpu/mask_rules.py``: importing any
submodule of the JAX package runs its ``__init__``, which imports ``jax``,
and the PyTorch port must import no ``jax``.  ``tests/test_torch_host.py``
holds this copy equal to the original.

TPU-native re-design of the reference's compile-time attention policies
(``kernel/flash_attention.h:9-149``).  Masking patterns are *rules*, never
mask tensors: each rule exposes

* ``check(...)`` — the per-element visibility predicate, written against
  generic array ops so the same code runs on NumPy (trace-time schedule
  building, test oracles) and on ``jnp`` int32 vectors inside Pallas
  kernels (VPU shifts/masks);
* ``tile_live(...)`` — a *conservative* whole-tile liveness test used by the
  block-skip schedule builder, the TPU analog of ``IsSkipped``
  (``flash_attention.h:49-53,68-72,98-115``).  Tiles judged dead are never
  loaded.  Unlike the CUDA version, which tests a bounding box decoded from
  the tile's min/max flattened orders, we test exact per-dimension
  coordinate intervals plus the flattened-order causality bound — provably
  conservative for any tile shape (the skip decision only affects
  performance, never numerics, because ``check`` re-masks every element).

Rule semantics (``flash_attention.h``):

* full   — never skip, always visible (``:45-61``).
* causal — visible iff ``Q_order >= K_order`` on the flattened reference
  grid; a tile is dead iff ``max_Q_order < min_K_order`` (``:64-80``).
* local(window_size, log2_stride_size, is_causal) — with
  ``sw = window_size << log2_stride_size`` and ``mask = 2**log2_stride_size - 1``:
  visible iff per dimension ``|dc| & mask == 0`` and ``|dc| >> s < window``
  (AND-folded across dims), plus the flattened-order causality constraint
  when ``is_causal`` (``:84-140``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .sync_modes import SyncPack

__all__ = ["MaskRule", "FullRule", "CausalRule", "LocalRule", "make_rule"]


class MaskRule:
    """Base class for masking rules."""

    #: True when the rule can never mask anything (skips all mask work).
    is_full: bool = False

    def check(self, pack: SyncPack, q_coords, k_coords, q_flat, k_flat):
        """Element-level visibility predicate.

        Args:
          pack: the sync pack (reference shape + placements).
          q_coords/k_coords: sequences of per-dimension *order coordinate*
            arrays (broadcastable against each other, e.g. q as column and
            k as row vectors).
          q_flat/k_flat: flattened-order arrays, same broadcast layout.

        Returns a boolean array broadcast of ``q_flat``/``k_flat``.
        """
        raise NotImplementedError

    def tile_live(
        self,
        pack: SyncPack,
        q_coord_lo: Sequence[int],
        q_coord_hi: Sequence[int],
        k_coord_lo,
        k_coord_hi,
        q_flat_lo,
        q_flat_hi,
        k_flat_lo,
        k_flat_hi,
    ):
        """Conservative tile liveness (vectorised over k tiles).

        ``q_*`` describe one q tile (scalars per dim); ``k_*`` may be NumPy
        arrays over many k tiles.  Returns a boolean (array) that is True
        whenever the tile *may* contain a visible element.
        """
        raise NotImplementedError

    def tile_fully_visible(
        self,
        pack: SyncPack,
        q_coord_lo,
        q_coord_hi,
        k_coord_lo,
        k_coord_hi,
        q_flat_lo,
        q_flat_hi,
        k_flat_lo,
        k_flat_hi,
    ):
        """Conservative "every element visible" test (vectorised over k tiles).

        True only when *all* (q, k) pairs in the tile provably satisfy the
        rule — such tiles skip mask construction inside the kernels
        entirely (a fast path the CUDA reference does not have: it runs
        ``Check`` per element on every live tile).  Must only ever
        under-approximate; False just means "build the mask".
        """
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FullRule(MaskRule):
    """No masking (``FullAttentionPolicy``, ``flash_attention.h:45-61``)."""

    is_full: bool = dataclasses.field(default=True, init=False)

    def check(self, pack, q_coords, k_coords, q_flat, k_flat):
        return (q_flat - q_flat + (k_flat - k_flat)) == 0  # all-True, backend-agnostic

    def tile_live(self, pack, q_coord_lo, q_coord_hi, k_coord_lo, k_coord_hi,
                  q_flat_lo, q_flat_hi, k_flat_lo, k_flat_hi):
        return k_flat_lo == k_flat_lo  # all-True

    def tile_fully_visible(self, pack, q_coord_lo, q_coord_hi, k_coord_lo,
                           k_coord_hi, q_flat_lo, q_flat_hi, k_flat_lo, k_flat_hi):
        return k_flat_lo == k_flat_lo  # all-True


@dataclasses.dataclass(frozen=True)
class CausalRule(MaskRule):
    """Flattened-order causality (``CausalAttentionPolicy``, ``flash_attention.h:64-80``)."""

    def check(self, pack, q_coords, k_coords, q_flat, k_flat):
        return q_flat >= k_flat

    def tile_live(self, pack, q_coord_lo, q_coord_hi, k_coord_lo, k_coord_hi,
                  q_flat_lo, q_flat_hi, k_flat_lo, k_flat_hi):
        # IsSkipped: max_Q_order < min_K_order  =>  live iff the opposite.
        return k_flat_lo <= q_flat_hi

    def tile_fully_visible(self, pack, q_coord_lo, q_coord_hi, k_coord_lo,
                           k_coord_hi, q_flat_lo, q_flat_hi, k_flat_lo, k_flat_hi):
        # every q order >= every k order
        return k_flat_hi <= q_flat_lo


@dataclasses.dataclass(frozen=True)
class LocalRule(MaskRule):
    """Windowed local attention with power-of-two stride
    (``LocalAttentionPolicy``, ``flash_attention.h:82-149``)."""

    window_size: int
    log2_stride_size: int = 0
    is_causal: bool = False

    def __post_init__(self):
        if self.window_size < 1:
            raise ValueError(f"window_size must be >= 1, got {self.window_size}")
        if not (0 <= self.log2_stride_size < 31):
            raise ValueError(
                f"log2_stride_size must be in [0, 31), got {self.log2_stride_size}"
            )
        if (self.window_size << self.log2_stride_size) < self.window_size:
            raise ValueError("strided window overflows int32")

    @property
    def strided_window_size(self) -> int:
        return self.window_size << self.log2_stride_size

    @property
    def remainder_mask(self) -> int:
        return (1 << self.log2_stride_size) - 1

    def check(self, pack, q_coords, k_coords, q_flat, k_flat):
        ok = None
        for qc, kc in zip(q_coords, k_coords):
            diff = abs(qc - kc)
            dim_ok = (diff >> self.log2_stride_size) < self.window_size
            if self.log2_stride_size:
                dim_ok = dim_ok & ((diff & self.remainder_mask) == 0)
            ok = dim_ok if ok is None else (ok & dim_ok)
        if self.is_causal:
            ok = ok & (q_flat >= k_flat)
        return ok

    def tile_live(self, pack, q_coord_lo, q_coord_hi, k_coord_lo, k_coord_hi,
                  q_flat_lo, q_flat_hi, k_flat_lo, k_flat_hi):
        sw = self.strided_window_size
        live = None
        for d in range(pack.ndim):
            # Per-dim symmetric window: a visible pair needs |qc-kc| <= sw-1,
            # so the k interval must overlap [q_lo - (sw-1), q_hi + (sw-1)].
            dim_live = (k_coord_hi[d] >= q_coord_lo[d] - (sw - 1)) & (
                k_coord_lo[d] <= q_coord_hi[d] + (sw - 1)
            )
            live = dim_live if live is None else (live & dim_live)
        if self.is_causal:
            live = live & (k_flat_lo <= q_flat_hi)
        return live

    def tile_fully_visible(self, pack, q_coord_lo, q_coord_hi, k_coord_lo,
                           k_coord_hi, q_flat_lo, q_flat_hi, k_flat_lo, k_flat_hi):
        if self.log2_stride_size:
            # stride divisibility can never hold for every pair in a tile
            # spanning more than one coordinate
            return k_flat_lo != k_flat_lo  # all-False
        sw = self.strided_window_size
        full = None
        for d in range(pack.ndim):
            # every pair in-window: |qc-kc| <= sw-1 for ALL q,k in the tile
            dim_full = (k_coord_lo[d] >= q_coord_hi[d] - (sw - 1)) & (
                k_coord_hi[d] <= q_coord_lo[d] + (sw - 1)
            )
            full = dim_full if full is None else (full & dim_full)
        if self.is_causal:
            full = full & (k_flat_hi <= q_flat_lo)
        return full


def make_rule(kind: str, **kwargs) -> MaskRule:
    """Factory mirroring the reference's op families."""
    if kind == "full":
        return FullRule()
    if kind == "causal":
        return CausalRule()
    if kind == "local":
        return LocalRule(**kwargs)
    raise ValueError(f"unknown mask rule {kind!r}")
