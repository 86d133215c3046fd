"""Trace-time block-skip schedule builder.

A carried copy of ``tf_flash_attention_tpu/schedule.py`` (numpy only),
kept for the same reason as ``mask_rules.py``; ``tests/test_torch_host.py``
holds it equal to the original.  As in the JAX package, ``build_schedule``
classifies tiles with the C++ host classifier (the port's copy of
``csrc/fa_native.cc``, through ``native.native_tile_classes``) by default;
the NumPy classifier below is the spec, and runs where the classifier
returns ``None`` (a custom rule, ``FA_NO_NATIVE``) or with
``use_native=False``.

The reference prunes masked-out (q-tile, kv-tile) pairs *inside* the CUDA
kernel (``IsSkipped`` call sites, ``flash_attention.cu:865-871`` forward,
``:1731-1737`` backward).  Pallas grids are static, so the TPU-native design
moves the pruning to trace time: for every q block we precompute the list of
*live* kv blocks and feed it to the kernel as a scalar-prefetch index table
(``PrefetchScalarGridSpec``).  Dead tiles are then **never even loaded from
HBM** — strictly better than the reference, which still runs the skip test
per tile on device.

Beyond liveness, tiles are classified as *interior* (provably every element
visible and in-bounds — the kernel skips mask construction entirely, pure
MXU + softmax) vs *partial* (the kernel builds the element mask).  The CUDA
reference has no such fast path: it evaluates ``Check`` per element on every
live tile (``flash_attention.cu:915-947``).

Shapes are static under ``jit``; everything here is NumPy executed once per
compiled specialisation (and cached).  ``live`` is shared with the analytic
FLOPs estimator so the cost model honours the same skip schedule as the
kernels, mirroring the contract of the reference estimator
(``flash_attention.cu:2069-2144``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

from .mask_rules import MaskRule
from .sync_modes import SyncPack, SeqDescriptor, flatten_orders, order_coords

__all__ = ["Schedule", "build_schedule", "delta_mask_table",
           "window_band_table", "window_band_table_t",
           "sequence_orders", "tile_order_bounds"]


def sequence_orders(pack_desc: SeqDescriptor, reference_shape) -> Tuple[np.ndarray, np.ndarray]:
    """Per-position order info for a row-major-flattened sequence.

    Returns ``(coords, flat)`` where ``coords`` has shape ``(ndim, length)``
    with the per-dimension order coordinates of every flattened position,
    and ``flat`` has shape ``(length,)`` with the flattened reference-grid
    orders.  ``length = prod(desc.shape)``.
    """
    per_dim = order_coords(pack_desc)
    length = int(np.prod(pack_desc.shape))
    idx = np.unravel_index(np.arange(length, dtype=np.int64), pack_desc.shape)
    coords = np.stack([per_dim[d][idx[d]] for d in range(pack_desc.ndim)], axis=0)
    flat = flatten_orders(reference_shape, per_dim)[idx]
    return coords.astype(np.int32), np.asarray(flat, dtype=np.int32).reshape(-1)


def tile_order_bounds(coords: np.ndarray, flat: np.ndarray, block: int):
    """Exact per-tile min/max of per-dim coords and flattened orders.

    The trailing partial tile is reduced over its valid entries only.
    Returns ``(coord_lo, coord_hi, flat_lo, flat_hi)`` with shapes
    ``(ndim, n_tiles)`` / ``(n_tiles,)``.
    """
    ndim, length = coords.shape
    n_tiles = -(-length // block)
    pad = n_tiles * block - length
    if pad:
        coords = np.concatenate([coords, np.repeat(coords[:, -1:], pad, axis=1)], axis=1)
        flat = np.concatenate([flat, np.repeat(flat[-1:], pad)])
    coords = coords.reshape(ndim, n_tiles, block)
    flat = flat.reshape(n_tiles, block)
    return (
        coords.min(axis=2),
        coords.max(axis=2),
        flat.min(axis=1),
        flat.max(axis=1),
    )


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per-q-block live-kv-block schedule with interior/partial classing.

    ``kv_table[qi, step]`` is the kv-block index to visit at ``step`` while
    processing q block ``qi``; only the first ``kv_counts[qi]`` steps are
    real (the rest repeat the last live block and are masked off in-kernel).
    ``needs_mask[qi, step]`` is 1 when the visited tile requires the
    in-kernel element mask (partial visibility or sequence-padding edge),
    0 when it is provably fully visible and in-bounds.
    ``num_steps = kv_table.shape[1]`` is the static inner grid size.

    When built with compute sub-tiling (``q_compute``/``kv_compute`` finer
    than the block sizes), ``sub_live``/``sub_needs`` carry the same two
    classifications at *sub-tile* granularity as packed bitmask words of
    shape ``(num_rows, num_steps, n_words)``: bit ``jq·rk + j`` of the
    flattened word array describes sub-tile ``(jq, j)`` of the visited
    tile (``rq = block_q // q_compute``, ``rk = block_kv // kv_compute``;
    ``sub_shape = (rq, rk)``).  The kernels use these to skip masked-out
    *sub*-tiles of a live tile — the diagonal of a causal mask at large
    block sizes stops being scheduled as dense work (the reference pays
    that waste: its per-element ``Check`` runs over every live tile,
    ``flash_attention.cu:915-947``).
    """

    kv_table: np.ndarray    # (num_rows, num_steps) int32
    kv_counts: np.ndarray   # (num_rows,) int32
    needs_mask: np.ndarray  # (num_rows, num_steps) int32 (0/1)
    live: np.ndarray        # (num_rows, num_cols) bool
    partial: np.ndarray     # (num_rows, num_cols) bool
    sub_live: np.ndarray | None = None   # (num_rows, num_steps, W) int32
    sub_needs: np.ndarray | None = None  # (num_rows, num_steps, W) int32
    sub_shape: Tuple[int, int] = (1, 1)  # (rq, rk)
    fine_live: np.ndarray | None = None     # fine-granularity classes
    fine_partial: np.ndarray | None = None  # (for .transpose())

    @property
    def num_q_blocks(self) -> int:
        return self.kv_table.shape[0]

    @property
    def num_steps(self) -> int:
        return self.kv_table.shape[1]

    @property
    def num_kv_blocks(self) -> int:
        return self.live.shape[1]

    def transpose(self) -> "Schedule":
        """Schedule for the dK/dV backward kernel: live q blocks per kv block."""
        if self.sub_live is not None:
            rq, rk = self.sub_shape
            return _pack_live(
                self.live.T, self.partial.T,
                fine=(self.fine_live.T, self.fine_partial.T, rk, rq))
        return _pack_live(self.live.T, self.partial.T)

    def banded_segments(self) -> "np.ndarray | None":
        """Per-row ``[start, interior_start, interior_end, end)`` bounds.

        Returns an ``(num_rows, 4)`` int32 array when every row's live set
        is a contiguous band of blocks whose interior (mask-free) tiles
        form one contiguous run flanked by partial tiles — the shape of
        every causal/local/full schedule (strided-local rules produce
        non-contiguous live sets and return ``None``).  This feeds the
        banded resident-KV kernel, whose kv loop is an in-kernel
        ``fori_loop`` over these bounds instead of a grid axis.
        """
        n_rows = self.live.shape[0]
        seg = np.zeros((n_rows, 4), dtype=np.int32)
        for r in range(n_rows):
            idx = np.flatnonzero(self.live[r])
            if idx.size == 0:
                continue
            start, end = int(idx[0]), int(idx[-1]) + 1
            if idx.size != end - start:
                return None  # hole in the live band
            part = self.partial[r, start:end]
            interior = np.flatnonzero(~part)
            if interior.size == 0:
                i0 = i1 = start
            else:
                i0 = start + int(interior[0])
                i1 = start + int(interior[-1]) + 1
                if interior.size != i1 - i0:
                    return None  # interleaved partial/interior tiles
            if not (part[: i0 - start].all() and part[i1 - start:].all()):
                return None
            seg[r] = (start, i0, i1, end)
        return seg


def _pack_sub_words(fine: np.ndarray, table: np.ndarray, counts: np.ndarray,
                    rq: int, rk: int) -> np.ndarray:
    """Pack fine-granularity booleans into per-(row, step) bitmask words.

    ``fine`` is ``(n_rows·rq, n_cols·rk)`` bool (already padded); returns
    ``(n_rows, num_steps, W)`` int32 with bit ``jq·rk + j`` of the
    flattened 32-bit word stream set from ``fine[r·rq+jq, kb·rk+j]``.
    """
    n_rows, num_steps = table.shape
    n_bits = rq * rk
    n_words = -(-n_bits // 32)
    words = np.zeros((n_rows, num_steps, n_words), dtype=np.int64)
    for r in range(n_rows):
        for s in range(int(counts[r])):
            kb = table[r, s]
            block = fine[r * rq:(r + 1) * rq, kb * rk:(kb + 1) * rk]
            bits = np.flatnonzero(block.reshape(-1))
            for b in bits:
                words[r, s, b // 32] |= np.int64(1) << np.int64(b % 32)
    # int32 view keeps the scalar-prefetch dtype; bit 31 lands in the sign
    # bit, which the kernels only ever touch with shift+and.
    return words.astype(np.uint32).view(np.int32).reshape(
        n_rows, num_steps, n_words)


def _pack_live(live: np.ndarray, partial: np.ndarray, fine=None) -> Schedule:
    n_rows, _ = live.shape
    counts = live.sum(axis=1).astype(np.int32)
    num_steps = max(1, int(counts.max()) if n_rows else 1)
    table = np.zeros((n_rows, num_steps), dtype=np.int32)
    needs = np.ones((n_rows, num_steps), dtype=np.int32)
    for r in range(n_rows):
        idx = np.flatnonzero(live[r])
        if idx.size:
            table[r, : idx.size] = idx
            table[r, idx.size :] = idx[-1]
            needs[r, : idx.size] = partial[r, idx]
    if fine is None:
        return Schedule(kv_table=table, kv_counts=counts, needs_mask=needs,
                        live=live, partial=partial)
    fine_live, fine_partial, rq, rk = fine
    return Schedule(
        kv_table=table, kv_counts=counts, needs_mask=needs,
        live=live, partial=partial,
        sub_live=_pack_sub_words(fine_live, table, counts, rq, rk),
        sub_needs=_pack_sub_words(fine_live & fine_partial, table, counts,
                                  rq, rk),
        sub_shape=(rq, rk),
        fine_live=fine_live, fine_partial=fine_partial,
    )


@functools.lru_cache(maxsize=128)
def delta_mask_table(pack: SyncPack, rule: MaskRule, block_q: int,
                     block_kv: int, q_len: int, k_len: int,
                     q_pad: int, k_pad: int, max_masks: int = 8,
                     max_bytes: int = 4 << 20):
    """Deduplicated per-tile boolean masks for the partial tiles of a
    schedule, or ``None`` when the pattern doesn't repeat.

    Round-5 kernel optimisation: in-kernel mask construction costs ~9
    VPU int32 ops per scores element (coords + per-dim window checks +
    causality), which for rules where every live tile is partial (2d
    local windows) rivals the MXU time of the tile itself — measured as
    the gap between the local_2d and causal_2d scheduled rates
    (tools/exp_2d_sweep.py: 85 vs 118 TFLOP/s same tiles).  But masking
    rules are translation-structured: the mask PATTERN of a tile at
    block offsets ``(qi·bq, j·bk)`` depends only on the offset
    difference whenever the block sizes are multiples of the inner
    sequence width — e.g. the causal diagonal is ONE pattern, and the
    2d local w=8 band at (1024, 1024) has exactly two.  This function
    discovers that empirically (no invariance analysis): it evaluates
    every live partial tile's mask at trace time with the same
    primitives as the in-kernel ``build_tile_mask`` (rule predicate on
    order coordinates + sequence-padding bounds), dedupes tiles by
    content, and returns

      ``(slots, masks)`` — ``slots: (n_q, n_k) int32`` mapping each
      partial tile to its mask id (-1 elsewhere), ``masks: (n, bq, bk)
      int8`` the distinct patterns —

    for the kernels to keep resident in VMEM and select per tile (2 VPU
    ops per element instead of ~9).  Returns ``None`` when more than
    ``max_masks`` distinct patterns appear (non-repeating structure,
    e.g. shifted sync descriptors) or the mask bytes exceed
    ``max_bytes``.
    """
    sched = build_schedule(pack, rule, block_q, block_kv)
    if not sched.partial.any():
        return None
    if max_masks * block_q * block_kv > max_bytes:
        max_masks = max(1, max_bytes // (block_q * block_kv))
    q_coords, q_flat = sequence_orders(pack.q, pack.reference_shape)
    k_coords, k_flat = sequence_orders(pack.k, pack.reference_shape)

    def pad_tail(arr, length):
        # values past the sequence are gated off by the bounds term below;
        # repeating the final entry just keeps the rule arithmetic in range
        if arr.shape[-1] >= length:
            return arr
        reps = length - arr.shape[-1]
        return np.concatenate([arr, np.repeat(arr[..., -1:], reps, -1)], -1)

    q_coords = pad_tail(q_coords, q_pad)
    k_coords = pad_tail(k_coords, k_pad)
    q_flat = pad_tail(q_flat, q_pad)
    k_flat = pad_tail(k_flat, k_pad)

    n_q, n_k = sched.live.shape
    slots = np.full((n_q, n_k), -1, np.int32)
    masks = []
    index = {}
    partial = sched.live & sched.partial
    for qi, kb in zip(*np.nonzero(partial)):
        qs = slice(qi * block_q, (qi + 1) * block_q)
        ks = slice(kb * block_kv, (kb + 1) * block_kv)
        m = rule.check(
            pack,
            [c[qs][:, None] for c in q_coords],
            [c[ks][None, :] for c in k_coords],
            q_flat[qs][:, None],
            k_flat[ks][None, :],
        )
        m = np.broadcast_to(np.asarray(m, bool), (block_q, block_kv)).copy()
        if q_pad > q_len:
            m[max(0, q_len - qi * block_q):, :] = False
        if k_pad > k_len:
            m[:, max(0, k_len - kb * block_kv):] = False
        key = m.tobytes()
        slot = index.get(key)
        if slot is None:
            if len(masks) >= max_masks:
                return None
            slot = index[key] = len(masks)
            masks.append(m)
        slots[qi, kb] = slot
    return slots, np.stack(masks).astype(np.int8)


@functools.lru_cache(maxsize=128)
def window_band_table(pack: SyncPack, rule: MaskRule, block_q: int,
                      q_len: int, k_len: int, q_pad: int, k_pad: int,
                      lane: int = 128, max_waste: float = 1.35,
                      scores_budget: int = 8 << 20,
                      max_masks: int = 8, mask_bytes: int = 4 << 20):
    """Single-window schedule for narrow-band rules, or ``None``.

    Round-5 kernel optimisation (VERDICT r4 item 3 — the 2d/narrow-band
    tile-granularity waste).  For rules whose live kv set per q block is
    one contiguous band at *lane* (128-column) granularity — 2d local
    windows, 1d local windows, full — the whole band fits a SINGLE
    dynamic-start fixed-width kv window: the kernel then runs ONE
    Q·K^T/P·V matmul pair per q block over exactly the live 128-column
    groups and the online-merge chain (the per-kv-step cost that made
    small ``block_kv`` tiles lose, docs/TUNING.md round 4) disappears
    entirely.  This is the dense-packing remedy for the measured 3x
    narrow-band scheduling waste: waste is priced here against the
    128x128 fine schedule (the config-independent pricing granularity),
    and the table refuses (returns ``None``) when the fixed window would
    re-introduce more than ``max_waste`` of it (e.g. 1d causal, whose
    band width varies 0..k_len — the banded fori-loop kernel keeps that
    case).

    Returns ``(starts, W, slots, masks)``:

    * ``starts: (n_q,) int32`` — per-q-block first live kv column,
      lane-aligned and clamped to ``k_pad - W``;
    * ``W: int`` — static window width (lane multiple, max band width);
    * ``slots: (n_q,) int32`` + ``masks: (n, block_q, W) int8`` — the
      per-block deduplicated window masks (delta-mask style; bounds
      folded in), or ``(None, None)`` when every element of every
      window is live (full rule, no padding: no masking needed).

    Falls back to ``None`` (table/banded kernels) when the band has
    holes at lane granularity, the waste bound fails, the f32 scores
    tile ``block_q x W`` exceeds ``scores_budget``, or the mask patterns
    don't dedupe within ``max_masks``/``mask_bytes`` (mask selection is
    the whole point — an arithmetic mask over the full window would pay
    the ~9 VPU ops/element the delta masks exist to remove).
    """
    if rule.is_full:
        # Measured negative (tools/exp_window_sweep.py round 5: 128 vs
        # 135 TFLOP/s-128 at S=4096): full rules have no band waste to
        # save, and the banded kernel's kv loop pipelines better than
        # one full-width window.
        return None
    sched = build_schedule(pack, rule, block_q, lane)
    live = sched.live  # (ceil(q_len / block_q), k_pad // lane)
    # The caller's q padding may be coarser than block_q (sub-block
    # tables under a larger grid block): emit one row per PADDED block,
    # with trailing/empty rows dead (all-False mask -> dead-row repair).
    n_q = q_pad // block_q
    starts_b = np.zeros(n_q, np.int32)
    width_max = 0
    live_cols = 0
    live_rows = 0
    for r in range(min(n_q, live.shape[0])):
        idx = np.flatnonzero(live[r])
        if idx.size == 0:
            continue
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        if idx.size != hi - lo:
            return None  # hole in the fine band (e.g. wide-strided rules)
        starts_b[r] = lo
        width_max = max(width_max, hi - lo)
        live_cols += idx.size
        live_rows += 1
    if width_max == 0:
        return None
    # Waste against the 128x128 pricing granularity: the window is
    # per-q-BLOCK, the pricing per-q-128-row, so large block_q widens W
    # past what the fine schedule prices (the solver prefers small
    # block_q here for exactly that reason).
    fine = build_schedule(pack, rule, lane, lane) if block_q != lane else sched
    priced_area = int(fine.live.sum()) * lane * lane
    sched_area = live_rows * block_q * width_max * lane
    if priced_area == 0 or sched_area > max_waste * priced_area:
        return None
    if block_q * width_max * lane * 4 > scores_budget:
        return None
    W = width_max * lane
    starts_b = np.minimum(starts_b, k_pad // lane - width_max)
    starts = (starts_b * lane).astype(np.int32)

    # Per-block window masks, deduped (delta_mask_table's scheme over
    # lane-granular bands instead of block_kv tiles).
    q_coords, q_flat = sequence_orders(pack.q, pack.reference_shape)
    k_coords, k_flat = sequence_orders(pack.k, pack.reference_shape)

    def pad_tail(arr, length):
        if arr.shape[-1] >= length:
            return arr
        reps = length - arr.shape[-1]
        return np.concatenate([arr, np.repeat(arr[..., -1:], reps, -1)], -1)

    q_coords = [pad_tail(c, q_pad) for c in q_coords]
    k_coords = [pad_tail(c, k_pad) for c in k_coords]
    q_flat = pad_tail(q_flat, q_pad)
    k_flat = pad_tail(k_flat, k_pad)

    slots = np.zeros(n_q, np.int32)
    masks = []
    index = {}
    any_masked = False
    for r in range(n_q):
        dead = (r >= live.shape[0]
                or not live[r].any())
        qs = slice(r * block_q, (r + 1) * block_q)
        ks = slice(int(starts[r]), int(starts[r]) + W)
        if dead:
            m = np.zeros((block_q, W), bool)
        elif rule.is_full:
            m = np.ones((block_q, W), bool)
        else:
            m = rule.check(
                pack,
                [c[qs][:, None] for c in q_coords],
                [c[ks][None, :] for c in k_coords],
                q_flat[qs][:, None],
                k_flat[ks][None, :],
            )
            m = np.broadcast_to(np.asarray(m, bool), (block_q, W)).copy()
        if not dead and q_pad > q_len:
            m[max(0, q_len - r * block_q):, :] = False
        if not dead and k_pad > k_len:
            kept = max(0, k_len - int(starts[r]))
            m[:, kept:] = False
        if not m.all():
            any_masked = True
        key = m.tobytes()
        slot = index.get(key)
        if slot is None:
            if len(masks) >= max_masks or \
                    (len(masks) + 1) * block_q * W > mask_bytes:
                return None
            slot = index[key] = len(masks)
            masks.append(m)
        slots[r] = slot
    if not any_masked:
        return starts, W, None, None
    return starts, W, slots, np.stack(masks).astype(np.int8)


@functools.lru_cache(maxsize=128)
def window_band_table_t(pack: SyncPack, rule: MaskRule, block_kv: int,
                        q_len: int, k_len: int, q_pad: int, k_pad: int,
                        lane: int = 128, max_waste: float = 1.35,
                        scores_budget: int = 8 << 20,
                        max_masks: int = 8, mask_bytes: int = 4 << 20):
    """Transposed single-window schedule: per-KV-block contiguous Q band.

    The backward twin of ``window_band_table`` (kv-outer kernels walk q
    bands per kv block): returns ``(starts, W, slots, masks)`` with
    ``starts: (n_kv,) int32`` lane-aligned first live *q* column per kv
    sub-block, ``W`` the static q-band width, and deduplicated masks of
    shape ``(n, W, block_kv)`` oriented (q rows, kv cols) to apply
    directly to the recomputed ``P`` tile.  Same eligibility rules
    (contiguity at lane granularity, waste priced against the 128x128
    fine schedule, mask dedup budget); refuses full rules and wide-
    variance bands.  Unlike the forward table a ``(None, None)`` mask
    pair is never returned — kv-outer consumers always mask (padding
    q rows inside the band would otherwise recompute garbage P).
    """
    if rule.is_full:
        return None
    sched = build_schedule(pack, rule, lane, block_kv)
    live = sched.live.T  # (ceil(k_len / block_kv), ceil(q_len / lane))
    n_kv = k_pad // block_kv
    starts_b = np.zeros(n_kv, np.int32)
    width_max = 0
    live_rows = 0
    for r in range(min(n_kv, live.shape[0])):
        idx = np.flatnonzero(live[r])
        if idx.size == 0:
            continue
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        if idx.size != hi - lo:
            return None
        starts_b[r] = lo
        width_max = max(width_max, hi - lo)
        live_rows += 1
    if width_max == 0:
        return None
    fine = build_schedule(pack, rule, lane, lane)
    priced_area = int(fine.live.sum()) * lane * lane
    sched_area = live_rows * block_kv * width_max * lane
    if priced_area == 0 or sched_area > max_waste * priced_area:
        return None
    if block_kv * width_max * lane * 4 > scores_budget:
        return None
    W = width_max * lane
    starts_b = np.minimum(starts_b, q_pad // lane - width_max)
    starts = (starts_b * lane).astype(np.int32)

    q_coords, q_flat = sequence_orders(pack.q, pack.reference_shape)
    k_coords, k_flat = sequence_orders(pack.k, pack.reference_shape)

    def pad_tail(arr, length):
        if arr.shape[-1] >= length:
            return arr
        reps = length - arr.shape[-1]
        return np.concatenate([arr, np.repeat(arr[..., -1:], reps, -1)], -1)

    q_coords = [pad_tail(c, q_pad) for c in q_coords]
    k_coords = [pad_tail(c, k_pad) for c in k_coords]
    q_flat = pad_tail(q_flat, q_pad)
    k_flat = pad_tail(k_flat, k_pad)

    slots = np.zeros(n_kv, np.int32)
    masks = []
    index = {}
    for r in range(n_kv):
        dead = (r >= live.shape[0] or not live[r].any())
        qs = slice(int(starts[r]), int(starts[r]) + W)
        ks = slice(r * block_kv, (r + 1) * block_kv)
        if dead:
            m = np.zeros((W, block_kv), bool)
        else:
            m = rule.check(
                pack,
                [c[qs][:, None] for c in q_coords],
                [c[ks][None, :] for c in k_coords],
                q_flat[qs][:, None],
                k_flat[ks][None, :],
            )
            m = np.broadcast_to(np.asarray(m, bool), (W, block_kv)).copy()
            if q_pad > q_len:
                kept = max(0, q_len - int(starts[r]))
                m[kept:, :] = False
            if k_pad > k_len:
                m[:, max(0, k_len - r * block_kv):] = False
        key = m.tobytes()
        slot = index.get(key)
        if slot is None:
            if len(masks) >= max_masks or \
                    (len(masks) + 1) * W * block_kv > mask_bytes:
                return None
            slot = index[key] = len(masks)
            masks.append(m)
        slots[r] = slot
    return starts, W, slots, np.stack(masks).astype(np.int8)


def _tile_classes_python(pack: SyncPack, rule: MaskRule, block_q: int, block_kv: int):
    q_coords, q_flat = sequence_orders(pack.q, pack.reference_shape)
    k_coords, k_flat = sequence_orders(pack.k, pack.reference_shape)
    q_len, k_len = q_flat.size, k_flat.size

    q_lo, q_hi, qf_lo, qf_hi = tile_order_bounds(q_coords, q_flat, block_q)
    k_lo, k_hi, kf_lo, kf_hi = tile_order_bounds(k_coords, k_flat, block_kv)

    n_q = q_lo.shape[1]
    n_k = k_lo.shape[1]
    live = np.empty((n_q, n_k), dtype=bool)
    full = np.empty((n_q, n_k), dtype=bool)
    for qi in range(n_q):
        args = (
            pack,
            q_lo[:, qi], q_hi[:, qi],
            k_lo, k_hi,
            qf_lo[qi], qf_hi[qi],
            kf_lo, kf_hi,
        )
        live[qi] = np.asarray(rule.tile_live(*args))
        full[qi] = np.asarray(rule.tile_fully_visible(*args))

    # Sequence-padding edges always need the bounds mask.
    if q_len % block_q:
        full[-1, :] = False
    if k_len % block_kv:
        full[:, -1] = False
    return live, live & ~full


def _classes(pack, rule, block_q, block_kv, use_native):
    if use_native:
        from .native import native_tile_classes
        classes = native_tile_classes(pack, rule, block_q, block_kv)
        if classes is not None:
            return classes
    return _tile_classes_python(pack, rule, block_q, block_kv)


@functools.lru_cache(maxsize=512)
def _build_schedule_cached(pack: SyncPack, rule: MaskRule, block_q: int, block_kv: int,
                           use_native: bool, q_compute: int, kv_compute: int) -> Schedule:
    if q_compute == block_q and kv_compute == block_kv:
        live, partial = _classes(pack, rule, block_q, block_kv, use_native)
        return _pack_live(live, partial)

    # Sub-tiled build: classify at the fine (q_compute, kv_compute)
    # granularity and aggregate.  A coarse tile is live iff any sub-tile
    # is; it takes the interior (maskless, no-bitmask) fast path only when
    # every sub-tile is live and fully visible.
    rq = block_q // q_compute
    rk = block_kv // kv_compute
    fine_live, fine_partial = _classes(pack, rule, q_compute, kv_compute,
                                       use_native)
    q_len = int(np.prod(pack.q.shape))
    k_len = int(np.prod(pack.k.shape))
    n_q = -(-q_len // block_q)
    n_k = -(-k_len // block_kv)
    padded_l = np.zeros((n_q * rq, n_k * rk), dtype=bool)
    padded_p = np.zeros_like(padded_l)
    padded_l[: fine_live.shape[0], : fine_live.shape[1]] = fine_live
    padded_p[: fine_partial.shape[0], : fine_partial.shape[1]] = fine_partial
    grp_l = padded_l.reshape(n_q, rq, n_k, rk)
    grp_p = padded_p.reshape(n_q, rq, n_k, rk)
    live = grp_l.any(axis=(1, 3))
    full = grp_l.all(axis=(1, 3)) & ~grp_p.any(axis=(1, 3))
    return _pack_live(live, live & ~full,
                      fine=(padded_l, padded_p, rq, rk))


def build_schedule(pack: SyncPack, rule: MaskRule, block_q: int, block_kv: int,
                   use_native: bool = True, q_compute: int | None = None,
                   kv_compute: int | None = None) -> Schedule:
    """Build (and cache) the live-block schedule for a (pack, rule, tiling).

    Uses the native C++ classifier (``csrc/fa_native.cc``) when available;
    the NumPy implementation is the fallback and behavioural spec.
    ``q_compute``/``kv_compute`` (dividing the block sizes) additionally
    classify at sub-tile granularity for in-kernel sub-tile skipping.
    """
    q_compute = int(q_compute or block_q)
    kv_compute = int(kv_compute or block_kv)
    if block_q % q_compute or block_kv % kv_compute:
        raise ValueError("compute sizes must divide block sizes")
    return _build_schedule_cached(pack, rule, int(block_q), int(block_kv),
                                  bool(use_native), q_compute, kv_compute)
