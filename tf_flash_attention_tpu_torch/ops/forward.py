"""Flash-attention forward (PyTorch port of ``ops/forward.py``).

``flash_forward`` folds ``scale·log2e`` into Q, picks the kernel the JAX
package would run for the schedule (``forward_route``), and launches its
hand-written CUDA counterpart for tensors on the card; tensors on the CPU
take the plain PyTorch version ``_flash_forward_plain``, which all four
kernels share: they compute one function.  Grouped-query attention maps
query row ``b`` to kv row ``b // g``.  The kernels pad nothing in memory:
rows past ``q_len``/``k_len`` are zero-filled as they are staged.

Routes, in the JAX package's order (``forward.py:346-467``), each with the
package's own environment switch:

* ``window_fwd`` (``FA_WINDOW``) — narrow-band rules whose live keys per
  query sub-block are one lane-aligned band (``window_band_table``); here
  also the band's float32 scores must fit shared memory (the scalar body's
  closed form holds them; the bf16/fp16 tensor-core walk, which merges
  online, would not need it, but the route stays the package's);
* ``banded_fwd`` (``FA_BANDED``) — every schedule row one contiguous band
  with one interior run (``Schedule.banded_segments``): causal, unstrided
  local, full; with ``FA_RESIDENT=1`` (opt-in, as in the package) its
  one-CTA-per-row variant ``resident_fwd``;
* ``flash_fwd`` — the table kernel, the spec: strided rules, and any
  explicit compute sub-tiling (``block_q_compute``/``block_kv_compute``),
  which in both packages selects the table kernel and nothing else.

The TPU routes also require K/V (and, for the resident kernel, Q and O)
to fit VMEM residency budgets; those have no counterpart on the card and
are not applied.  Inputs of 1-byte float types compute in bf16, as in the
JAX package; fp16 runs natively (its bf16 detour is TPU-only).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Optional

import numpy as np
import torch

from .. import native
from ..block_sizes import LANE, BlockConfig, pad_to
from ..mask_rules import MaskRule
from ..schedule import build_schedule, window_band_table
from ..sync_modes import SyncPack
from .kernel_common import INV_LOG2E, LOG2E, NEG_INF_F32, build_tile_mask

__all__ = ["flash_forward", "forward_route", "Route", "window_segments"]


def env_on(name: str) -> bool:
    """The JAX package's route switches: on unless set to ``"0"``."""
    return os.environ.get(name, "1") != "0"


@dataclasses.dataclass(frozen=True, eq=False)
class Route:
    """One kernel launch of a schedule: the kernel's ``LAUNCHES`` name, its
    blocks, the int32 tables it walks (numpy; the window kernels' band starts
    and ``window_segments``), and for the window kernels the band width, the
    sub-block and whether any element is masked."""

    kernel: str
    block_q: int
    block_kv: int
    arrays: tuple
    band: int = 0
    sub: int = 0
    masked: bool = True

    def tables(self, pack: SyncPack, rule: MaskRule, device) -> tuple:
        key = (pack, rule, self.kernel, self.block_q, self.block_kv, self.band, self.sub)
        return native.device_tables(key, self.arrays, device)


def pick_window(table_fn, subs, block: int, pad: int):
    """The JAX package's choice among the band tables of the sub-blocks
    ``subs`` that divide ``block``: the largest sub-block within 30% of the
    smallest scheduled area (``forward.py:378-389``).  Returns ``(sub,
    table)`` or ``None``."""
    cands = []
    for sub in subs:
        if sub > block or block % sub:
            continue
        wt = table_fn(sub)
        if wt is not None:
            cands.append((sub, wt, pad * wt[1]))
    if not cands:
        return None
    amin = min(c[2] for c in cands)
    sub, wt, _ = next(c for c in cands if c[2] <= 1.30 * amin)
    return sub, wt


def window_segments(pack: SyncPack, rule: MaskRule, starts, band: int, sub: int,
                    transposed: bool = False) -> np.ndarray:
    """A window walk as the tensor-core bodies take it, the banded walk over
    blocks of 128: for each 128-row tile of the walking sequence (queries;
    keys where ``transposed``), ``[start, i0, i1, end)`` in blocks of 128 of
    the other sequence: the live blocks of its sub-block's band
    ``[starts[tile * 128 // sub], + band)`` (the 128 x 128 fine schedule's;
    a block with no visible element adds nothing, and walking it would
    lengthen the tile's item), and inside them the longest run of interior
    blocks (every element visible and in bounds: run on the body compiled
    without the rule predicate), or an empty ``[start, start)``.
    ``(tiles, 4)`` int32."""
    fine = build_schedule(pack, rule, LANE, LANE)
    live, full = fine.live, fine.live & ~fine.partial   # (q tiles, k tiles)
    if transposed:
        live, full = live.T, full.T
    out = np.zeros((full.shape[0], 4), np.int32)
    for t in range(full.shape[0]):
        s = int(starts[t * LANE // sub]) // LANE
        idx = s + np.flatnonzero(live[t, s:s + band // LANE])
        if idx.size == 0:
            out[t] = s
            continue
        s, e = int(idx[0]), int(idx[-1]) + 1
        best, run0 = (s, s), None
        for b in range(s, e):
            if not full[t, b]:
                run0 = None
                continue
            run0 = b if run0 is None else run0
            if b + 1 - run0 > best[1] - best[0]:
                best = (run0, b + 1)
        out[t] = (s, *best, e)
    return out


def explicit_sub(config: BlockConfig, block_q: int, block_kv: int) -> bool:
    return (min(config.block_q_compute or block_q, block_q) != block_q
            or min(config.block_kv_compute or block_kv, block_kv) != block_kv)


@functools.lru_cache(maxsize=256)
def _forward_route(pack: SyncPack, rule: MaskRule, config: BlockConfig, d: int, v_d: int,
                   window_on: bool, banded_on: bool, resident: bool) -> Route:
    q_len, k_len = math.prod(pack.q.shape), math.prod(pack.k.shape)
    block_q = min(config.block_q, pad_to(q_len, LANE))
    block_kv = min(config.block_kv, pad_to(k_len, LANE))
    q_pad, k_pad = pad_to(q_len, block_q), pad_to(k_len, block_kv)
    tiled = not explicit_sub(config, block_q, block_kv)
    if window_on and tiled:
        picked = pick_window(
            lambda sq: window_band_table(pack, rule, sq, q_len, k_len, q_pad, k_pad),
            (512, 256, 128), block_q, q_pad)
        if picked is not None:
            sub_q, (starts, band, slots, _) = picked
            if native.window_fwd_smem(band, d, v_d) <= native.MAX_SMEM:
                return Route("window_fwd", block_q, block_kv,
                             (starts, window_segments(pack, rule, starts, band, sub_q)),
                             band, sub_q, slots is not None)
    sched = build_schedule(pack, rule, block_q, block_kv)
    if banded_on and tiled:
        seg = sched.banded_segments()
        if seg is not None:
            return Route("resident_fwd" if resident else "banded_fwd", block_q, block_kv,
                         (seg,))
    return Route("flash_fwd", block_q, block_kv,
                 (sched.kv_table, sched.kv_counts, sched.needs_mask))


def forward_route(pack: SyncPack, rule: MaskRule, config: BlockConfig, d: int,
                  v_d: int) -> Route:
    """The forward kernel the JAX package's ``flash_forward`` runs for this
    schedule, as the port's CUDA kernel and its operands."""
    return _forward_route(pack, rule, config, d, v_d, env_on("FA_WINDOW"), env_on("FA_BANDED"),
                          os.environ.get("FA_RESIDENT") == "1")


def prescale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x * scale * log2e`` in float32, rounded back to ``x``'s dtype (the
    operand that feeds the log2-domain logits)."""
    return (x.float() * (scale * LOG2E)).to(x.dtype)


def dense_mask(pack: SyncPack, rule: MaskRule, device) -> Optional[torch.Tensor]:
    """The rule's (q_len, k_len) visibility on ``device``, or ``None`` for
    the full rule."""
    q_len, k_len = math.prod(pack.q.shape), math.prod(pack.k.shape)
    q_pos = torch.arange(q_len, dtype=torch.int64, device=device)[:, None]
    k_pos = torch.arange(k_len, dtype=torch.int64, device=device)[None, :]
    return build_tile_mask(pack, rule, q_pos, k_pos, q_len, k_len, q_len, k_len)


def _flash_forward_plain(q_scaled, k, v, pack: SyncPack, rule: MaskRule):
    """Plain version of ``flash_fwd``, ``banded_fwd``, ``resident_fwd`` and
    ``window_fwd``: the same log2-domain softmax, dense, in float32.  For
    half inputs p is rounded to the input type before PV while ``l`` sums
    the float32 p, where the JAX kernels and the port's round it
    (``ops/forward.py:166`` of the JAX package).  Returns ``(o, l, m)`` as
    the kernels do."""
    g = q_scaled.shape[0] // k.shape[0]
    kf = k.float().repeat_interleave(g, dim=0)
    vf = v.float().repeat_interleave(g, dim=0)
    s = torch.matmul(q_scaled.float(), kf.transpose(-1, -2))
    mask = dense_mask(pack, rule, s.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF_F32)
    m2 = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m2)
    l = p.sum(dim=-1)
    m2 = m2[..., 0]
    dead = m2 <= NEG_INF_F32
    l = torch.where(dead, torch.zeros_like(l), l)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    if q_scaled.dtype != torch.float32:
        p = p.to(q_scaled.dtype).float()
    o = torch.matmul(p, vf) / l_safe[..., None]
    o = torch.where(dead[..., None], torch.zeros_like(o), o)
    m = torch.where(dead, torch.full_like(m2, NEG_INF_F32), m2 * INV_LOG2E)
    return o.to(q_scaled.dtype), l, m


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, pack: SyncPack,
                  rule: MaskRule, config: BlockConfig, scale: Optional[float] = None):
    """Forward on sequence-major tensors ``q (B, q_len, d)``,
    ``k (B_kv, k_len, d)``, ``v (B_kv, k_len, v_d)``, ``B % B_kv == 0``.

    Returns ``(o, l, m)``: ``o (B, q_len, v_d)`` in q's dtype, ``l, m
    (B, q_len)`` float32 with ``m`` in the natural-log domain.
    """
    in_dtype = q.dtype
    if in_dtype.itemsize == 1:
        o, l, m = flash_forward(q.to(torch.bfloat16), k.to(torch.bfloat16),
                                v.to(torch.bfloat16), pack=pack, rule=rule, config=config,
                                scale=scale)
        return o.to(in_dtype), l, m
    B, q_len, d = q.shape
    B_kv, k_len, v_d = v.shape
    if B % B_kv:
        raise ValueError(f"q batch {B} not a multiple of kv batch {B_kv}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q_scaled = prescale(q, scale)
    if q.device.type == "cpu":
        return _flash_forward_plain(q_scaled, k, v, pack, rule)
    route = forward_route(pack, rule, config, d, v_d)
    tabs = route.tables(pack, rule, q.device)
    args = (q_scaled.contiguous(), k.contiguous(), v.contiguous(),
            native.fa_rule(pack, rule, q.device))
    if route.kernel == "window_fwd":
        return native.window_fwd(*args, *tabs, route.band, route.sub, route.masked)
    if route.kernel == "banded_fwd":
        return native.banded_fwd(*args, tabs[0], route.block_q, route.block_kv)
    if route.kernel == "resident_fwd":
        return native.resident_fwd(*args, tabs[0], route.block_q, route.block_kv)
    return native.flash_fwd(*args, tabs, route.block_q, route.block_kv)
