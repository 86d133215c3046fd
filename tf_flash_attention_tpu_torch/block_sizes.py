"""Schedule block sizes for the Hopper attention kernels.

``BlockConfig`` keeps the JAX package's fields and validation (multiples
of ``LANE``), so routing reads the same in both packages.  Its blocks are
the *schedule's* granularity: which (q block, kv block) tiles are live and
which of them need the element mask.

On the TPU the solver sized each block against the VMEM budget and a
measured frontier (``block_sizes.py:25-33``, ``:81-141`` of the JAX
package); none of that carries over.  On the H100 each SM has 228 KB of
shared memory, of which one block may use up to 227 KB (232,448 bytes)
with the opt-in attribute.  The CUDA kernels (``csrc/*.cu``) therefore
walk a schedule block in smaller CTA tiles of their own (BM query rows x
BN key rows), fixed at compile time per head-dim class and held in
float32 in shared memory:

=============================  ===================  ===================
kernel                         d, v_d <= 128        d, v_d <= 256
=============================  ===================  ===================
table / banded / resident fwd  64 x 64, 116 KB      64 x 32, 141 KB
fused (kv-outer, q-outer),     64 x 64, 166 KB      32 x 32, 140 KB
banded, window, dK-dV bwd
dQ backward                    64 x 64, 149 KB      32 x 32, 136 KB
window forward                 32 x 64, 50 KB       32 x 32, 66 KB
                               + 128 B per key      + 128 B per key
                               of the band          of the band
=============================  ===================  ===================

All fit the 227 KB budget (the window forward up to bands of 1408 and
1280 keys; ``ops/forward.py`` routes wider bands to the banded kernel); a
CTA tile divides every allowed block.  Work is proportional to the live
area, so the solver picks the finest schedule the fields allow: 128
everywhere.
"""

from __future__ import annotations

import dataclasses

__all__ = ["BlockConfig", "choose_block_config", "pad_to", "LANE", "MIN_BLOCK",
           "MAX_HEAD_DIM"]

LANE = 128
MIN_BLOCK = 128
#: widest d / v_d the CUDA kernels' register tiles hold
MAX_HEAD_DIM = 256


def pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Static tile sizes of the forward and backward schedules.

    ``block_kv_compute``/``block_q_compute`` are the JAX package's compute
    sub-tiling.  As there, setting either finer than its block selects the
    table-driven forward (``ops/forward.py``); the CUDA kernels always
    sub-tile by their own CTA tiles and never read the value itself.
    """

    block_q: int
    block_kv: int
    block_q_dq: int
    block_kv_dq: int
    block_q_dkv: int
    block_kv_dkv: int
    block_kv_compute: int | None = None
    block_q_compute: int | None = None

    def __post_init__(self):
        for name in ("block_q", "block_kv", "block_q_dq", "block_kv_dq",
                     "block_q_dkv", "block_kv_dkv"):
            v = getattr(self, name)
            if v % LANE:
                raise ValueError(f"{name}={v} must be a multiple of {LANE}")
        if self.block_kv_compute is not None:
            if self.block_kv_compute % LANE or self.block_kv % self.block_kv_compute:
                raise ValueError(
                    f"block_kv_compute={self.block_kv_compute} must be a multiple of "
                    f"{LANE} and divide block_kv={self.block_kv}")
        if self.block_q_compute is not None:
            if self.block_q_compute % LANE or self.block_q % self.block_q_compute:
                raise ValueError(
                    f"block_q_compute={self.block_q_compute} must be a multiple of "
                    f"{LANE} and divide block_q={self.block_q}")


def choose_block_config(d: int, v_d: int) -> BlockConfig:
    """The finest schedule (128 everywhere), after checking that the head
    dims fit the kernels' register tiles.  The JAX solver also takes the
    sequence lengths, dtype, rule and GQA group, to size blocks for VMEM;
    here a block sets only the skip granularity (the CTA tiles are fixed),
    so none of them changes the choice."""
    if max(d, v_d) > MAX_HEAD_DIM:
        raise ValueError(f"head dims up to {MAX_HEAD_DIM} are supported, got d {d}, "
                         f"v_d {v_d}")
    return BlockConfig(MIN_BLOCK, MIN_BLOCK, MIN_BLOCK, MIN_BLOCK, MIN_BLOCK, MIN_BLOCK)
