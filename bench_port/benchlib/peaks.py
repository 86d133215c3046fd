"""Published peaks of the card, the yardstick of every roofline and MFU share.

NVIDIA H100 SXM, NVIDIA's data sheet, dense rates without sparsity, at its
700 W limit: 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3.
A copy of the port's ``utils/profiling.py::H100_SXM`` rates, kept here so
that no change to the program moves the yardstick.  A card set below
700 W runs slower under load; each run reports the card's name, and
``PERF.md`` notes the power limit beside every figure.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    bf16_flops: float
    hbm_bytes: float


H100_SXM = Peaks(bf16_flops=989e12, hbm_bytes=3.35e12)
