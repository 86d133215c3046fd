"""Forward-kernel cost attribution (PyTorch port of ``tools/exp_vpu_attrib.py``).

A ladder of forward kernels at one grid, tiles and schedule (bf16, S 4096,
d 128, B 8, 2048 x 2048 blocks, block-causal: q block i sees kv blocks
0..i whole), each rung removing one piece of the online-softmax chain:

  prod     full math (max, exp2, sum, merge, rescale)
  nomax    running max dropped (p = exp2(s - 8))
  noexp    exp2 dropped (p = s - m)
  nosum    l-update dropped (o = acc)
  bf16exp  exp2 on bf16 inputs with bf16 results
  mm       products only: p = bf16(s), no softmax

Each rung is the function it computes; the kernel is the ``exp_vpu_ladder``
entry of ``csrc/exp_forward_kernels.cu``: the persistent tensor-core
forward (``wgmma`` fed by TMA) with each rung a compiled merge policy, items
of 128 query rows.  ``prod``, ``noexp``, ``nosum`` and ``bf16exp`` take
each 2048-key group's row maximum in a first pass of S products before
any exponential; ``nomax`` and ``mm`` need none and merge every 128-key
stage, so on the card ``prod - nomax`` is the price of that pass.

    python -m tf_flash_attention_tpu_torch.experiments.exp_vpu_attrib
"""

from __future__ import annotations

import math

import torch

from .. import native
from ..ops.kernel_common import LOG2E
from ._steps import forward_steps, require_cuda

__all__ = ["RUNGS", "ladder", "ladder_plain", "live_tiles", "main", "B", "S", "D", "BQ", "BK"]

B, S, D = 8, 4096, 128
BQ, BK = 2048, 2048
SCALE = 1.0 / math.sqrt(D)
RUNGS = native.LADDER_RUNGS


def ladder_plain(rung: str, q, k, v, *, block_q: int = BQ, block_kv: int = BK):
    """One rung in PyTorch: prescaled bf16 q, k, v (B, S, d) -> o."""
    return forward_steps(q, k, v, step=block_kv, group=block_kv, block_q=block_q, causal=True,
                         elem_mask=False, policy=rung)


def ladder(rung: str, q, k, v, *, block_q: int = BQ, block_kv: int = BK):
    """One rung: the ``exp_vpu_ladder`` kernel for CUDA tensors, its plain
    version for CPU tensors."""
    if rung not in RUNGS:
        raise ValueError(f"rung must be one of {RUNGS}, got {rung!r}")
    if not q.is_cuda:
        return ladder_plain(rung, q, k, v, block_q=block_q, block_kv=block_kv)
    return native.exp_vpu_ladder(rung, q, k, v, block_q, block_kv)


def live_tiles(seq: int = S, block_q: int = BQ, block_kv: int = BK) -> int:
    """(q block, kv block) pairs the block-causal walk visits."""
    return sum(-(-(i + 1) * block_q // block_kv) for i in range(seq // block_q))


def main():
    from ..utils.profiling import H100_SXM, device_time

    dev = require_cuda("exp_vpu_attrib")
    gen = torch.Generator(device=dev).manual_seed(0)
    mk = lambda: (torch.rand((B, S, D), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    q = mk() * torch.tensor(SCALE * LOG2E, dtype=torch.bfloat16, device=dev)
    k, v = mk(), mk()
    scores = B * BQ * BK * live_tiles()
    flops = 4 * D * scores
    print(f"device={torch.cuda.get_device_name(0)}", flush=True)
    # what each piece of the ladder could cost at the card's peaks: the
    # products on the tensor cores, the softmax chain's elementwise
    # operations, q, k, v read and o written once
    t_mm, t_elem, t_mem = H100_SXM.attention_time(flops, scores, 4 * q.numel() * 2)
    print(f"floors at {H100_SXM.name} peaks: products {t_mm * 1e3:.4f} ms (bf16 tensor "
          f"cores); softmax {t_elem * 1e3:.4f} ms; memory {t_mem * 1e3:.4f} ms", flush=True)
    for rung in RUNGS:
        o = ladder(rung, q, k, v)
        err = float((o.float() - ladder_plain(rung, q, k, v).float()).abs().max())
        walk = native.WALKS["exp_vpu_ladder"]
        dt = device_time(ladder, (rung, q, k, v), n=3, reps=4)
        print(f"{rung:8s}: {dt * 1e3:7.3f} ms  {flops / dt / 1e12:6.1f} TFLOP/s  "
              f"max|err| vs plain {err:.3e}  ({walk['body']}, {walk['items']} items, "
              f"grid {walk['grid']})", flush=True)


if __name__ == "__main__":
    main()
