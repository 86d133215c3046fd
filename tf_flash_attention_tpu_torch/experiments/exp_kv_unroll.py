"""Forward kv-unroll experiment (PyTorch port of ``tools/exp_kv_unroll.py``).

Full attention (bf16, S 4096, d 128, B 8, BQ = BK = 512) with ``nkv`` kv
blocks a step, every block's scores computed before any softmax:

  base      one kv block a step
  unroll2   two blocks a step, merged one after the other
  unroll2f  two blocks a step, one merge over their concatenated scores
  unroll4   four blocks a step, merged one after the other

The kernel is the ``exp_kv_unroll`` entry of
``csrc/exp_forward_kernels.cu``: the persistent tensor-core forward
(``wgmma`` fed by TMA, items of 128 query rows) with the ``prod`` merge.
Only the width of each merge is the variant's on the card (``BK`` keys,
or ``nkv * BK`` when ``fused``): each group's row maximum comes from a
first pass of S products, then the group merges, so ``base``, ``unroll2``
and ``unroll4`` run one schedule and ``unroll2f`` merges 1024 keys at a
time.  The tool's step (every block's products before any softmax) sets
nothing here.

    python -m tf_flash_attention_tpu_torch.experiments.exp_kv_unroll
"""

from __future__ import annotations

import math

import torch

from .. import native
from ..ops.kernel_common import LOG2E
from ._steps import forward_steps, require_cuda

__all__ = ["VARIANTS", "kv_unroll", "kv_unroll_plain", "main", "B", "S", "D", "BK"]

B, S, D = 8, 4096, 128
BK = 512     # the tool's BQ (512) only tiles its grid: full attention has no q blocks
#: (name, nkv, fused) in the order of the tool's main
VARIANTS = (("base", 1, False), ("unroll2", 2, False), ("unroll2f", 2, True),
            ("unroll4", 4, False))


def _scale_log2e(d: int) -> float:
    return 1.0 / math.sqrt(d) * LOG2E


def kv_unroll_plain(q, k, v, *, nkv: int, fused: bool, block_kv: int = BK):
    """The kernel's function in PyTorch: bf16 q, k, v (B, S, d) -> o."""
    step = nkv * block_kv
    return forward_steps(q, k, v, step=step, group=step if fused else block_kv,
                         block_q=q.shape[1], causal=False, elem_mask=False, policy="prod",
                         score_scale=_scale_log2e(q.shape[2]))


def kv_unroll(q, k, v, *, nkv: int, fused: bool, block_kv: int = BK):
    """Full attention: the ``exp_kv_unroll`` kernel for CUDA tensors, its
    plain version for CPU tensors."""
    if not q.is_cuda:
        return kv_unroll_plain(q, k, v, nkv=nkv, fused=fused, block_kv=block_kv)
    return native.exp_kv_unroll(q, k, v, nkv, fused, block_kv, _scale_log2e(q.shape[2]))


def main():
    from ..utils.profiling import device_time

    dev = require_cuda("exp_kv_unroll")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = (torch.rand((B, S, D), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    kkv = (torch.rand((B, S, D), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    flops = 4 * B * S * S * D
    print(f"device={torch.cuda.get_device_name(0)}", flush=True)
    ref = None
    for name, nkv, fused in VARIANTS:
        o = kv_unroll(q, kkv, kkv, nkv=nkv, fused=fused)
        if ref is None:
            ref, err = o.float(), 0.0
        else:
            err = float((o.float() - ref).abs().max())
        err_plain = float((o.float() - kv_unroll_plain(q, kkv, kkv, nkv=nkv, fused=fused).float())
                          .abs().max())
        walk = native.WALKS["exp_kv_unroll"]
        t = device_time(lambda: kv_unroll(q, kkv, kkv, nkv=nkv, fused=fused), (), n=3, reps=4)
        print(f"{name:9s}: {t * 1e3:.3f} ms, {flops / t / 1e12:.1f} TFLOP/s, err={err:.2e} "
              f"(vs plain {err_plain:.2e}; {walk['body']}, {walk['items']} items, grid "
              f"{walk['grid']})", flush=True)


if __name__ == "__main__":
    main()
