"""Resident-KV causal forward (PyTorch port of ``tools/exp_resident.py``).

The TPU prototype fetches a batch row's whole K/V into VMEM once and walks
each q block's live kv sub-tiles in an in-kernel loop, with the diagonal
tiled at the loop's granularity.  Its kernel masks only the last sub-tile
of a q block, which is exact only when ``block_q == block_kv``; the port
masks every sub-tile that crosses the q block's diagonal, so every
(block_q, block_kv) pair computes exact causal attention.  On the card the
K/V of a row does not fit a block's shared memory: the kernel
(``csrc/exp_forward_kernels.cu``) is the op path's resident tensor-core
forward with the tool's bf16 merge, persistent CTAs walking the rows in
order so that few rows' K/V are live in L2 at once.  The pair sets what it
sets on the TPU: an item of ``block_q`` query rows for one CTA, and a merge
every ``block_kv`` keys against that step's row maximum, as the plain
version merges (past 128 keys the kernel takes a step's maximum in a first
pass of its S products).

    python -m tf_flash_attention_tpu_torch.experiments.exp_resident

compares each pair against the port's production forward and a dense
causal oracle and prints its time on the card.
"""

from __future__ import annotations

import math

import torch

from .. import native
from ..ops.kernel_common import LOG2E
from ._steps import forward_steps, require_cuda

__all__ = ["resident_forward", "resident_forward_plain", "causal_oracle", "PAIRS", "main"]

#: the (block_q, block_kv) pairs of the tool's main
PAIRS = ((1024, 1024), (1024, 512), (512, 512), (256, 256), (512, 256), (1024, 256), (2048, 512))


def _prescale(q, scale):
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    # a float32 scalar on the host: no copy to the card, which would stall
    # the caller until the stream drains
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    return (q.float() * c).to(q.dtype)


def resident_forward_plain(q, k, v, *, block_q: int, block_kv: int, scale=None):
    """The kernel's function in PyTorch: q, k, v (B, S, d) bf16 -> o."""
    return forward_steps(_prescale(q, scale), k, v, step=block_kv, group=block_kv,
                         block_q=block_q, causal=True, elem_mask=True, policy="bf16exp")


def resident_forward(q, k, v, *, block_q: int, block_kv: int, scale=None):
    """Causal attention of bf16 (B, S, d): the ``exp_resident_fwd`` kernel
    for CUDA tensors, its plain version for CPU tensors."""
    B, S, d = q.shape
    if S % block_q or S % block_kv:
        raise ValueError(f"S {S} must be a multiple of block_q {block_q} and block_kv {block_kv}")
    if not q.is_cuda:
        return resident_forward_plain(q, k, v, block_q=block_q, block_kv=block_kv, scale=scale)
    return native.exp_resident_fwd(_prescale(q, scale), k, v, block_q, block_kv)


def causal_oracle(q, k, v, scale=None):
    """Dense float32 causal attention of (B, S, d), rounded to q's dtype."""
    S, d = q.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return (torch.softmax(s, -1) @ v.float()).to(q.dtype)


def main():
    import statistics

    from ..block_sizes import BlockConfig
    from ..flops import matmul_flops_forward
    from ..mask_rules import CausalRule
    from ..ops.forward import flash_forward
    from ..sync_modes import make_sync_pack
    from ..utils.profiling import device_time, device_time_samples

    dev = require_cuda("exp_resident")
    S, B, D = 4096, 8, 128
    print(f"device={torch.cuda.get_device_name(0)}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    t = lambda s: (torch.rand(s, generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    q, k, v = t((B, S, D)), t((B, S, D)), t((B, S, D))
    pack = make_sync_pack("none_front", (S,), (S,))
    rule = CausalRule()
    flops_128 = matmul_flops_forward(rule, "none_front", (S,), (S,), D, D, B)

    a, b2 = t((4096, 4096)), t((4096, 4096))
    mm = lambda a, b: a @ b
    mxu_ref = 2 * 4096 ** 3 / min(device_time(mm, (a, b2), n=20) for _ in range(3)) / 1e12
    print(f"mxu_ref = {mxu_ref:.1f} TFLOP/s (torch.matmul, bf16)", flush=True)

    cfg = BlockConfig(1024, 1024, 1024, 1024, 1024, 1024)
    base_fn = lambda q, k, v: flash_forward(q, k, v, pack=pack, rule=rule, config=cfg)[0]
    o_ref = base_fn(q, k, v)
    oracle = causal_oracle(q, k, v)
    variants = [("prod 1024x1024", base_fn)]
    for bq, bkv in PAIRS:
        variants.append((f"resident {bq}x{bkv}",
                         lambda q, k, v, bq=bq, bkv=bkv: resident_forward(
                             q, k, v, block_q=bq, block_kv=bkv)))
    for name, fn in variants:
        o = fn(q, k, v)
        torch.cuda.synchronize()
        err = float((o.float() - o_ref.float()).abs().max())
        err_oracle = float((o.float() - oracle.float()).abs().max())
        if err > 1e-2 or not torch.isfinite(o).all():
            print(f"{name}: PARITY FAIL {err} (dense causal oracle {err_oracle})", flush=True)
            continue
        samples = device_time_samples(fn, (q, k, v), n=5, reps=6)
        med, mn = statistics.median(samples), min(samples)
        print(f"{name}: min {mn * 1e3:.4f} / median {med * 1e3:.4f} ms  "
              f"{flops_128 / med / 1e12:.1f} TFLOP/s useful (median); max|err| vs prod {err:.3e}, "
              f"vs dense causal oracle {err_oracle:.3e}", flush=True)


if __name__ == "__main__":
    main()
