"""Reference-style test and benchmark harness (port of ``testing.py``).

The reference's runnable harness: a case matrix of {sync modes} x {full,
causal, local, local + stride, local + causal, local + stride + causal},
run as

    python -m tf_flash_attention_tpu_torch.testing list      [1d|2d]
    python -m tf_flash_attention_tpu_torch.testing verify    [1d|2d]
    python -m tf_flash_attention_tpu_torch.testing benchmark [1d|2d]

with one case picked by the ``TESTCASE`` environment variable and random
shapes drawn ``FA_RUNS`` times (default 3) from ``FA_SEED``.  ``verify``
holds the outputs and all three input gradients against the dense oracle
(``ops.reference``) with the reference's tolerance model (``1e-6 *
K_entries`` float32, ``1e-3 * K_entries`` half); ``benchmark`` prints the
flash and the vanilla (dense oracle) device times and the peak device
memory (``torch.cuda.max_memory_allocated``), each beside the card's name
and power limit.

The harness runs on the card: bf16 and float32 there.  ``FA_DEVICE=cpu``
runs ``list`` and ``verify`` on the CPU in float32 (the kernels' plain
versions), as the JAX harness does on its CPU backend; ``benchmark``
times the card only.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

from .api import flash_attention
from .mask_rules import CausalRule, FullRule, LocalRule
from .ops.reference import reference_attention

_CASES = {}


def _register_cases():
    rules = {
        "FullAttention": FullRule(),
        "CausalAttention": CausalRule(),
        "LocalAttention": LocalRule(window_size=8),
        "LocalStrideAttention": LocalRule(window_size=8, log2_stride_size=3),
        "LocalAndCausalAttention": LocalRule(window_size=8, is_causal=True),
        "LocalStrideAndCausalAttention": LocalRule(window_size=8, log2_stride_size=3,
                                                   is_causal=True),
    }
    modes = {"SyncModeNoneFront": "none_front",
             "SyncModeScaleFront": "scale_front",
             "SyncModeScaleEnd": "scale_end"}
    for rname, rule in rules.items():
        for mname, mode in modes.items():
            if rname == "FullAttention" and mode != "none_front":
                continue  # sync mode cannot affect unmasked attention
            _CASES[f"{rname}{mname}"] = (rule, mode)


_register_cases()

# random-shape bounds, the JAX harness's (scaled down from the reference's
# to stay fast on the CPU)
_SHAPES_1D = {"min": (1, 2, 8, 96), "max": (1, 2, 16, 384)}
_SHAPES_2D = {"min": (1, 2, 8, 8, 8), "max": (1, 2, 16, 16, 24)}


def _device() -> torch.device:
    """The card, unless ``FA_DEVICE`` names another device."""
    return torch.device(os.environ.get("FA_DEVICE", "cuda"))


def _dtypes(device: torch.device):
    if device.type == "cuda":
        return (torch.bfloat16, torch.float32)
    return (torch.float32,)


def _card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def _random_shape(rng, lo, hi):
    return tuple(int(rng.integers(l, h + 1)) for l, h in zip(lo, hi))


def _gen_data(rng, seq_dims, dtype, device):
    table = _SHAPES_1D if seq_dims == 1 else _SHAPES_2D
    base = _random_shape(rng, table["min"], table["max"])
    q_seq = _random_shape(rng, table["min"][-seq_dims:], table["max"][-seq_dims:])
    batch, d = base[:-seq_dims - 1], base[-seq_dims - 1]
    k_seq = base[-seq_dims:]
    v_d = max(4, d // 2)
    t = lambda s: torch.from_numpy(rng.uniform(-2, 2, s)).to(device, dtype)
    Q = t(batch + (d,) + q_seq)
    K = t(batch + (d,) + k_seq)
    V = t(batch + (v_d,) + k_seq)
    dO = t(batch + (v_d,) + q_seq)
    return Q, K, V, dO


def _selected():
    name = os.environ.get("TESTCASE", "all")
    if name != "all":
        return {name: _CASES[name]}
    return _CASES


def _vjp(fn, Q, K, V, dO):
    """(fn(Q, K, V), its gradients against the cotangent dO)."""
    args = [x.detach().requires_grad_(True) for x in (Q, K, V)]
    out = fn(*args)
    return out.detach(), torch.autograd.grad(out, args, dO)


def cmd_list(seq_dims):
    print("Available testcases:")
    for name in _selected():
        print(name)


def cmd_verify(seq_dims):
    device = _device()
    runs = int(os.environ.get("FA_RUNS", "3"))
    rng = np.random.default_rng(int(os.environ.get("FA_SEED", time.time())))
    failures = 0
    for name, (rule, mode) in _selected().items():
        print(f"Verifying {name} ({seq_dims}d)")
        for dtype in _dtypes(device):
            for _ in range(runs):
                Q, K, V, dO = _gen_data(rng, seq_dims, dtype, device)
                n_k = int(np.prod(K.shape[-seq_dims:]))
                n_q = int(np.prod(Q.shape[-seq_dims:]))
                base = 1e-3 if dtype.itemsize == 2 else 1e-6
                o1, g1 = _vjp(lambda Q, K, V: flash_attention(
                    Q, K, V, rule=rule, sync_mode=mode, seq_dims=seq_dims), Q, K, V, dO)
                o2, g2 = _vjp(lambda Q, K, V: reference_attention(
                    Q, K, V, rule=rule, sync_mode=mode, seq_dims=seq_dims), Q, K, V, dO)
                pairs = [("O", o1, o2, n_k)]
                pairs += list(zip(("dQ", "dK", "dV"), g1, g2, (n_k, n_q, n_q)))
                for pname, a, b, scale_n in pairs:
                    tol = base * scale_n
                    err = float((a.float() - b.float()).abs().max())
                    if not err <= tol:
                        failures += 1
                        print(f"  FAIL {name} {dtype} {pname}: err {err} > tol {tol} "
                              f"Q={tuple(Q.shape)} K={tuple(K.shape)}")
    print("FAILED" if failures else "OK")
    return 1 if failures else 0


def cmd_benchmark(seq_dims):
    from .utils.profiling import device_time

    device = _device()
    if device.type != "cuda":
        raise RuntimeError("benchmark times the card: run it with a CUDA device")
    card = _card()
    rng = np.random.default_rng(0)
    print(f"{'case':44s} {'flash_ms':>9s} {'vanilla_ms':>11s} {'speedup':>8s}  card")
    torch.cuda.reset_peak_memory_stats(device)
    for name, (rule, mode) in _selected().items():
        table = _SHAPES_1D if seq_dims == 1 else _SHAPES_2D
        base = table["max"]
        batch, d = base[:-seq_dims - 1], base[-seq_dims - 1]
        seq = base[-seq_dims:]
        t = lambda s: torch.from_numpy(rng.uniform(-2, 2, s)).to(device, torch.bfloat16)
        Q, K, V = t(batch + (d,) + seq), t(batch + (d,) + seq), t(batch + (d,) + seq)

        flash = lambda Q, K, V: flash_attention(
            Q, K, V, rule=rule, sync_mode=mode, seq_dims=seq_dims)
        vanilla = lambda Q, K, V: flash_attention(
            Q, K, V, rule=rule, sync_mode=mode, seq_dims=seq_dims, implementation="xla")
        tf_ = device_time(flash, (Q, K, V), n=10)
        tv = device_time(vanilla, (Q, K, V), n=10)
        print(f"{name:44s} {tf_ * 1e3:9.3f} {tv * 1e3:11.3f} {tv / tf_:8.2f}x  {card}")
    peak = torch.cuda.max_memory_allocated(device)
    print(f"peak device memory: {peak / 1e6:.1f} MB ({card})")


def main(argv):
    cmd = argv[1] if len(argv) > 1 else "verify"
    seq_dims = 2 if (len(argv) > 2 and argv[2] == "2d") else 1
    fn = {"list": cmd_list, "verify": cmd_verify, "benchmark": cmd_benchmark}[cmd]
    return fn(seq_dims) or 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
