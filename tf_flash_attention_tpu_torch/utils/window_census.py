"""The window kernels' times at the JAX package's window-sweep shapes.

    python tf_flash_attention_tpu_torch/utils/window_census.py [--root DIR]

Imports ``tf_flash_attention_tpu_torch`` from ``--root`` (default: the
tree this file lies in), so that an earlier tree unpacked in a directory of
the checkout (``build/parent``, say; a tree from the one that added
``utils/serving_census.py`` on) is timed by the same code in the same run.
At the two bf16 shapes of ``tools/exp_window_sweep.py`` (B 8, D 128):
``local1d_w512`` (8,192 tokens, a causal window of 512) and ``local2d_w8``
(a 64 x 64 image, a causal 2-d window of 8), and at ``chip_smoke.py``
phase 5 case (d)'s float32 shape (``case_d_f32``: B 4, D 64, 1,500
queries over 2,000 keys, a causal window of 5 at stride 2, scale_front:
the scalar bodies), it times ``window_fwd`` and
``window_bwd`` through the bindings (``native.window_fwd``,
``native.window_bwd``, called as each tree takes them: this tree passes
the bands' segments too) and the public entries (``api.local_1d`` or
``api.local_2d``: the forward, and the forward with its backward through
autograd).  For each: CUDA-event ms a call, and for the bindings the
kernel's own device ms a call (``torch.profiler``) and the body the launch
reports ("not reported" where the tree has no report: its scalar body).
Prints one JSON line naming the tree and the card.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

#: (rule arguments, sync mode, q and k sequence shapes, B, D, dtype) of each
#: shape of the sweep, and of chip_smoke.py's case (d)
SHAPES = {"local1d_w512": ((512, 0, True), "none_front", (8192,), (8192,), 8, 128,
                           torch.bfloat16),
          "local2d_w8": ((8, 0, True), "none_front", (64, 64), (64, 64), 8, 128, torch.bfloat16),
          "case_d_f32": ((5, 1, True), "scale_front", (1500,), (2000,), 4, 64, torch.float32)}
#: each kernel's CUDA kernel name on its body, as the profiler lists it
KERNEL_NAMES = {("window_fwd", "tensor-core"): "fwd_tc_kernel",
                ("window_fwd", "scalar"): "window_fwd_kernel",
                ("window_bwd", "tensor-core"): "bwd_tc_kernel",
                ("window_bwd", "scalar"): "flash_bwd_kv_kernel"}


def shape_times(shape: str, dev, seed=0) -> dict:
    from tf_flash_attention_tpu_torch import api, native
    from tf_flash_attention_tpu_torch.block_sizes import choose_block_config
    from tf_flash_attention_tpu_torch.mask_rules import LocalRule
    from tf_flash_attention_tpu_torch.ops import backward, forward
    from tf_flash_attention_tpu_torch.utils.profiling import device_time
    from tf_flash_attention_tpu_torch.utils.serving_census import _kernel_ms
    from tf_flash_attention_tpu_torch.sync_modes import make_sync_pack
    (window, stride, causal), sync, q_seq, k_seq, B, D, dtype = SHAPES[shape]
    rule, pack = LocalRule(window, stride, causal), make_sync_pack(sync, q_seq, k_seq)
    cfg = choose_block_config(D, D)
    fw = forward.forward_route(pack, rule, cfg, D, D)
    (bw,) = backward.backward_route(pack, rule, cfg, 1, "kv")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((B, math.prod(s), D), generator=gen, device=dev).to(dtype)
                   for s in (q_seq, k_seq, k_seq, q_seq))
    scale = D ** -0.5
    q_s, rule_c = forward.prescale(q, scale), native.fa_rule(pack, rule, dev)
    o, l, m = forward.flash_forward(q, k, v, pack=pack, rule=rule, config=cfg)
    lse2, delta = backward.backward_stats(o, l, m, do)
    calls = {
        "window_fwd": lambda: native.window_fwd(q_s, k, v, rule_c, *fw.tables(pack, rule, dev),
                                                fw.band, fw.sub, fw.masked),
        "window_bwd": lambda: native.window_bwd(q_s, k, v, do, lse2, delta, rule_c,
                                                *bw.tables(pack, rule, dev), bw.band, bw.sub,
                                                1.0 / math.log2(math.e)),
    }
    out = {"routes": [fw.kernel, bw.kernel], "band": [fw.band, bw.band],
           "sub": [fw.sub, bw.sub]}
    for name, fn in calls.items():
        ms = device_time(fn, (), n=4, reps=5) * 1e3
        body = native.WALKS.get(name, {}).get("body", "not reported")
        kname = KERNEL_NAMES[name, "scalar" if body == "not reported" else body]
        out[name] = {"ms": ms, "kernel_ms": _kernel_ms(fn, kname, n=10), "body": body}
    # the public entry: channel-first (B, D, *seq)
    entry = api.local_1d if len(q_seq) == 1 else api.local_2d
    cf = lambda x, s: x.transpose(1, 2).reshape(B, D, *s)
    Q, K, V, dO = (cf(x, s) for x, s in zip((q, k, v, do), (q_seq, k_seq, k_seq, q_seq)))

    def fwd_bwd():
        xs = [x.detach().requires_grad_() for x in (Q, K, V)]
        torch.autograd.grad(entry(*xs, window, stride, causal, sync), xs, dO)
    out["entry_fwd_ms"] = device_time(lambda: entry(Q, K, V, window, stride, causal, sync),
                                      (), n=4, reps=5) * 1e3
    out["entry_fwd_bwd_ms"] = device_time(fwd_bwd, (), n=4, reps=5) * 1e3
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the tree whose tf_flash_attention_tpu_torch to measure")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the census runs only on the GPU")
    sys.path.insert(0, str(args.root.resolve()))
    import tf_flash_attention_tpu_torch as port
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    where = {"tree": str(args.root), "package": str(Path(port.__file__).parent),
             "card": torch.cuda.get_device_name(0)}
    print(json.dumps({**where, **{s: shape_times(s, dev) for s in SHAPES}}), flush=True)


if __name__ == "__main__":
    main()
