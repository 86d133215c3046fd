#!/usr/bin/env python
"""Reference-parity usage examples on the PyTorch port (``basic_usage.py``'s
calls and shapes), on the CUDA card unless ``--device`` says otherwise.

Run: python examples/torch_basic_usage.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from tf_flash_attention_tpu_torch import api as fa
from tf_flash_attention_tpu_torch.mask_rules import CausalRule
from tf_flash_attention_tpu_torch.parallel import mha


def main(device=None):
    """Run the examples on ``device`` (the card when None); returns what it
    prints, by line label: shapes (and the stats' dtypes)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def uniform(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=gen, device=device).to(dtype)

    out = {}
    # --- the reference README example: local attention on 1d sequences ---
    # shape format = [batch, channel, sequence] (channel-first)
    Q, K, V = uniform(8, 32, 1024), uniform(8, 32, 2048), uniform(8, 16, 2048)
    # O has shape [8, 16, 1024]
    O = fa.local_1d(Q, K, V, window_size=32, log2_stride_size=0, is_causal=False,
                    sync_mode="scale_front")
    out["local_1d"] = tuple(O.shape)
    print("local_1d:", out["local_1d"])

    # --- causal with softmax statistics ---
    O, l, m = fa.causal_1d(Q, K, V, sync_mode="none_front", returning_l_m=True)
    out["causal_1d"] = (tuple(O.shape), tuple(l.shape), l.dtype, tuple(m.shape), m.dtype)
    print("causal_1d:", out["causal_1d"][0], "l:", *out["causal_1d"][1:3],
          "m:", *out["causal_1d"][3:])

    # --- 2d sequences (e.g. image feature maps), strided local window ---
    Q2 = uniform(2, 4, 32, 32, 32)   # batch, heads, c, H, W
    K2 = uniform(2, 4, 32, 64, 64)   # coarser/finer grids sync
    V2 = uniform(2, 4, 16, 64, 64)
    O2 = fa.local_2d(Q2, K2, V2, window_size=8, log2_stride_size=1, is_causal=False,
                     sync_mode="scale_front")
    out["local_2d"] = tuple(O2.shape)
    print("local_2d (cross-resolution):", out["local_2d"])

    # --- gradients flow through the recompute-based backward kernels ---
    q = Q.clone().requires_grad_(True)
    (fa.causal_1d(q, K, V, sync_mode="none_front") ** 2).sum().backward()
    out["grad"] = tuple(q.grad.shape)
    print("grad wrt Q:", out["grad"])

    # --- native multi-head layout (batch, heads, seq, head_dim) ---
    q = uniform(2, 8, 1024, 128, dtype=torch.bfloat16)
    k = uniform(2, 2, 1024, 128, dtype=torch.bfloat16)   # GQA 8:2
    v = uniform(2, 2, 1024, 128, dtype=torch.bfloat16)
    o = mha(q, k, v, rule=CausalRule())
    out["mha"] = tuple(o.shape)
    print("mha (GQA):", out["mha"])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
