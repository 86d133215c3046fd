#!/usr/bin/env python
"""Sharded training demo on the PyTorch port: dp/tp/sp with MoE expert
parallelism (``train_demo.py``'s model and steps) on an 8-way (data 2,
model 4) mesh: the first 8 CUDA cards, or 8 shards of one card (the
port's meshes are single-controller; there the step is a CUDA graph, so
the optimizer is capturable), or ``--device cpu`` 8 times.

Run: python examples/torch_train_demo.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from tf_flash_attention_tpu_torch.models.transformer import (ModelConfig, init_params,
                                                             make_sharded_train_step)
from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh

N_DEVICES = 8


def main(device=None):
    """5 AdamW steps on the mesh (over the cards when ``device`` is None);
    returns what it prints: ``mesh`` (axis sizes) and ``losses``."""
    if device is None:
        n = torch.cuda.device_count()
        devices = ([torch.device("cuda", i) for i in range(N_DEVICES)] if n >= N_DEVICES
                   else [torch.device("cuda", 0)] * N_DEVICES)
    else:
        devices = [torch.device(device)] * N_DEVICES
    tp = 4 if N_DEVICES % 4 == 0 else 1
    dp = N_DEVICES // tp
    mesh = make_mesh((dp, tp), ("data", "model"), devices)
    print(f"mesh: {dict(mesh.shape)}")

    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=8,
                      n_kv_heads=8, d_head=32, d_ff=512, max_seq=256,
                      n_experts=4)  # MoE: experts sharded over 'model'
    home = devices[0]
    params = init_params(cfg, torch.Generator(device=home).manual_seed(0), home)
    # optax.adamw(3e-4)'s defaults; capturable on CUDA, where a mesh on one
    # card runs the step as a CUDA graph
    optimizer = torch.optim.AdamW(params.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4, capturable=home.type == "cuda")
    step = make_sharded_train_step(cfg, mesh, optimizer)
    gen = torch.Generator(device=home).manual_seed(1)
    losses = []
    for i in range(5):
        tokens = torch.randint(0, cfg.vocab, (2 * dp, 257), generator=gen, device=home)
        losses.append(float(step(params, tokens)))
        print(f"step {i}: loss {losses[-1]:.4f}")
    return {"mesh": dict(mesh.shape), "losses": losses}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of all 8 shards (default: the CUDA cards)")
    main(ap.parse_args().device)
