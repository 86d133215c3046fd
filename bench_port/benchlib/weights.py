"""Random weights of a decoder configuration, drawn on the device from the seed.

Both sides of a run take their weights from here: the program under test
(wrapped into its own parameter objects by ``benchlib.program``) and the
plain reference (``references/decoder.py``), which draws them again after
the program is gone, so it holds nothing the program made.  One
``torch.Generator`` on the device, seeded with the run's seed, draws every
matrix in bf16 in one call a layer; the same seed, shapes and device give
the same values.  Scales follow the port's ``init_params``: the embedding
N(0, 0.02^2), each projection N(0, 1/fan_in), the norm scales 1.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

PROJ_NAMES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def head_dim(cfg: dict) -> int:
    return int(cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"])


def layer_shapes(cfg: dict) -> Dict[str, tuple]:
    """A layer's projections, (in, out) as the port lays them out (``x @ w``)."""
    d, dh, ff = cfg["hidden_size"], head_dim(cfg), cfg["intermediate_size"]
    dq, dkv = cfg["num_attention_heads"] * dh, cfg["num_key_value_heads"] * dh
    return {"wq": (d, dq), "wk": (d, dkv), "wv": (d, dkv), "wo": (dq, d),
            "w1": (d, ff), "w3": (d, ff), "w2": (ff, d)}


def generate(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """``{"embed": (vocab, d), "layers": [{name: (in, out)}]}`` in ``dtype``
    on ``device``; each layer's matrices are views of one buffer drawn in
    one call.  The norm scales are 1 and are not drawn."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d = cfg["hidden_size"]
    embed = torch.randn((cfg["vocab_size"], d), generator=gen, device=device, dtype=dtype)
    embed.mul_(0.02)
    shapes = layer_shapes(cfg)
    per_layer = sum(math.prod(s) for s in shapes.values())
    layers: List[dict] = []
    for _ in range(cfg["num_hidden_layers"]):
        buf = torch.randn(per_layer, generator=gen, device=device, dtype=dtype)
        views, lo = {}, 0
        for name, shape in shapes.items():
            n = math.prod(shape)
            views[name] = buf[lo:lo + n].view(shape).mul_(1.0 / math.sqrt(shape[0]))
            lo += n
        layers.append(views)
    return {"embed": embed, "layers": layers}
