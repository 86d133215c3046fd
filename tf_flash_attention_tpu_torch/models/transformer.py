"""The flagship decoder-only transformer's weights (PyTorch port).

Counterpart of the JAX package's ``models/transformer.py`` for what the
serving engine needs: ``ModelConfig``, the weights as an ``nn.Module``,
``_rms_norm``, ``init_params`` with the reference's scales, and
``params_from_jax``, which loads the JAX parameter pytree (as numpy
arrays).  The engine runs the layers itself (``serving/engine.py``).

Projection and embedding weights are cast to ``cfg.dtype`` once, at load;
the JAX engine casts them at every use, which gives identical values.
Norm scales stay float32, as the reference's float32 norm math uses them.
Weights keep the JAX layout (in, out), so a projection is ``x @ w``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..mask_rules import CausalRule, MaskRule

__all__ = ["ModelConfig", "Transformer", "init_params", "params_from_jax"]

_PROJ = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_head: int = 64
    d_ff: int = 1536
    dtype: torch.dtype = torch.bfloat16
    rule: MaskRule = dataclasses.field(default_factory=CausalRule)
    n_experts: int = 0

    def __post_init__(self):
        if self.n_experts:
            raise NotImplementedError("MoE is not ported yet (ROADMAP queue 1: models)")

    @property
    def rope_theta(self) -> float:
        return 10000.0

    def proj_shapes(self) -> Dict[str, tuple]:
        dq, dkv = self.n_heads * self.d_head, self.n_kv_heads * self.d_head
        return {"wq": (self.d_model, dq), "wk": (self.d_model, dkv),
                "wv": (self.d_model, dkv), "wo": (dq, self.d_model),
                "w1": (self.d_model, self.d_ff), "w3": (self.d_model, self.d_ff),
                "w2": (self.d_ff, self.d_model)}


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One decoder layer's weights."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = _frozen(torch.ones(cfg.d_model, device=device))
        self.ln2 = _frozen(torch.ones(cfg.d_model, device=device))
        for name, shape in cfg.proj_shapes().items():
            setattr(self, name, _frozen(torch.zeros(shape, dtype=cfg.dtype, device=device)))


class Transformer(nn.Module):
    """Weights of the decoder: ``embed`` (vocab, d_model), ``final_norm``
    and per-layer ``ln1, ln2, wq, wk, wv, wo, w1, w3, w2``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(torch.zeros((cfg.vocab, cfg.d_model), dtype=cfg.dtype,
                                         device=device))
        self.final_norm = _frozen(torch.ones(cfg.d_model, device=device))
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms * scale).to(x.dtype)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Transformer:
    """Random weights with the reference's scales: embed N(0, 0.02^2),
    projections N(0, 1/fan_in), norms 1.  Drawn in float32, then cast."""
    model = Transformer(cfg, device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    model.embed.copy_(normal((cfg.vocab, cfg.d_model), 0.02))
    for block in model.layers:
        for name, shape in cfg.proj_shapes().items():
            getattr(block, name).copy_(normal(shape, 1.0 / np.sqrt(shape[0])))
    return model


@torch.no_grad()
def params_from_jax(cfg: ModelConfig, params_np: Dict[str, Any], device=None) -> Transformer:
    """Load the JAX param pytree (``{"embed", "final_norm", "layers": [...]}``
    with numpy leaves) into a ``Transformer``."""
    model = Transformer(cfg, device)

    def load(dst: nn.Parameter, src):
        src = torch.from_numpy(np.array(src, dtype=np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(src.shape)} != {tuple(dst.shape)}")
        dst.copy_(src)

    load(model.embed, params_np["embed"])
    load(model.final_norm, params_np["final_norm"])
    if len(params_np["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(params_np['layers'])} layers, config has {cfg.n_layers}")
    for block, layer in zip(model.layers, params_np["layers"]):
        for name in ("ln1", "ln2") + _PROJ:
            load(getattr(block, name), layer[name])
    return model
