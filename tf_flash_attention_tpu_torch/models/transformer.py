"""The flagship decoder-only transformer (PyTorch port).

Counterpart of the JAX package's ``models/transformer.py`` on one device:
``ModelConfig``, the parameters as an ``nn.Module``, ``init_params`` with
the reference's scales, ``params_from_jax`` (loads the JAX parameter pytree
of numpy arrays), and the training path: ``forward`` (rotary embedding,
rule-masked attention through ``parallel.sharded.mha``, gated MLP),
``loss_fn`` (next-token cross entropy) and ``train_step``.

Parameters are float32 ``nn.Parameter``s, as in the JAX package, and are
cast to ``cfg.dtype`` at each use; norm math runs in float32.  The serving
engine casts once, when it is built (``inference_weights``), which gives
the same values.  Weights keep the JAX layout (in, out): a projection is
``x @ w``.

Not ported (each raises ``NotImplementedError``; see ROADMAP): the
sharded step (``mesh``), context parallelism, MoE.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..block_sizes import BlockConfig
from ..mask_rules import CausalRule, MaskRule
from ..parallel.sharded import mha

__all__ = ["ModelConfig", "Transformer", "init_params", "params_from_jax",
           "inference_weights", "forward", "loss_fn", "train_step"]

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
    max_seq: int = 1024
    dtype: torch.dtype = torch.bfloat16
    rule: MaskRule = dataclasses.field(default_factory=CausalRule)
    block_config: Optional[BlockConfig] = None
    n_experts: int = 0
    context_parallel: bool = False

    def __post_init__(self):
        if self.n_experts:
            raise NotImplementedError("MoE is not ported yet (ROADMAP queue 1: models)")
        if self.context_parallel:
            raise NotImplementedError("context parallelism (ring attention) is not ported "
                                      "yet (ROADMAP queue 1 item 11)")

    @property
    def rope_theta(self) -> float:
        return 10000.0

    def proj_shapes(self) -> Dict[str, tuple]:
        dq, dkv = self.n_heads * self.d_head, self.n_kv_heads * self.d_head
        return {"wq": (self.d_model, dq), "wk": (self.d_model, dkv),
                "wv": (self.d_model, dkv), "wo": (dq, self.d_model),
                "w1": (self.d_model, self.d_ff), "w3": (self.d_model, self.d_ff),
                "w2": (self.d_ff, self.d_model)}


class Block(nn.Module):
    """One decoder layer's parameters."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        for name, shape in cfg.proj_shapes().items():
            setattr(self, name, nn.Parameter(torch.zeros(shape, device=device)))


class Transformer(nn.Module):
    """Parameters of the decoder: ``embed`` (vocab, d_model), ``final_norm``
    and per-layer ``ln1, ln2, wq, wk, wv, wo, w1, w3, w2``, all float32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.zeros((cfg.vocab, cfg.d_model), device=device))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms * scale).to(x.dtype)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Transformer:
    """Random parameters with the reference's scales: embed N(0, 0.02^2),
    projections N(0, 1/fan_in), norms 1."""
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


@torch.no_grad()
def inference_weights(model: Transformer, device=None) -> Transformer:
    """A frozen copy on ``device`` with the embedding and projections cast
    to ``cfg.dtype`` once (the values a per-use cast gives); norm scales
    stay float32."""
    out = copy.deepcopy(model).to(device)
    dtype = model.cfg.dtype
    out.embed.data = out.embed.data.to(dtype)
    for block in out.layers:
        for name in _PROJ:
            p = getattr(block, name)
            p.data = p.data.to(dtype)
    return out.requires_grad_(False)


def _rope(x: torch.Tensor, theta: float, pos0: int = 0) -> torch.Tensor:
    """Rotary embedding (half-split rotation) on (b, h, s, d_head)."""
    s, d = x.shape[-2], x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    pos = pos0 + torch.arange(s, dtype=torch.float32, device=x.device)
    angles = pos[:, None] * torch.from_numpy(freqs).to(x.device)[None, :]
    cos, sin = torch.cos(angles).to(x.dtype), torch.sin(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def _attention_block(cfg: ModelConfig, layer: Block, x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    h = _rms_norm(x, layer.ln1)
    q = _proj(h, layer.wq).reshape(b, s, cfg.n_heads, cfg.d_head).transpose(1, 2)
    k = _proj(h, layer.wk).reshape(b, s, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    v = _proj(h, layer.wv).reshape(b, s, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    q = _rope(q, cfg.rope_theta)
    k = _rope(k, cfg.rope_theta)
    o = mha(q, k, v, rule=cfg.rule, block_config=cfg.block_config)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
    return x + _proj(o, layer.wo)


def _mlp_block(cfg: ModelConfig, layer: Block, x: torch.Tensor) -> torch.Tensor:
    h = _rms_norm(x, layer.ln2)
    gated = F.silu(_proj(h, layer.w1)) * _proj(h, layer.w3)
    return x + _proj(gated, layer.w2)


def _one_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("the sharded train step (mesh) is not ported yet "
                                  "(ROADMAP queue 1 items 11 and 13)")


def forward(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, *,
            mesh=None) -> torch.Tensor:
    """Token ids ``(batch, seq)`` -> float32 logits ``(batch, seq, vocab)``."""
    _one_device(mesh)
    x = params.embed.to(cfg.dtype)[tokens]
    for layer in params.layers:
        x = _attention_block(cfg, layer, x)
        x = _mlp_block(cfg, layer, x)
    x = _rms_norm(x, params.final_norm)
    return (x @ params.embed.to(x.dtype).T).float()


def loss_fn(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, *,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy over ``tokens (batch, seq + 1)``."""
    logits = forward(cfg, params, tokens[:, :-1], mesh=mesh)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
    return nll.mean()


def train_step(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, *,
               optimizer: torch.optim.Optimizer, mesh=None) -> torch.Tensor:
    """One optimizer step on ``params`` in place; returns the loss (before
    the step)."""
    _one_device(mesh)
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(cfg, params, tokens)
    loss.backward()
    optimizer.step()
    return loss.detach()
