"""Mixture-of-Experts FFN, GShard-style top-1 (PyTorch port of the JAX
package's ``models/moe.py``).

Each token goes to the expert of its largest router probability, its gate
that probability; an expert takes at most ``capacity`` tokens of a batch
row, in sequence order, and the tokens past it are dropped (their output
is 0).  The router, the experts and the auxiliary load-balancing loss run
in float32 on float32 weights whatever the model's dtype, and ``y`` is cast
back to the input's dtype, as in the JAX package.

The JAX package dispatches and combines with einsums against one-hot
``(b, s, E, C)`` tensors.  Each ``(token, feature)`` of those einsums has
exactly one nonzero term, so gathering each kept token's row into its
``(E, b, C, d)`` slot, and multiplying its expert's output row by its gate,
gives the same float32 values without the one-hot tensors (at the
training slice, b 8, s 2,048, E 4, C 640, d 1,024, each would be 168 MB
held for the backward, and the two einsums ≈ 172 GFLOP a layer).
``moe_ffn`` takes that index form; ``moe_ffn_onehot`` keeps the one-hot
form as the plain version the tests hold it against.

Expert parallelism (``models/transformer.py``'s sharded step) routes the
whole sequence once (``route``) and runs each model shard's experts with
``expert_outputs``; ``aux_loss`` forms the loss from counts and
probability sums added over the data shards (over a process group, over
every rank, each rank's own tokens').
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MoEConfig", "MoE", "init_moe_params", "moe_ffn", "moe_ffn_onehot", "route",
           "expert_outputs", "aux_loss"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 4
    d_model: int = 512
    d_ff: int = 1024
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2

    def shapes(self) -> dict:
        E, d, f = self.n_experts, self.d_model, self.d_ff
        return {"router": (d, E), "w_in": (E, d, f), "w_out": (E, f, d)}


class MoE(nn.Module):
    """The expert FFN's float32 parameters: ``router`` (d_model, E),
    ``w_in`` (E, d_model, d_ff), ``w_out`` (E, d_ff, d_model), on the card
    unless ``device`` says otherwise."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        device = torch.device("cuda") if device is None else torch.device(device)
        for name, shape in cfg.shapes().items():
            setattr(self, name, nn.Parameter(torch.zeros(shape, device=device)))


@torch.no_grad()
def init_moe_params(cfg: MoEConfig, generator: Optional[torch.Generator] = None,
                    device=None) -> MoE:
    """Random parameters with the reference's scales: the router and
    ``w_in`` N(0, 1/d_model), ``w_out`` N(0, 1/d_ff), on ``device`` (the
    card when None).  A ``generator`` must live on that device."""
    params = MoE(cfg, device)
    for name, shape in cfg.shapes().items():
        p = getattr(params, name)
        p.copy_(torch.randn(shape, generator=generator, device=p.device)
                / np.sqrt(shape[-2]))
    return params


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(x, n)`` by a comparison: the same int64 values, without
    the range check ``F.one_hot`` reads on the host for a CPU tensor (a
    training step holds no host sync, which its CPU test checks)."""
    return (x[..., None] == torch.arange(n, device=x.device)).long()


class Routing(NamedTuple):
    """Top-1 routing of ``(b, s)`` tokens: ``probs`` (b, s, E) float32,
    ``expert`` and ``position`` (b, s) int64 (the token's place in its
    expert's queue of its batch row), ``gate`` (b, s) float32, ``keep`` (b,
    s) bool (position under ``capacity``)."""

    probs: torch.Tensor
    expert: torch.Tensor
    position: torch.Tensor
    gate: torch.Tensor
    keep: torch.Tensor
    capacity: int

    def to(self, device) -> "Routing":
        return Routing(*(t.to(device) for t in self[:-1]), self.capacity)

    def sums(self, lo: int = 0, hi: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each expert's count of kept tokens and sum of probabilities
        (float32, (E,)) over sequence positions ``lo .. hi - 1`` (all by
        default): what ``aux_loss`` takes."""
        E = self.probs.shape[-1]
        at = slice(lo, hi)
        kept = _one_hot(self.expert[:, at], E).float() * self.keep[:, at, None].float()
        return kept.sum(dim=(0, 1)), self.probs[:, at].sum(dim=(0, 1))


def route(cfg: MoEConfig, router: torch.Tensor, x: torch.Tensor) -> Routing:
    """Route ``x (b, s, d)``: float32 logits and softmax, the argmax (the
    first of equal probabilities, as ``jnp.argmax``), the queue position by
    a cumsum along ``s``.  Gradients reach the gate and the probabilities,
    never the choices."""
    b, s, _ = x.shape
    E = cfg.n_experts
    capacity = max(1, int(cfg.capacity_factor * s / E))
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(-1, expert[..., None])[..., 0]
    queue = torch.cumsum(_one_hot(expert, E), dim=1)
    position = queue.gather(-1, expert[..., None])[..., 0] - 1
    return Routing(probs, expert, position, gate, position < capacity, capacity)


def expert_outputs(r: Routing, x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
                   first: int = 0) -> torch.Tensor:
    """The float32 output rows ``(b, s, d)`` of the tokens that experts
    ``first .. first + w_in.shape[0] - 1`` keep (0 for every other token):
    each kept token's row gathered into its ``(expert, b, C)`` slot,
    ``gelu_tanh(slots @ w_in) @ w_out`` per expert, each token's output row
    times its gate."""
    b, s, d = x.shape
    E, C = w_in.shape[0], r.capacity
    mine = r.keep & (r.expert >= first) & (r.expert < first + E)
    rows = torch.arange(b, device=x.device)[:, None]
    slot = (((r.expert - first) * b + rows) * C + r.position).masked_fill(~mine, 0)
    # the token each (expert, b, C) slot holds, b * s (a zero row) where
    # none: the kept tokens' slots are distinct, and the others write a spare
    # last entry, so no host sync picks the kept ones (a step of the serving
    # engine is captured as a CUDA graph)
    n_slots = E * b * C
    src = torch.full((n_slots + 1,), b * s, dtype=torch.long, device=x.device)
    src.scatter_(0, torch.where(mine, slot, n_slots).reshape(-1),
                 torch.arange(b * s, device=x.device))
    flat = torch.cat([x.reshape(b * s, d).float(), x.new_zeros((1, d), dtype=torch.float32)])
    slots = flat[src[:n_slots]].reshape(E, b * C, d)
    h = F.gelu(torch.bmm(slots, w_in.float()), approximate="tanh")
    out = torch.bmm(h, w_out.float()).reshape(E * b * C, d)
    return torch.where(mine[..., None], out[slot] * r.gate[..., None], 0.0)


def aux_loss(cfg: MoEConfig, routed: torch.Tensor, prob_sums: torch.Tensor,
             n_tokens: int) -> torch.Tensor:
    """The GShard load-balancing loss from each expert's count of kept
    tokens and sum of router probabilities over ``n_tokens`` tokens (sums
    over every data shard: the means do not average over shards)."""
    E = cfg.n_experts
    return cfg.aux_loss_weight * E * E * torch.mean((routed / n_tokens) * (prob_sums / n_tokens))


def moe_ffn(cfg: MoEConfig, params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the expert FFN to ``x (b, s, d)`` (``params`` holds ``router``,
    ``w_in`` and ``w_out``).  Returns ``(y, aux)``: ``y`` of ``x``'s shape
    and dtype, ``aux`` the float32 load-balancing loss."""
    b, s, _ = x.shape
    r = route(cfg, params.router, x)
    y = expert_outputs(r, x, params.w_in, params.w_out).to(x.dtype)
    return y, aux_loss(cfg, *r.sums(), b * s)


def moe_ffn_onehot(cfg: MoEConfig, params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` by the JAX package's one-hot dispatch and combine einsums
    (the plain version of the index form)."""
    b, s, _ = x.shape
    E = cfg.n_experts
    r = route(cfg, params.router, x)
    onehot = F.one_hot(r.expert, E).float()
    keep = onehot * r.keep[..., None].float()
    pos = F.one_hot(r.position.clamp(0, r.capacity - 1), r.capacity).float()
    dispatch = keep[..., None] * pos[:, :, None, :]                     # (b, s, E, C)
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, x.float())
    h = F.gelu(torch.einsum("ebcd,edf->ebcf", expert_in, params.w_in.float()),
               approximate="tanh")
    expert_out = torch.einsum("ebcf,efd->ebcd", h, params.w_out.float())
    combine = dispatch * r.gate[..., None, None]
    y = torch.einsum("bsec,ebcd->bsd", combine, expert_out).to(x.dtype)
    frac_routed = keep.mean(dim=(0, 1))
    mean_prob = r.probs.mean(dim=(0, 1))
    return y, cfg.aux_loss_weight * E * E * torch.mean(frac_routed * mean_prob)
