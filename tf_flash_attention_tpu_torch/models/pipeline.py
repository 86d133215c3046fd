"""Pipeline parallelism (GPipe) over a ``pipe`` mesh axis (PyTorch port of
the JAX package's ``models/pipeline.py``).

The decoder's layers are split into equal stages, stage ``s`` applying
layers ``s·per … s·per + per − 1`` on the device at index ``s`` of the
``pipe`` axis; microbatches, contiguous row blocks of each data shard's
batch, stream through the stages, each activation handed to the next
stage's device with a differentiable ``.to`` (JAX's ``ppermute``).  The
schedule is GPipe's: with ``M`` microbatches and ``S`` stages the loop runs
``M + S − 1`` ticks, and stage ``s`` runs on the ticks ``t`` where ``0 ≤ t −
s < M``.  The JAX package computes every stage on every tick and masks the
bubble ticks out of the loss; those ticks reach no output, so skipping them
computes the same function.  Data parallelism composes on an outer
``data`` axis (batch sharded, stage weights shared).  The backward pass is
autograd through the loop.

Single-controller, as ``parallel/mesh.py`` says: one process drives every
stage, the devices may repeat (``cuda:0`` eight times), and each stage's
weights are the one float32 master's, seen on its device.

As in the JAX package, the pipeline drops an MoE layer's load-balancing
loss: an MoE model's pipeline loss is its cross entropy alone.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import AXIS_DATA, Mesh, shard
from ..serving.graphs import GraphedTrainStep, capture_device
from .transformer import (ModelConfig, Transformer, _attention_block, _logits, _mlp_block,
                          _rms_norm, params_from_jax)

__all__ = ["AXIS_PIPE", "StagedTransformer", "stack_stage_params", "stages_from_jax",
           "pipeline_loss_fn", "make_pipeline_train_step"]

AXIS_PIPE = "pipe"


class StagedTransformer(nn.Module):
    """The decoder's parameters by stage: ``embed``, ``final_norm`` and
    ``stages[s][j]``, the ``Block`` of layer ``s·per + j``."""

    def __init__(self, cfg: ModelConfig, embed: nn.Parameter, final_norm: nn.Parameter,
                 stages):
        super().__init__()
        self.cfg = cfg
        self.embed, self.final_norm = embed, final_norm
        self.stages = nn.ModuleList(nn.ModuleList(blocks) for blocks in stages)


def stack_stage_params(cfg: ModelConfig, params: Transformer, n_stages: int) -> StagedTransformer:
    """``params`` by stage: stage ``s`` holds layers ``s·per … s·per + per −
    1``.  The embedding, the final norm and the blocks are ``params``' own
    (no copy), so a step on either moves both."""
    L = cfg.n_layers
    if L % n_stages:
        raise ValueError(f"n_layers {L} not divisible by n_stages {n_stages}")
    per = L // n_stages
    return StagedTransformer(cfg, params.embed, params.final_norm,
                             [[params.layers[s * per + j] for j in range(per)]
                              for s in range(n_stages)])


def stages_from_jax(cfg: ModelConfig, stacked_np: Dict[str, Any], device=None) -> StagedTransformer:
    """Load the JAX package's ``stack_stage_params`` pytree (``layers[j]``'s
    leaves with a leading ``n_stages`` axis; numpy leaves) into a
    ``StagedTransformer`` on ``device`` (the card when None)."""
    layers = stacked_np["layers"]
    n_stages = int(np.shape(layers[0]["ln1"])[0])

    def take(tree, s):
        return {k: take(v, s) if isinstance(v, dict) else v[s] for k, v in tree.items()}

    flat = [take(layers[j], s) for s in range(n_stages) for j in range(len(layers))]
    params = params_from_jax(cfg, dict(stacked_np, layers=flat), device)
    return stack_stage_params(cfg, params, n_stages)


class _On:
    """A module's parameters seen on ``device``: differentiable copies
    where the device differs, the parameters themselves where not."""

    def __init__(self, module: nn.Module, device):
        self._module, self._device = module, device

    def __getattr__(self, name):
        v = getattr(self._module, name)
        return _On(v, self._device) if isinstance(v, nn.Module) else v.to(self._device)


def _stage_apply(cfg: ModelConfig, blocks, x: torch.Tensor) -> torch.Tensor:
    """A stage's layers on ``x``, on its device; the MoE aux is dropped, as
    in the JAX package."""
    for layer in blocks:
        layer = _On(layer, x.device)
        x = _attention_block(cfg, layer, x)
        x, _ = _mlp_block(cfg, layer, x)
    return x


def pipeline_loss_fn(cfg: ModelConfig, mesh: Mesh, n_microbatches: int,
                     data_axis: str = AXIS_DATA, pipe_axis: str = AXIS_PIPE):
    """``loss(staged, tokens) -> scalar`` with pp (+ dp) over ``mesh``: the
    mean next-token cross entropy of ``tokens (batch, seq + 1)``, each data
    shard's the sum of its microbatches' means over ``M``, averaged over the
    data shards (on the parameters' device)."""
    M = n_microbatches
    devs = mesh.grid(data_axis, pipe_axis)
    n_stages = len(devs[0])

    def loss(staged: StagedTransformer, tokens: torch.Tensor) -> torch.Tensor:
        if len(staged.stages) != n_stages:
            raise ValueError(f"{len(staged.stages)} stages, the {pipe_axis!r} axis has "
                             f"{n_stages}")
        home = staged.embed.device
        total = None
        for row, toks in zip(devs, shard(tokens, mesh, (data_axis, None))):
            B = toks.shape[0]
            if B % M:
                raise ValueError(f"local batch {B} not divisible by microbatches {M}")
            T = toks.shape[1] - 1
            inputs = toks[:, :-1].reshape(M, B // M, T)
            targets = toks[:, 1:].reshape(M, B // M, T).to(row[-1])
            buf, acc = {}, None
            for tick in range(M + n_stages - 1):
                handed = {}
                for s in range(n_stages):
                    m = tick - s
                    if not 0 <= m < M:        # a bubble tick: no work for this stage
                        continue
                    x = (staged.embed.to(row[0]).to(cfg.dtype)[inputs[m]] if s == 0
                         else buf.pop(s))
                    x = _stage_apply(cfg, staged.stages[s], x)
                    if s + 1 < n_stages:
                        handed[s + 1] = x.to(row[s + 1])
                        continue
                    h = _rms_norm(x, staged.final_norm.to(x.device))
                    logp = torch.log_softmax(_logits(staged, h), dim=-1)
                    nll = -torch.gather(logp, -1, targets[m][..., None])[..., 0]
                    acc = nll.mean() if acc is None else acc + nll.mean()
                buf = handed
            shard_loss = (acc / M).to(home)
            total = shard_loss if total is None else total + shard_loss
        return total / len(devs)

    return loss


def make_pipeline_train_step(cfg: ModelConfig, mesh: Mesh, optimizer: torch.optim.Optimizer,
                             n_microbatches: int, data_axis: str = AXIS_DATA,
                             pipe_axis: str = AXIS_PIPE):
    """The pp (+ dp) train step over a ``StagedTransformer``: ``(step,
    placements)``, ``step(staged, tokens) -> loss`` (one optimizer step in
    place, ``optimizer`` over the staged parameters), ``placements(staged)``
    the JAX package's shardings as ``param_shardings`` gives them: the
    embedding and the final norm replicated, every stage leaf over
    ``pipe``.  As ``make_sharded_train_step``: on a mesh of one CUDA device
    the step is a ``GraphedTrainStep`` (one graph holds all ``M +
    n_stages - 1`` ticks, whose schedule is static per shape) and needs a
    capturable ``optimizer``; on the CPU and over several CUDA devices it
    runs eagerly."""
    loss_fn = pipeline_loss_fn(cfg, mesh, n_microbatches, data_axis, pipe_axis)

    def placements(staged: StagedTransformer) -> Dict[str, Any]:
        def leaves(module):
            out = {n: (pipe_axis,) for n, _ in module.named_parameters(recurse=False)}
            out.update({n: leaves(m) for n, m in module.named_children()})
            return out
        return {"embed": (), "final_norm": (), "layers": [leaves(b) for b in staged.stages[0]]}

    mesh.require_single_controller("make_pipeline_train_step")
    device = capture_device(mesh.devices.flat)
    if device is not None:
        return GraphedTrainStep(loss_fn, optimizer, device), placements

    def step(staged: StagedTransformer, tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(staged, tokens)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step, placements
