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
``data`` axis (batch sharded, stage weights shared).

On either kind of mesh (``parallel/mesh.py``).  Single-controller: one
process drives every stage, the devices may repeat (``cuda:0`` eight
times), each stage's weights are the one float32 master's, seen on its
device, and the backward pass is autograd through the loop.  Over a
process group each rank holds its stage's layers and the replicated
embedding and final norm (``slot_stages``) and runs the same ticks: a live
tick applies its stage, and each tick's hand-offs are one
``collectives.ppermute`` along ``pipe`` of the live stages' outputs (JAX's
``ppermute`` with perm ``(i, i + 1)``).  Autograd would run a hand-off's
backward only on the ranks whose received activation reached their loss,
and the last stage alone holds a loss, so the backward is an explicit
reverse loop over the ticks (the usual PyTorch pipeline): each live tick
keeps its stage's input (a leaf) and output, the output's gradient comes
from the next stage (or, on the last, from the loss), ``backward()`` runs
the stage, and the input's gradient goes back to the previous stage along
the inverse permutation.  The loss that the step returns carries that loop
as its ``backward()``, so a step is "loss, then ``backward()``" on both
kinds of mesh; ``sync_stage_gradients`` then sums the gradients over
``data``, and the embedding's and final norm's over ``pipe`` too.

As in the JAX package, the pipeline drops an MoE layer's load-balancing
loss: an MoE model's pipeline loss is its cross entropy alone.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..parallel.collectives import all_gather, ppermute, psum, psum_gradients
from ..parallel.mesh import AXIS_DATA, Mesh, shard
from ..serving.graphs import graph_train_step
from .transformer import (Block, ModelConfig, Transformer, _attention_block, _filled, _logits,
                          _mlp_block, _rms_norm, params_from_jax)

__all__ = ["AXIS_PIPE", "StagedTransformer", "stack_stage_params", "stages_from_jax",
           "slot_stages", "gather_stages", "pipeline_loss_fn", "sync_stage_gradients",
           "make_pipeline_train_step"]

AXIS_PIPE = "pipe"


class StagedTransformer(nn.Module):
    """The decoder's parameters by stage: ``embed``, ``final_norm`` and
    ``stages[s][j]``, the ``Block`` of layer ``s·per + j`` (over a process
    group, a rank's ``slot_stages``: ``stages[0]`` its own stage's)."""

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


def _staged(cfg: ModelConfig, embed: torch.Tensor, final_norm: torch.Tensor,
            stages) -> StagedTransformer:
    """A ``StagedTransformer`` of the tensors given, ``stages[s][j]`` a
    ``Block``'s by name."""
    return StagedTransformer(cfg, nn.Parameter(embed), nn.Parameter(final_norm),
                             [[_filled(Block(cfg, "meta"), b) for b in stage] for stage in stages])


@torch.no_grad()
def slot_stages(staged: StagedTransformer, mesh: Mesh,
                pipe_axis: str = AXIS_PIPE) -> StagedTransformer:
    """The parameters the caller's pipeline step takes on ``mesh`` (JAX's
    ``device_put`` with the step's shardings, seen from one process): over
    a process group a copy on the caller's device of its stage's layers
    (``stages[0]``) and of the embedding and the final norm; single-
    controller, ``staged`` itself."""
    if not mesh.process_group:
        return staged
    copy = lambda p: p.detach().to(mesh.device, copy=True)
    mine = staged.stages[mesh.axis(pipe_axis).index]
    return _staged(staged.cfg, copy(staged.embed), copy(staged.final_norm),
                   [[{n: copy(p) for n, p in b.named_parameters()} for b in mine]])


@torch.no_grad()
def gather_stages(slot: StagedTransformer, mesh: Mesh, pipe_axis: str = AXIS_PIPE,
                  grads: bool = False) -> StagedTransformer:
    """``slot_stages``' inverse: every stage's layers gathered over the pipe
    line onto the caller's device (or, with ``grads``, every parameter's
    gradient, zeros where None, as the parameters of the result); a
    collective call over a process group.  Single-controller: ``slot``
    itself (with ``grads``, a copy holding its gradients)."""
    if not mesh.process_group and not grads:
        return slot
    pick = lambda p: ((p.grad if p.grad is not None else torch.zeros_like(p)) if grads
                      else p).detach().clone()
    if mesh.process_group:
        pipe = mesh.axis(pipe_axis)
        layers = [{n: all_gather([pick(p)], pipe) for n, p in b.named_parameters()}
                  for b in slot.stages[0]]
        stages = [[{n: ts[s] for n, ts in layer.items()} for layer in layers]
                  for s in range(pipe.size)]
    else:
        stages = [[{n: pick(p) for n, p in b.named_parameters()} for b in stage]
                  for stage in slot.stages]
    return _staged(slot.cfg, pick(slot.embed), pick(slot.final_norm), stages)


class _LoopBackward(torch.autograd.Function):
    """``value`` whose ``backward()`` runs ``run(grad)``: a loss whose
    gradients reach the parameters by an explicit loop (the pipeline's
    reverse ticks) rather than by autograd through the value; ``anchor``
    (a parameter) makes autograd call it."""

    @staticmethod
    def forward(ctx, run, anchor, value):
        ctx.run = run
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        ctx.run(grad)
        return None, None, None


def _rank_pipeline_loss(cfg: ModelConfig, mesh: Mesh, M: int, data_axis: str, pipe_axis: str):
    """``pipeline_loss_fn`` over a process group (the module's docstring)."""
    data, pipe = mesh.axis(data_axis), mesh.axis(pipe_axis)
    S, s = pipe.size, pipe.index
    ticks = M + S - 1
    live = lambda stage, tick: 0 <= tick - stage < M
    # the hand-offs after each tick: every live stage but the last to the next
    handoffs = [[(r, r + 1) for r in range(S - 1) if live(r, t)] for t in range(ticks)]

    def loss(staged: StagedTransformer, tokens: torch.Tensor) -> torch.Tensor:
        if len(staged.stages) != 1:
            raise ValueError(f"{len(staged.stages)} stages on a rank: it holds its own "
                             f"(slot_stages)")
        toks = shard(tokens, mesh, (data_axis, None))
        B, T = toks.shape[0], toks.shape[1] - 1
        if B % M:
            raise ValueError(f"local batch {B} not divisible by microbatches {M}")
        inputs = toks[:, :-1].reshape(M, B // M, T)
        targets = toks[:, 1:].reshape(M, B // M, T)
        blank = torch.zeros((B // M, T, cfg.d_model), dtype=cfg.dtype, device=toks.device)
        held, buf, acc = [], blank, torch.zeros((), device=toks.device)
        for tick in range(ticks):
            out = None
            if live(s, tick):
                m = tick - s
                leaf = None if s == 0 else buf.detach().requires_grad_()
                x = staged.embed.to(cfg.dtype)[inputs[m]] if s == 0 else leaf
                out = _stage_apply(cfg, staged.stages[0], x)
                if s == S - 1:
                    h = _rms_norm(out, staged.final_norm)
                    logp = torch.log_softmax(_logits(staged, h), dim=-1)
                    out = (-torch.gather(logp, -1, targets[m][..., None])).mean()
                    acc = acc + out.detach()
                held.append((leaf, out))
            if handoffs[tick]:
                send = out.detach() if out is not None and s < S - 1 else blank
                buf = ppermute([send], pipe, handoffs[tick])[0]
        # only the last stage holds a loss: the pipe sum shares it (JAX
        # pipeline.py:112-115), then the mean over the data shards
        value = psum([psum([acc], pipe) / M], data) / data.size

        def backward(grad):
            # d value / d acc: the data mean's, then the pipe sum's over M
            coef = grad / data.size / M
            grad_in = None
            for tick in reversed(range(ticks)):
                if handoffs[tick]:
                    # the gradients of this tick's hand-offs come back from
                    # the inputs of the next tick's stages
                    send = grad_in if live(s, tick + 1) and s > 0 else blank
                    d_out = ppermute([send], pipe, [(b, a) for a, b in handoffs[tick]])[0]
                if live(s, tick):
                    leaf, out = held.pop()
                    torch.autograd.backward(out, coef if s == S - 1 else d_out)
                    grad_in = None if leaf is None else leaf.grad

        return _LoopBackward.apply(backward, staged.final_norm, value)

    return loss


def pipeline_loss_fn(cfg: ModelConfig, mesh: Mesh, n_microbatches: int,
                     data_axis: str = AXIS_DATA, pipe_axis: str = AXIS_PIPE):
    """``loss(staged, tokens) -> scalar`` with pp (+ dp) over ``mesh``: the
    mean next-token cross entropy of ``tokens (batch, seq + 1)``, each data
    shard's the sum of its microbatches' means over ``M``, averaged over the
    data shards (on the parameters' device; over a process group, the same
    number on every rank, its ``backward()`` the reverse ticks)."""
    M = n_microbatches
    if mesh.process_group:
        return _rank_pipeline_loss(cfg, mesh, M, data_axis, pipe_axis)
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


def sync_stage_gradients(staged: StagedTransformer, mesh: Mesh, data_axis: str = AXIS_DATA,
                         pipe_axis: str = AXIS_PIPE) -> None:
    """Over a process group, after ``backward()``: the stage's gradients
    summed over ``data``, the embedding's and the final norm's (stage 0's
    lookup, the last stage's logits and norm) over ``pipe`` and then
    ``data``, in shard order, as JAX's transposes of the replicated inputs
    sum them.  Nothing on a single-controller mesh."""
    if not mesh.process_group:
        return
    lines = lambda *names: [mesh.axis(n) for n in names if int(mesh.shape.get(n, 1)) > 1]
    psum_gradients([staged.embed, staged.final_norm], lines(pipe_axis, data_axis))
    psum_gradients([p for stage in staged.stages for p in stage.parameters()], lines(data_axis))


def make_pipeline_train_step(cfg: ModelConfig, mesh: Mesh, optimizer: torch.optim.Optimizer,
                             n_microbatches: int, data_axis: str = AXIS_DATA,
                             pipe_axis: str = AXIS_PIPE):
    """The pp (+ dp) train step over a ``StagedTransformer``: ``(step,
    placements)``, ``step(staged, tokens) -> loss`` (one optimizer step in
    place, ``optimizer`` over the staged parameters), ``placements(staged)``
    the JAX package's shardings as ``param_shardings`` gives them: the
    embedding and the final norm replicated, every stage leaf over
    ``pipe``.  Over a process group every rank calls ``step`` with its
    ``slot_stages`` (``optimizer`` over them) and the whole ``tokens``.  As
    ``make_sharded_train_step``: where the devices the caller drives are
    CUDA devices (one card, or a stage a card across several) the step is a
    ``GraphedTrainStep`` (one graph holds all ``M + n_stages - 1`` ticks,
    whose schedule is static per shape, and the hand-offs between the
    cards; a gloo group's refuses, and ``step.eager`` runs it) and needs a
    capturable ``optimizer``; on the CPU it runs eagerly."""
    loss_fn = pipeline_loss_fn(cfg, mesh, n_microbatches, data_axis, pipe_axis)
    sync = None
    if mesh.process_group:
        sync = lambda staged: sync_stage_gradients(staged, mesh, data_axis, pipe_axis)

    def placements(staged: StagedTransformer) -> Dict[str, Any]:
        def leaves(module):
            out = {n: (pipe_axis,) for n, _ in module.named_parameters(recurse=False)}
            out.update({n: leaves(m) for n, m in module.named_children()})
            return out
        return {"embed": (), "final_norm": (), "layers": [leaves(b) for b in staged.stages[0]]}

    return graph_train_step(loss_fn, optimizer, mesh, sync), placements
