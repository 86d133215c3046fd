"""The flagship decoder-only transformer (PyTorch port).

Counterpart of the JAX package's ``models/transformer.py``:
``ModelConfig``, the parameters as an ``nn.Module``, ``init_params`` with
the reference's scales, ``params_from_jax`` (loads the JAX parameter pytree
of numpy arrays), and the training path: ``forward`` (rotary embedding,
rule-masked attention through ``parallel.sharded.mha``, gated MLP),
``loss_fn`` (next-token cross entropy) and ``train_step``, on one device
or over a ``(data, model, context)`` mesh (``make_sharded_train_step``):

* **dp** — batch sharded over ``data``;
* **tp** — heads and MLP hidden sharded over ``model`` (Megatron column /
  row pairs, ``param_shardings``): each shard multiplies by its slice of
  the weights, and the ``wo`` / ``w2`` partials add up in shard order, in
  float32 (JAX's ``psum``);
* **sp** — between blocks, the residual stream of each batch shard is held
  as sequence chunks over the ``model`` devices, and the norms run on the
  chunks (Megatron sequence parallelism): placement only, the forward's
  numbers do not change (the norm scales' gradients add the chunks' sums,
  so they move by float32 summation order);
* **cp** — with ``context_parallel=True`` and a ``context`` axis, the
  sequence is sharded over it: each shard applies RoPE at its global
  positions and attention is the differentiable ring
  (``parallel/ring.py``), its K/V rows grouped as GQA;
* **ep** — with ``n_experts``, each layer's MLP is the top-1
  Mixture-of-Experts FFN (``models/moe.py``) and the experts are split over
  ``model``: the batch shard's whole sequence is routed once, model shard
  ``j`` runs experts ``j·E/tp … (j+1)·E/tp − 1`` on its device, and each
  token's output comes from its one expert.  The load-balancing loss is
  formed once from counts and probability sums added over the data shards
  (JAX's MoE runs on the global arrays under GSPMD).

On either kind of mesh (``parallel/mesh.py``).  Single-controller: one
process drives every shard, the devices may repeat (``cuda:0`` eight
times), and each shard's weights are differentiable slices of the one
float32 master, so the gradients and the optimizer's step land on that one
set of parameters.  Over a process group (JAX's multi-controller mode):
each rank holds its slot's parameters (``slot_params``: its model shard's
slices, the rest whole), runs its (data, model, context) block with
``parallel/collectives.py``'s differentiable collectives in the places
where the single-controller code moves tensors between shards (a
column-parallel input's ``pvary`` or, under sp, ``all_gather``; the
partials' ``psum`` or ``psum_scatter``; the ring's ``ppermute``), sums its
token losses with the other ranks', and after ``backward()``
``sync_gradients`` sums each replicated parameter's gradient over the
ranks that saw other tokens; each rank's optimizer steps its own slot, and
``gather_params`` puts the whole model back together.

Parameters are float32 ``nn.Parameter``s, as in the JAX package, and are
cast to ``cfg.dtype`` at each use; norm math runs in float32.  The serving
engine casts once, when it is built (``inference_weights``), which gives
the same values.  Weights keep the JAX layout (in, out): a projection is
``x @ w``.  ``quantize_model_weights`` gives an inference copy whose
projections are weight-only int8 (``ops/quant.py``); ``forward`` runs them
through ``int8_matmul`` (``_proj``).  The serving engine takes dense
weights only, as the JAX engine does.  MoE weights stay float32 everywhere:
the router, the experts and the aux loss run in float32, as in the JAX
package, and ``quantize_model_weights`` leaves them dense.
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
from ..ops.quant import QuantizedTensor, int8_matmul, quantize_weight_int8
from ..parallel.collectives import (LOCAL, Axis, all_gather, all_gather_invariant, psum,
                                    psum_gradients, psum_scatter, pvary)
from ..parallel.mesh import AXIS_CONTEXT, AXIS_DATA, AXIS_MODEL, Mesh, shard
from ..parallel.ring import ring_attention_local
from ..parallel.sharded import mha
from ..serving.graphs import graph_train_step, train_once
from .moe import MoE, MoEConfig, aux_loss, expert_outputs, init_moe_params, moe_ffn, route

__all__ = ["ModelConfig", "Transformer", "init_params", "params_from_jax",
           "inference_weights", "quantize_model_weights", "forward", "loss_fn", "train_step",
           "param_shardings", "slot_params", "gather_params", "sync_gradients",
           "make_sharded_train_step"]

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
    # Mixture-of-Experts FFN (expert parallelism) when n_experts > 0
    n_experts: int = 0
    capacity_factor: float = 1.25
    context_parallel: bool = False

    @property
    def rope_theta(self) -> float:
        return 10000.0

    def proj_shapes(self) -> Dict[str, tuple]:
        """The shapes of a layer's linear projections: attention's, and the
        gated MLP's unless the layer is MoE (whose weights ``moe_cfg``
        gives)."""
        dq, dkv = self.n_heads * self.d_head, self.n_kv_heads * self.d_head
        shapes = {"wq": (self.d_model, dq), "wk": (self.d_model, dkv),
                  "wv": (self.d_model, dkv), "wo": (dq, self.d_model)}
        if not self.n_experts:
            shapes.update({"w1": (self.d_model, self.d_ff), "w3": (self.d_model, self.d_ff),
                           "w2": (self.d_ff, self.d_model)})
        return shapes

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(n_experts=self.n_experts, d_model=self.d_model, d_ff=self.d_ff,
                         capacity_factor=self.capacity_factor)


def _device(device) -> torch.device:
    """``device``, or the CUDA card when it is None: the port runs on the
    card unless the caller asks for the CPU."""
    return torch.device("cuda") if device is None else torch.device(device)


class Block(nn.Module):
    """One decoder layer's parameters (on the card unless ``device`` says
    otherwise); an MoE layer holds ``moe`` (``models/moe.py``) in place of
    ``w1, w3, w2``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = _device(device)
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        for name, shape in cfg.proj_shapes().items():
            setattr(self, name, nn.Parameter(torch.zeros(shape, device=device)))
        if cfg.n_experts:
            self.moe = MoE(cfg.moe_cfg(), device)


class Transformer(nn.Module):
    """Parameters of the decoder: ``embed`` (vocab, d_model), ``final_norm``
    and per-layer ``ln1, ln2, wq, wk, wv, wo`` and ``w1, w3, w2`` (or
    ``moe.router, moe.w_in, moe.w_out``), all float32, on the card unless
    ``device`` says otherwise."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = _device(device)
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
    projections and experts N(0, 1/fan_in), norms 1, on ``device`` (the card
    when None).  A ``generator`` must live on that device."""
    device = _device(device)
    model = Transformer(cfg, device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    model.embed.copy_(normal((cfg.vocab, cfg.d_model), 0.02))
    for block in model.layers:
        for name, shape in cfg.proj_shapes().items():
            getattr(block, name).copy_(normal(shape, 1.0 / np.sqrt(shape[0])))
        if cfg.n_experts:
            block.moe = init_moe_params(cfg.moe_cfg(), generator, device)
    return model


@torch.no_grad()
def params_from_jax(cfg: ModelConfig, params_np: Dict[str, Any], device=None) -> Transformer:
    """Load the JAX param pytree (``{"embed", "final_norm", "layers": [...]}``
    with numpy leaves) into a ``Transformer`` on ``device`` (the card when
    None)."""
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
        for name in ("ln1", "ln2", *cfg.proj_shapes()):
            load(getattr(block, name), layer[name])
        if cfg.n_experts:
            for name in cfg.moe_cfg().shapes():
                load(getattr(block.moe, name), layer["moe"][name])
    return model


def _quantized(model: Transformer) -> bool:
    return any(isinstance(getattr(b, name), QuantizedTensor) for b in model.layers
               for name in model.cfg.proj_shapes())


@torch.no_grad()
def inference_weights(model: Transformer, device=None) -> Transformer:
    """A frozen copy on ``device`` with the embedding and projections cast
    to ``cfg.dtype`` once (the values a per-use cast gives); norm scales
    and MoE weights stay float32 (the experts run in float32)."""
    if _quantized(model):
        raise TypeError("the serving engine takes dense weights, as the JAX engine does "
                        "(quantize_model_weights is for forward)")
    out = copy.deepcopy(model).to(device)
    dtype = model.cfg.dtype
    out.embed.data = out.embed.data.to(dtype)
    for block in out.layers:
        for name in model.cfg.proj_shapes():
            p = getattr(block, name)
            p.data = p.data.to(dtype)
    return out.requires_grad_(False)


@torch.no_grad()
def quantize_model_weights(model: Transformer) -> Transformer:
    """Weight-only int8 for the linear projections (inference path): a copy
    of ``model`` whose ``wq, wk, wv, wo, w1, w2, w3`` are ``QuantizedTensor``s
    (int8 codes and per-output-channel float32 scales), on the same device;
    ``forward`` multiplies them with ``int8_matmul``.  MoE weights stay
    dense, as in the JAX package."""
    out = copy.deepcopy(model).requires_grad_(False)
    for block in out.layers:
        for name in model.cfg.proj_shapes():
            w = block._parameters.pop(name)
            setattr(block, name, quantize_weight_int8(w))
    return out


#: the rotary embedding's inverse frequencies on a device, by (d, theta,
#: device): uploaded once, so a step makes no tensor from host data (a CUDA
#: graph's capture refuses the copy)
_INV_FREQS: Dict[tuple, torch.Tensor] = {}


def _inverse_freqs(d: int, theta: float, device) -> torch.Tensor:
    """Rotary embedding's float32 inverse frequencies (d/2,) on ``device``:
    the JAX package's numpy computation, bit for bit, uploaded on the first
    call for ``(d, theta, device)`` and kept.  A first call during a CUDA
    graph's capture raises: the eager call before a capture uploads them."""
    key = (int(d), float(theta), torch.device(device))
    freqs = _INV_FREQS.get(key)
    if freqs is None:
        if key[2].type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the rotary frequencies were first needed during a CUDA graph "
                               "capture: run the step once before capturing it")
        half = d // 2
        freqs = torch.from_numpy(1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
                                 ).to(key[2])
        _INV_FREQS[key] = freqs
    return freqs


def _rope(x: torch.Tensor, theta: float, pos0: int = 0) -> torch.Tensor:
    """Rotary embedding (half-split rotation) on (b, h, s, d_head)."""
    s, d = x.shape[-2], x.shape[-1]
    half = d // 2
    pos = pos0 + torch.arange(s, dtype=torch.float32, device=x.device)
    angles = pos[:, None] * _inverse_freqs(d, theta, x.device)[None, :]
    cos, sin = torch.cos(angles).to(x.dtype), torch.sin(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _proj(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a dense or a weight-only int8 ``w``."""
    if isinstance(w, QuantizedTensor):
        return int8_matmul(x, w)
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


def _mlp_block(cfg: ModelConfig, layer: Block, x: torch.Tensor):
    """The MLP block: ``(x + mlp(norm(x)), aux)``, aux the MoE layer's
    load-balancing loss (None for a dense layer)."""
    h = _rms_norm(x, layer.ln2)
    if cfg.n_experts:
        y, aux = moe_ffn(cfg.moe_cfg(), layer.moe, h)
        return x + y, aux
    gated = F.silu(_proj(h, layer.w1)) * _proj(h, layer.w3)
    return x + _proj(gated, layer.w2), None


# the tensor-parallel placement of a layer (the JAX package's
# ``param_shardings``): the dim of each weight a ``model`` shard slices
_LAYER_SPECS = {"ln1": (None,), "ln2": (None,),
                "wq": (None, AXIS_MODEL), "wk": (None, AXIS_MODEL), "wv": (None, AXIS_MODEL),
                "wo": (AXIS_MODEL, None),
                "w1": (None, AXIS_MODEL), "w3": (None, AXIS_MODEL), "w2": (AXIS_MODEL, None)}
# expert parallelism: the expert axis over ``model``, the router replicated
_MOE_SPECS = {"router": (None, None), "w_in": (AXIS_MODEL, None, None),
              "w_out": (AXIS_MODEL, None, None)}


def param_shardings(cfg: ModelConfig) -> Dict[str, Any]:
    """The placement of every parameter over a mesh, as the JAX package's
    ``PartitionSpec``s: a tuple a parameter, one entry a dim, ``"model"``
    where a ``model`` shard holds the ``j``-th of ``tp`` equal slices of
    that dim (head-major for q/k/v; the experts of an MoE layer), None
    where it holds all of it; nested as the JAX parameter pytree."""
    layer = {name: _LAYER_SPECS[name] for name in ("ln1", "ln2", *cfg.proj_shapes())}
    if cfg.n_experts:
        layer["moe"] = dict(_MOE_SPECS)
    return {"embed": (None, None), "final_norm": (None,),
            "layers": [dict(layer) for _ in range(cfg.n_layers)]}


def _weight(layer: nn.Module, name: str, j: int, tp: int, device) -> torch.Tensor:
    """Model shard ``j``'s slice of ``layer.<name>`` (of a ``Block`` or its
    ``MoE``) on ``device``: a differentiable view of the master parameter."""
    w = getattr(layer, name)
    spec = (_MOE_SPECS if isinstance(layer, MoE) else _LAYER_SPECS)[name]
    if AXIS_MODEL in spec:
        w = w.chunk(tp, spec.index(AXIS_MODEL))[j]
    return w.to(device)


def _use_cp(cfg: ModelConfig, mesh: Optional[Mesh]) -> bool:
    return (cfg.context_parallel and mesh is not None
            and int(mesh.shape.get(AXIS_CONTEXT, 1)) > 1)


def _sequence_parallel(cfg: ModelConfig, mesh: Mesh) -> bool:
    """Whether the residual stream is held as sequence chunks over the
    ``model`` devices between blocks (JAX's ``sp``): under tp without cp
    (under cp the sequence is already sharded over ``context``)."""
    return not _use_cp(cfg, mesh) and int(mesh.shape.get(AXIS_MODEL, 1)) > 1


def _token_blocks(cfg: ModelConfig, mesh: Mesh, tokens: torch.Tensor):
    """``tokens (batch, seq)`` as ``[data][context]`` blocks (one context
    block without cp), block ``(i, c)`` on the device at mesh index
    ``(i, 0, c)``."""
    if _use_cp(cfg, mesh):
        return shard(tokens, mesh, (AXIS_DATA, AXIS_CONTEXT))
    return [[t] for t in shard(tokens, mesh, (AXIS_DATA, None))]


def _mesh_devices(cfg: ModelConfig, mesh: Mesh):
    """The devices ``[data][model][context]`` (one context index without
    cp), after checking that the model divides over ``model``."""
    tp = int(mesh.shape.get(AXIS_MODEL, 1))
    if cfg.n_experts and cfg.n_experts % tp:
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by the model axis size {tp}")
    if cfg.n_heads % tp or cfg.n_kv_heads % tp or (not cfg.n_experts and cfg.d_ff % tp):
        raise ValueError(f"heads ({cfg.n_heads}/{cfg.n_kv_heads}) or d_ff {cfg.d_ff} not "
                         f"divisible by the model axis size {tp}")
    devs = mesh.grid(AXIS_DATA, AXIS_MODEL, AXIS_CONTEXT)
    return devs if _use_cp(cfg, mesh) else [[col[:1] for col in row] for row in devs]


def _gather(chunks, device) -> torch.Tensor:
    return torch.cat([x.to(device) for x in chunks], dim=1)


def _add_partials(chunks, parts):
    """The residual ``chunks`` plus the sum of the row-parallel ``parts``
    (one a model shard, over the whole sequence), added in float32 in shard
    order and rounded once, each chunk's rows on its own device (JAX's
    ``psum``; a reduce-scatter under sp)."""
    out, lo = [], 0
    for x in chunks:
        hi = lo + x.shape[1]
        acc = None
        for part in parts:
            piece = part[:, lo:hi].to(x.device).float()
            acc = piece if acc is None else acc + piece
        out.append(x + acc.to(x.dtype))
        lo = hi
    return out


def _mesh_attention(cfg: ModelConfig, layer: Block, xs, devs):
    """The attention block of one batch shard: ``xs[c]`` the residual
    chunks of context shard ``c``, ``devs[j][c]`` the devices."""
    tp, cp = len(devs), len(xs)
    hs = [[_rms_norm(x, layer.ln1.to(x.device)) for x in chunks] for chunks in xs]
    parts = [[] for _ in range(cp)]
    for j in range(tp):
        qkv = []
        for c in range(cp):
            h = _gather(hs[c], devs[j][c])
            b, s, _ = h.shape
            heads = lambda name: _proj(h, _weight(layer, name, j, tp, h.device)).reshape(
                b, s, -1, cfg.d_head).transpose(1, 2)
            # RoPE at global positions: context shard c starts at c * s
            qkv.append((_rope(heads("wq"), cfg.rope_theta, c * s),
                        _rope(heads("wk"), cfg.rope_theta, c * s), heads("wv")))
        if cp > 1:
            b, hq, s, d = qkv[0][0].shape
            hkv = qkv[0][1].shape[1]
            os_ = ring_attention_local(
                [q.reshape(b * hq, s, d) for q, _, _ in qkv],
                [k.reshape(b * hkv, s, d) for _, k, _ in qkv],
                [v.reshape(b * hkv, s, -1) for _, _, v in qkv],
                rule=cfg.rule, block_config=cfg.block_config)
            os_ = [o.reshape(b, hq, s, -1) for o in os_]
        else:
            os_ = [mha(*qkv[0], rule=cfg.rule, block_config=cfg.block_config)]
        for c, o in enumerate(os_):
            b, hq, s, _ = o.shape
            o = o.transpose(1, 2).reshape(b, s, hq * cfg.d_head)
            parts[c].append(_proj(o, _weight(layer, "wo", j, tp, o.device)))
    return [_add_partials(chunks, parts[c]) for c, chunks in enumerate(xs)]


def _mesh_mlp(cfg: ModelConfig, layer: Block, xs, devs):
    """The MLP block of one batch shard (``_mesh_attention``'s layout).
    Returns the new chunks and, for an MoE layer, the shard's kept-token
    counts and probability sums by expert (else None)."""
    if cfg.n_experts:
        return _mesh_moe(cfg, layer, xs, devs)
    out = []
    for c, chunks in enumerate(xs):
        hs = [_rms_norm(x, layer.ln2.to(x.device)) for x in chunks]
        parts = []
        for j in range(len(devs)):
            h = _gather(hs, devs[j][c])
            w = lambda name: _weight(layer, name, j, len(devs), h.device)
            parts.append(_proj(F.silu(_proj(h, w("w1"))) * _proj(h, w("w3")), w("w2")))
        out.append(_add_partials(chunks, parts))
    return out, None


def _mesh_moe(cfg: ModelConfig, layer: Block, xs, devs):
    """The MoE block of one batch shard: the normed chunks of its whole
    sequence gathered on its first device and routed once; model shard
    ``j`` runs its ``E / tp`` experts on its device; each token's output
    comes from its one expert (the others' rows are 0, so the combine is
    exact in any order) and goes back to its chunk's device.  Returns the
    chunks and the shard's (kept counts, probability sums) by expert."""
    mcfg, tp = cfg.moe_cfg(), len(devs)
    home = devs[0][0]
    h = _gather([_rms_norm(x, layer.ln2.to(x.device)) for chunks in xs for x in chunks], home)
    r = route(mcfg, layer.moe.router.to(home), h)
    y = None
    for j in range(tp):
        dev = devs[j][0]
        part = expert_outputs(r.to(dev), h.to(dev), _weight(layer.moe, "w_in", j, tp, dev),
                              _weight(layer.moe, "w_out", j, tp, dev),
                              first=j * mcfg.n_experts // tp).to(home)
        y = part if y is None else y + part
    y = y.to(h.dtype)
    out, lo = [], 0
    for chunks in xs:
        new = []
        for x in chunks:
            hi = lo + x.shape[1]
            new.append(x + y[:, lo:hi].to(x.device))
            lo = hi
        out.append(new)
    return out, r.sums()


def _mesh_hidden(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, mesh: Mesh):
    """The final-normed hidden states of every (data, context) block of
    ``tokens``, ``[data][context]``, block ``(i, c)`` on the device at mesh
    index ``(i, 0, c)``, and the MoE layers' summed load-balancing loss on
    the parameters' device (None for a dense model): each layer's from the
    counts and probability sums of every data shard."""
    if _quantized(params):
        raise TypeError("the sharded path takes dense weights")
    devs = _mesh_devices(cfg, mesh)
    sp = _sequence_parallel(cfg, mesh)
    out, stats = [], [[] for _ in params.layers]
    for row, toks in zip(devs, _token_blocks(cfg, mesh, tokens)):   # independent data shards
        xs = []
        for c, t in enumerate(toks):
            x = params.embed.to(t.device).to(cfg.dtype)[t]
            homes = [col[c] for col in row] if sp else [t.device]
            xs.append([p.to(d) for p, d in zip(x.tensor_split(len(homes), dim=1), homes)])
        for i, layer in enumerate(params.layers):
            xs = _mesh_attention(cfg, layer, xs, row)
            xs, st = _mesh_mlp(cfg, layer, xs, row)
            stats[i].append(st)
        out.append([_rms_norm(_gather(chunks, t.device), params.final_norm.to(t.device))
                    for chunks, t in zip(xs, toks)])
    aux = None
    if cfg.n_experts:
        home = params.embed.device
        for st in stats:
            counts = sum(c.to(home) for c, _ in st)
            probs = sum(p.to(home) for _, p in st)
            a = aux_loss(cfg.moe_cfg(), counts, probs, tokens.numel())
            aux = a if aux is None else aux + a
    return out, aux


# ---- over a process group: the caller's (data, model, context) block ----
#
# Each rank runs the same program on its block: its data rows, its
# ``context`` shard under cp, and under sp its chunk of that along ``model``.
# The collectives are ``parallel/collectives.py``'s differentiable ones, so
# ``backward()`` sends each rank's gradients where JAX's transposes send
# them; ``sync_gradients`` then sums each parameter's gradient over the
# axes it is replicated on.


@dataclasses.dataclass(frozen=True)
class _Lines:
    """The caller's lines of a process-group mesh as the step communicates
    over them: an axis the step does not split, or of size 1, is
    ``LOCAL`` (no collective); ``cp``/``sp`` as ``_use_cp`` and
    ``_sequence_parallel``."""

    data: Axis
    model: Axis
    context: Axis
    cp: bool
    sp: bool


def _lines(cfg: ModelConfig, mesh: Mesh) -> _Lines:
    cp, sp = _use_cp(cfg, mesh), _sequence_parallel(cfg, mesh)
    line = lambda name, used=True: (mesh.axis(name) if used and int(mesh.shape.get(name, 1)) > 1
                                    else LOCAL)
    return _Lines(line(AXIS_DATA), line(AXIS_MODEL), line(AXIS_CONTEXT, cp), cp, sp)


def _rank_tokens(cfg: ModelConfig, mesh: Mesh, tokens: torch.Tensor, ax: _Lines):
    """The caller's block of ``tokens (batch, seq)``: its data rows, its
    context shard under cp, its model chunk under sp."""
    x = shard(tokens, mesh, (AXIS_DATA, AXIS_CONTEXT if ax.cp else None))
    if ax.sp:
        if x.shape[1] % ax.model.size:
            raise ValueError(f"sequence {x.shape[1]} does not divide over the model axis "
                             f"({ax.model.size}) for sequence parallelism over processes")
        x = x.chunk(ax.model.size, 1)[ax.model.index]
    return x


def _column_input(h: torch.Tensor, ax: _Lines) -> torch.Tensor:
    """The caller's rows ``h`` as the column-parallel projections take them:
    under sp the model line's chunks gathered into the whole sequence
    (their gradients reduce-scattered), else ``h``, which the line holds
    alike (its gradient summed over the line)."""
    if ax.sp:
        return torch.cat(all_gather([h], ax.model), dim=1)
    return pvary(h, ax.model)


def _row_output(x: torch.Tensor, part: torch.Tensor, ax: _Lines) -> torch.Tensor:
    """``x`` plus the sum over the model line of the row-parallel
    ``part``s, added in float32 in shard order and rounded once
    (``_add_partials``): under sp the caller's chunk of it."""
    part = part.float()
    acc = psum_scatter(part, ax.model, 1) if ax.sp else psum([part], ax.model)
    return x + acc.to(x.dtype)


def _rank_attention(cfg: ModelConfig, layer: Block, x: torch.Tensor, ax: _Lines):
    h = _column_input(_rms_norm(x, layer.ln1), ax)
    b, s, _ = h.shape
    heads = lambda name: _proj(h, getattr(layer, name)).reshape(
        b, s, -1, cfg.d_head).transpose(1, 2)
    # RoPE at global positions: context shard c starts at c * s
    pos0 = ax.context.index * s
    q, k = _rope(heads("wq"), cfg.rope_theta, pos0), _rope(heads("wk"), cfg.rope_theta, pos0)
    v = heads("wv")
    if ax.cp:
        hq, hkv = q.shape[1], k.shape[1]
        o = ring_attention_local([q.reshape(b * hq, s, -1)], [k.reshape(b * hkv, s, -1)],
                                 [v.reshape(b * hkv, s, -1)], rule=cfg.rule,
                                 block_config=cfg.block_config, axis=ax.context)[0]
        o = o.reshape(b, hq, s, -1)
    else:
        o = mha(q, k, v, rule=cfg.rule, block_config=cfg.block_config)
    o = o.transpose(1, 2).reshape(b, s, -1)
    return _row_output(x, _proj(o, layer.wo), ax)


def _rank_moe(cfg: ModelConfig, layer: Block, x: torch.Tensor, ax: _Lines):
    """The MoE block on the caller's rows: the normed rows of the batch
    shard's whole sequence gathered (model chunks within context shards)
    and routed on every rank alike; the caller's ``E / tp`` experts; their
    outputs over its context shard summed over the model line (foreign
    experts' rows are exact zeros); the caller's rows of that.  Returns the
    rows and the (kept counts, probability sums) of the caller's own
    tokens (its model chunk, or without sp its ``1/tp`` of the shard), so
    that the sums over every rank count each token once."""
    mcfg = cfg.moe_cfg()
    h = _rms_norm(x, layer.ln2)
    if ax.sp:
        h = torch.cat(all_gather([h], ax.model), dim=1)
    else:
        h = pvary(h, ax.model)
    span = h.shape[1]
    h = torch.cat(all_gather([h], ax.context), dim=1)
    r = route(mcfg, layer.moe.router, h)
    n_local = layer.moe.w_in.shape[0]
    part = expert_outputs(r, h, layer.moe.w_in, layer.moe.w_out,
                          first=ax.model.index * n_local)
    c0 = ax.context.index * span
    part = part[:, c0:c0 + span]
    y = psum_scatter(part, ax.model, 1) if ax.sp else psum([part], ax.model)
    j, tp = ax.model.index, ax.model.size
    return x + y.to(x.dtype), r.sums(c0 + span * j // tp, c0 + span * (j + 1) // tp)


def _rank_hidden(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, mesh: Mesh,
                 ax: _Lines):
    """The caller's final-normed rows and the MoE layers' summed
    load-balancing loss (None for a dense model), the same on every rank:
    each layer's from the counts and probability sums of every rank's own
    tokens."""
    if _quantized(params):
        raise TypeError("the sharded path takes dense weights")
    x = params.embed.to(cfg.dtype)[_rank_tokens(cfg, mesh, tokens, ax)]
    aux = None
    for layer in params.layers:
        x = _rank_attention(cfg, layer, x, ax)
        if not cfg.n_experts:
            h = _column_input(_rms_norm(x, layer.ln2), ax)
            x = _row_output(x, _proj(F.silu(_proj(h, layer.w1)) * _proj(h, layer.w3),
                                     layer.w2), ax)
            continue
        x, (counts, probs) = _rank_moe(cfg, layer, x, ax)
        sums = torch.cat([counts, probs])
        for line in (ax.model, ax.context, ax.data):
            sums = psum([sums], line)
        counts, probs = sums.chunk(2)
        a = aux_loss(cfg.moe_cfg(), counts, probs, tokens.numel())
        aux = a if aux is None else aux + a
    return _rms_norm(x, params.final_norm), aux


def _rank_logits(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, mesh: Mesh):
    """The whole float32 logits on every rank, and the aux or None."""
    ax = _lines(cfg, mesh)
    h, aux = _rank_hidden(cfg, params, tokens, mesh, ax)
    logits = _logits(params, h)
    for line, dim in ((ax.model if ax.sp else LOCAL, 1), (ax.context, 1), (ax.data, 0)):
        logits = torch.cat(all_gather_invariant(logits, line), dim=dim)
    return logits, aux


def _rank_loss(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, mesh: Mesh):
    """``loss_fn`` over a process group: the caller's token-loss sum,
    summed over the ranks that hold other tokens (the model line under sp,
    the context line under cp, the data line) in shard order, over the
    global token count; the same number on every rank."""
    ax = _lines(cfg, mesh)
    h, aux = _rank_hidden(cfg, params, tokens[:, :-1], mesh, ax)
    logp = torch.log_softmax(_logits(params, h), dim=-1)
    targets = _rank_tokens(cfg, mesh, tokens[:, 1:], ax)
    total = (-torch.gather(logp, -1, targets[..., None])).sum()
    for name, used in ((AXIS_MODEL, ax.sp), (AXIS_CONTEXT, ax.cp), (AXIS_DATA, True)):
        if used:
            total = psum([total], mesh.axis(name))
    total = total / tokens[:, 1:].numel()
    return total if aux is None else total + aux


def sync_gradients(cfg: ModelConfig, params: Transformer, mesh: Mesh) -> None:
    """Over a process group, after ``backward()``: each parameter's
    gradient summed, in shard order, over the mesh axes it is replicated on
    whose ranks saw other tokens: ``data``, ``context`` under cp, and
    ``model`` for the norm scales and the embedding under sp (each model
    rank saw its chunk) and for an MoE router (each rank's gates are its
    experts' tokens').  Every rank then holds the whole batch's gradient of
    its slot, and replicated parameters stay bit-equal across ranks.  A
    single-controller mesh needs nothing (its gradients land on one
    master)."""
    if not mesh.process_group:
        return
    ax = _lines(cfg, mesh)
    groups: Dict[tuple, list] = {}
    for name, p in params.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        over_model = leaf == "router" or (ax.sp and leaf in ("ln1", "ln2", "final_norm",
                                                             "embed"))
        lines = tuple(a for a in (ax.data, ax.context, ax.model if over_model else LOCAL)
                      if a.group is not None)
        groups.setdefault(lines, []).append(p)
    for lines, ps in groups.items():
        psum_gradients(ps, lines)


def _spec(name: str) -> tuple:
    """The ``param_shardings`` entry of parameter ``name`` (dotted, as
    ``named_parameters`` gives it)."""
    leaf = name.rsplit(".", 1)[-1]
    if ".moe." in name:
        return _MOE_SPECS[leaf]
    return _LAYER_SPECS.get(leaf, (None,) * 2)


def _filled(module: nn.Module, tensors: Dict[str, torch.Tensor]) -> nn.Module:
    """``module`` (built on the ``"meta"`` device) with its parameters set
    to ``tensors`` by name."""
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf, nn.Parameter(t))
    return module


@torch.no_grad()
def slot_params(cfg: ModelConfig, params: Transformer, mesh: Mesh) -> Transformer:
    """The parameters the caller's step takes on ``mesh`` (JAX's
    ``jax.device_put(params, param_shardings(cfg, mesh))``, seen from one
    process): over a process group a new ``Transformer`` on the caller's
    device holding its model shard's slice of every model-sharded weight
    (``param_shardings``) and every other weight whole; single-controller,
    ``params`` itself (its step slices the one master)."""
    if not mesh.process_group:
        return params
    model = mesh.axis(AXIS_MODEL)
    out = {}
    for name, p in params.named_parameters():
        spec = _spec(name)
        if AXIS_MODEL in spec:
            p = p.chunk(model.size, spec.index(AXIS_MODEL))[model.index]
        out[name] = p.detach().to(mesh.device, copy=True)
    return _filled(Transformer(cfg, "meta"), out)


@torch.no_grad()
def gather_params(cfg: ModelConfig, slot: Transformer, mesh: Mesh,
                  grads: bool = False) -> Transformer:
    """``slot_params``' inverse: the whole parameters on the caller's
    device, every model-sharded weight gathered over the model line (or,
    with ``grads``, their gradients, zeros where None, as the parameters of
    the result); a collective call over a process group.  Single-controller:
    ``slot`` itself (with ``grads``, a copy holding its gradients)."""
    pick = lambda p: (p.grad if p.grad is not None else torch.zeros_like(p)) if grads else p
    if not mesh.process_group:
        if not grads:
            return slot
        return _filled(Transformer(cfg, "meta"),
                       {n: pick(p).detach().clone() for n, p in slot.named_parameters()})
    model = mesh.axis(AXIS_MODEL)
    out = {}
    for name, p in slot.named_parameters():
        t, spec = pick(p).detach(), _spec(name)
        if AXIS_MODEL in spec:
            t = torch.cat(all_gather([t], model), dim=spec.index(AXIS_MODEL))
        out[name] = t.clone()
    return _filled(Transformer(cfg, "meta"), out)


def _logits(params: Transformer, x: torch.Tensor) -> torch.Tensor:
    return (x @ params.embed.to(x.device).to(x.dtype).T).float()


def _forward(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
             mesh: Optional[Mesh]):
    """(float32 logits, the MoE layers' summed aux or None)."""
    if mesh is not None and mesh.process_group:
        return _rank_logits(cfg, params, tokens, mesh)
    if mesh is not None:
        home = params.embed.device
        hidden, aux = _mesh_hidden(cfg, params, tokens, mesh)
        return torch.cat([torch.cat([_logits(params, x).to(home) for x in row], 1)
                          for row in hidden], 0), aux
    x = params.embed.to(cfg.dtype)[tokens]
    aux = None
    for layer in params.layers:
        x = _attention_block(cfg, layer, x)
        x, a = _mlp_block(cfg, layer, x)
        aux = a if aux is None else aux + a
    return _logits(params, _rms_norm(x, params.final_norm)), aux


def forward(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, *,
            mesh: Optional[Mesh] = None, return_aux: bool = False):
    """Token ids ``(batch, seq)`` -> float32 logits ``(batch, seq, vocab)``
    (on the parameters' device under a mesh; the whole logits on every rank
    over a process group); with ``return_aux``,
    ``(logits, aux)``, aux the MoE layers' summed load-balancing loss
    (float32 0 for a dense model)."""
    logits, aux = _forward(cfg, params, tokens, mesh)
    if return_aux:
        return logits, torch.zeros((), device=logits.device) if aux is None else aux
    return logits


def loss_fn(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, *,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Next-token cross entropy over ``tokens (batch, seq + 1)``, plus the
    MoE layers' load-balancing loss; under a mesh each block's token losses
    are summed on its device, and the sums added in block order on the
    parameters' device (over a process group, in shard order on every
    rank)."""
    if mesh is not None and mesh.process_group:
        return _rank_loss(cfg, params, tokens, mesh)
    if mesh is None:
        logits, aux = _forward(cfg, params, tokens[:, :-1], None)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0].mean()
        # the JAX package adds a float32 0 for a dense model: the same number
        return nll if aux is None else nll + aux
    hidden, aux = _mesh_hidden(cfg, params, tokens[:, :-1], mesh)
    total = None
    for xs, ts in zip(hidden, _token_blocks(cfg, mesh, tokens[:, 1:])):
        for x, t in zip(xs, ts):
            logp = torch.log_softmax(_logits(params, x), dim=-1)
            nll = (-torch.gather(logp, -1, t[..., None])).sum().to(params.embed.device)
            total = nll if total is None else total + nll
    total = total / tokens[:, 1:].numel()
    return total if aux is None else total + aux


def train_step(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, *,
               optimizer: torch.optim.Optimizer, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One optimizer step on ``params`` in place (over a process group, the
    caller's slot, its gradients summed by ``sync_gradients``); returns the
    loss (before the step)."""
    return train_once(lambda p, t: loss_fn(cfg, p, t, mesh=mesh), optimizer, params, tokens,
                      _sync(cfg, mesh))


def _sync(cfg: ModelConfig, mesh: Optional[Mesh]):
    if mesh is None or not mesh.process_group:
        return None
    return lambda params: sync_gradients(cfg, params, mesh)


def make_sharded_train_step(cfg: ModelConfig, mesh: Mesh, optimizer: torch.optim.Optimizer):
    """The train step with dp/tp/sp (and cp, with ``context_parallel``; ep,
    with ``n_experts``) over ``mesh``: ``step(params, tokens) -> loss``,
    ``optimizer`` over ``params``' float32 master weights.

    Over a process group every rank calls ``step`` with its own slot
    (``slot_params``; ``optimizer`` over it) and the whole ``tokens``, and
    gets the same loss.

    The JAX package jits this step.  Where the devices the caller drives are
    CUDA devices (every layout on one card, a single-controller layout
    across several cards, a rank of a process group on its card), the step
    is a ``serving.graphs.GraphedTrainStep``: its first call with a batch
    shape runs the eager step and captures it as one CUDA graph (across
    the cards, with the copies between them; over NCCL, with the rank's
    collectives), which later calls replay; ``optimizer`` must be built
    with ``capturable=True``, or this raises a ``ValueError``.  A gloo
    group's collectives cannot be captured: the step then raises when it
    would capture, and ``step.eager`` runs it.  On the CPU the step runs
    eagerly with ``optimizer`` as it is."""
    _mesh_devices(cfg, mesh)
    return graph_train_step(lambda params, tokens: loss_fn(cfg, params, tokens, mesh=mesh),
                            optimizer, mesh, _sync(cfg, mesh))
