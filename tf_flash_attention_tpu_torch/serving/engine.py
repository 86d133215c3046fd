"""Continuous-batching decode engine for the flagship transformer (PyTorch port).

Counterpart of the JAX package's ``serving/engine.py``, on one device or
over a mesh (context and tensor parallelism, below).  On its chunked
path prompts run ``prefill_chunk`` tokens at a time (KV write,
then paged prefill attention, then the MLP, per layer), reusing any cached
page-aligned prefix; then every active slot advances one token per
``step()`` (KV append, then paged decode attention).  New requests are
admitted into free slots between steps and finished ones retire and
release their pages.  The KV cache holds int8, fp8 (e4m3, e5m2) or int4
payloads (``kv_quant_dtype``), or the model dtype (``quantized_kv=False``).

Speculative decoding (``speculative_tokens`` > 0) is the JAX engine's
prompt-lookup self-speculation: the host proposes drafts from the
request's own history (``_propose``), one step appends the last token and
the drafts and verifies them with one ``paged_multitoken_decode`` per
layer, and the host keeps the drafts the model's greedy tokens confirm,
plus one model token, then rolls every layer's lengths back to what it
kept.  Greedy slots are lossless; sampled slots emit one token per step.

Context parallelism (``mesh`` with a ``seq`` axis of ``cp`` shards, from
``parallel.mesh.make_mesh``) is the JAX engine's: KV pages go round-robin
over the shards (global page g on shard g % cp, ``n_pages`` per shard),
each shard has its own caches, page allocator and page tables, and every
shard scans only its own pages with the kernels' sequence-sharded variants
(``seq_sharded_decode.py``), whose ``(o, l, m)`` partials merge exactly.
Chunk writes keep the rows of each shard's own pages, appends go to the
owner shard of the position.  Placement is single-controller, as JAX's
``shard_map``: the model runs once on the first device of the mesh, q, k
and v are copied to each shard's device (no copy when the devices are the
same, as for four shards on one card), and the partials come back for the
merge.  Admission reserves the binding shard's share of the pages (shard
0 holds a sequence's first page); prefix caching is off, as in JAX.  The
single-device engine is the same code with one shard (cp = 1): every page
is shard 0's, and the sharded calls reduce to the plain kernels (no
``(l, m)``, no merge).

Over a process group (a mesh from ``make_mesh`` with ``torch.distributed``
up: one process a mesh slot, ``jax.distributed``'s multi-controller
mode), every rank builds the engine with the same arguments and runs the
same host loop (admission, allocators, page tables, retirement, eviction:
every rank keeps every seq shard's host state), but holds only its slot's
Megatron slices (``megatron_shards(..., shards=[t])``) and caches, and
uploads only its own seq shard's page tables.  The cross-shard reductions
are ``parallel/collectives.py``'s: the ``wo``/``w2`` partials' ``psum``
over ``model`` and the merge's ``pmax``/``psum`` and the global lengths'
``psum`` over ``seq``, sums in shard order, so every rank's activations,
logits and tokens are bit-equal to the single-controller engine's on the
same devices; the sampler draws from the engine's generator, seeded alike
on every rank, over those identical logits, so every rank returns the same
tokens.

Sliding-window models (``ModelConfig.rule`` a causal ``LocalRule``) keep
their KV memory bounded by the window, flat and under CP, as the JAX
engine does: the prompt pages in lazily (each page mapped just before the
chunk that writes it) and the pages wholly below the window are released
after every chunk and every step (``_evict_window_pages``); a global page
``g`` maps at table slot ``(g // cp) % max_pages_per_seq`` of its shard, so
the table rolls and a sequence may outgrow it; admission reserves only the
window's live set (``_pages_cap``).  The kernels skip the pages below the
window before any load, so the rolled-over slots are never read.  Window
models run without the prefix cache.

The bucketed prefill (``prefill_mode="bucketed"``, one device) runs the
whole prompt, padded to the smallest bucket of ``prefill_buckets`` that
holds it, through the training forward's attention (``parallel.sharded.
mha``, the op kernels) and writes its K/V with ``write_prompt``.

The compiled steps (``_compile``, the JAX engine's ``engine.py:339-370``):
the decode step, the speculative step, the chunked prefill, the bucketed
prefill and the first-token sampler are ``_decode_step_impl``,
``_spec_step_impl``, ``_chunk_prefill_impl``, ``_prefill_impl`` (JAX's
jit a bucket, ``:268-271``) and ``_sample1_impl`` (JAX's ``_sample1``,
``:275``), device work only, and on the card ``_compile`` captures each
as a CUDA graph (``graphs.py``), one per input shape (a bucket), replayed
on every later call, for every layout of the engine (flat, window, cp,
tp, tp x cp, MoE; one process over shards on several cards, one graph a
step across them; over a process group, a rank's steps on its card with
their NCCL collectives inside the graph); on the CPU, which a caller asks
for explicitly, it returns the impl itself.  A step's inputs are the engine's static device
buffers, filled from host tensors before each call: the tokens, the
active mask, for a chunk its (slot, start, true_len) as an int32 vector,
which the chunk kernels take as their device ``meta``, as JAX's take
traced scalars, and for a bucketed prompt its length as a 0-d int32, so
the last real row is picked on the device.  The greedy argmax runs in
the step; sampling, where a slot samples, runs after it on the step's
logits with the engine's generator, from per-slot parameters kept on the
device (a first token's through ``_sample1``, whose graph draws from the
generator at every replay).  The KV caches are updated in place by the
kernels (the JAX engine donates them instead).  The host keeps a mirror of
the page tables, uploaded in place when it changes, and of the slots'
lengths, so a decode step copies one tensor back to the host: the next
tokens.

Tensor parallelism (``mesh`` with a ``model`` axis of ``tp`` shards,
alone or beside the ``seq`` axis) is the JAX engine's Megatron placement:
each head shard holds the columns of ``wq``/``wk``/``wv``/``w1``/``w3`` and
the rows of ``wo``/``w2`` of its ``n_heads // tp`` query heads, ``n_kv_heads
// tp`` KV heads and ``d_ff // tp`` hidden units (``megatron_shards``), on
its device of seq shard 0, and caches of its own KV heads: one cache a
(seq shard, head shard), the head shards of a seq shard sharing that seq
shard's page table and allocator, so pages are counted once.  Every layer
projects each shard's q/k/v from the replicated activations, writes and
attends on the shard's own caches (no collective inside attention), and
adds the shards' ``wo`` and ``w2`` partials in shard order before each
residual add (the JAX engine's ``psum``); the embedding, the final norm and
the logits run once, on the first device.  Positions come from head shard
0's lengths.  A ``model`` axis of four on one card is ``cuda:0`` four times:
each shard's kernels then launch over its ``n_kv_heads // 4`` heads.  TP
takes the chunked prefill only, and keeps the prefix cache (flat, no window)
and window models as the JAX engine does.

MoE models (``ModelConfig.n_experts``) serve on one device, as in the JAX
engine (tp and cp raise its ``ValueError``): every layer runs ``moe_ffn``
on the step's rows flattened to one sequence, a chunk's ``chunk`` rows, a
decode step's ``max_seqs`` slots, a speculative step's ``max_seqs x gamma``
rows slot-major, a bucketed prompt's ``bucket`` rows.  Capacity couples
those rows, so an idle slot's row (token 0, attention output 0 over no
keys) takes its place in the queues as in JAX; the router and the experts
run in float32 on float32 weights.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..mask_rules import LocalRule
from ..models.moe import moe_ffn
from ..models.transformer import (ModelConfig, Transformer, _inverse_freqs, _rms_norm, _rope,
                                  inference_weights)
from ..parallel.collectives import Axis, psum
from ..parallel.sharded import mha
from .graphs import GraphedStep, capture_devices, capture_streams
from .kv_cache import (KVCacheConfig, PagedKVCache, _owned_token_count, chunk_write_meta,
                       write_prompt)
from .prefill import prefill_meta
from .prefix_cache import PrefixCache, SharedPageAllocator
from .sampling import SamplingParams, draw_tokens, sample_tokens
from .scheduler import Request, Scheduler
from .seq_sharded_decode import (append_owned, decode_merged, global_lengths, prefill_merged,
                                 write_tokens_sharded)
from .sharded_decode import head_shard_config

__all__ = ["EngineConfig", "DecodeEngine", "megatron_shards"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_seqs: int = 4
    page_size: int = 128
    n_pages: int = 64           # includes 1 reserved trash page
    max_pages_per_seq: int = 16
    quantized_kv: bool = True
    # torch.int8, torch.float8_e4m3fn, torch.float8_e5m2, or "int4"
    # (nibble-packed; needs an even prefill_chunk)
    kv_quant_dtype: object = torch.int8
    prefill_buckets: tuple = (128, 512)
    seed: int = 0               # seed of the sampling generator
    # "chunked": prompts run prefill_chunk tokens at a time through the
    # paged prefill kernel (prefix caching, CP, sliding windows);
    # "bucketed": the whole prompt in one padded pass through the training
    # forward (one device, causal models)
    prefill_mode: str = "chunked"
    prefill_chunk: int = 128
    prefix_caching: bool = True     # chunked mode only
    # draft tokens per step proposed by prompt lookup (n-gram
    # self-speculation); 0 disables.  Greedy slots verify losslessly;
    # sampled slots emit one token per step in the same batch.
    speculative_tokens: int = 0
    spec_lookup_window: int = 512   # n-gram search window (host)


def _rope_cos_sin(pos: torch.Tensor, inv_freq: torch.Tensor, dtype: torch.dtype):
    """cos/sin tables (*pos.shape, 1, d/2) for rotary embedding at ``pos``
    (``inv_freq`` from ``_inverse_freqs``, a device buffer of the engine's)."""
    angles = pos.float()[..., None] * inv_freq
    return torch.cos(angles)[..., None, :].to(dtype), torch.sin(angles)[..., None, :].to(dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope_at(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding (half-split rotation) at token positions: x (..., h,
    d), pos (...): single tokens (S,) as the JAX ``_rope_at``, token grids
    (S, T) as its ``_rope_at_batch``."""
    cos, sin = _rope_cos_sin(pos, _inverse_freqs(x.shape[-1], theta, pos.device), x.dtype)
    return _rotate(x, cos, sin)


def _mlp(cfg: ModelConfig, layer, h: torch.Tensor) -> torch.Tensor:
    """The MLP's output (before the residual add) of normed ``h`` (...,
    d_model): the gated MLP, or the expert FFN on the rows of ``h`` as one
    sequence (1, n, d_model) in row-major order (the JAX engine's
    ``_mlp``)."""
    if cfg.n_experts:
        y, _ = moe_ffn(cfg.moe_cfg(), layer.moe, h.reshape(1, -1, h.shape[-1]))
        return y.reshape(h.shape)
    return (F.silu(h @ layer.w1) * (h @ layer.w3)) @ layer.w2


_COLUMNS = ("wq", "wk", "wv", "w1", "w3")
_ROWS = ("wo", "w2")


@torch.no_grad()
def megatron_shards(params: Transformer, tp: int, devices=None,
                    shards: Optional[List[int]] = None) -> List[Transformer]:
    """The tensor-parallel placement of ``params`` (the JAX engine's
    ``_param_pspec``): frozen copies of a model of ``n_heads // tp`` q heads,
    ``n_kv_heads // tp`` KV heads and ``d_ff // tp`` hidden units, the
    shards ``shards`` of the ``tp`` (every one when None; a rank of a
    process group builds its own), the i-th on ``devices[i]`` (``params``'
    device when None).  ``wq``, ``wk``, ``wv``, ``w1`` and ``w3`` are split
    by columns (head-major for q/k/v), ``wo`` and ``w2`` by rows; the norms
    and the embedding are replicated (no copy on ``params``' own device).
    The slices are copies, so ``params``' layers may be freed."""
    cfg = params.cfg
    if cfg.n_experts:
        raise ValueError("tensor-parallel engine does not support MoE")
    if cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_ff % tp:
        raise ValueError(f"heads ({cfg.n_heads}/{cfg.n_kv_heads}) or d_ff {cfg.d_ff} not "
                         f"divisible by tensor-parallel degree {tp}")
    loc = dataclasses.replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                              d_ff=cfg.d_ff // tp)
    frozen = lambda x, dev: torch.nn.Parameter(x.detach().to(dev), requires_grad=False)
    shards = list(range(tp)) if shards is None else list(shards)
    out = []
    for t, dev in zip(shards, devices or [params.embed.device] * len(shards)):
        shard = Transformer(loc, "meta")
        shard.embed = frozen(params.embed, dev)
        shard.final_norm = frozen(params.final_norm, dev)
        for src, dst in zip(params.layers, shard.layers):
            for name in ("ln1", "ln2"):
                setattr(dst, name, frozen(getattr(src, name), dev))
            for name in _COLUMNS + _ROWS:
                w = getattr(src, name)
                if name in _COLUMNS:
                    n = w.shape[1] // tp
                    w = w[:, t * n:(t + 1) * n]
                else:
                    n = w.shape[0] // tp
                    w = w[t * n:(t + 1) * n]
                w = w.to(dev, memory_format=torch.contiguous_format, copy=True)
                setattr(dst, name, torch.nn.Parameter(w, requires_grad=False))
        out.append(shard)
    return out


class DecodeEngine:
    """Continuous-batching engine on one device: the CUDA card, or the CPU
    when ``device="cpu"``, where the kernels' plain PyTorch versions run;
    or over ``mesh``: context-parallel over its ``seq_axis``,
    tensor-parallel over its ``model_axis``, or both (then the devices are
    the mesh's and ``device`` stays None), in one process or, on a
    process-group mesh, one rank a mesh slot, each rank building the engine
    alike.  ``params`` may live anywhere; the engine casts its own copy onto
    its devices."""

    def __init__(self, model_cfg: ModelConfig, params: Transformer,
                 engine_cfg: EngineConfig = EngineConfig(), device=None, mesh=None,
                 model_axis: str = "model", seq_axis: str = "seq"):
        # grid[r][t]: the device of seq shard r and head shard t; local: the
        # part of it this process drives (all of it, or over a process group
        # its slot alone)
        grid = local = None
        if mesh is not None:
            axes = mesh.shape
            if any(n > 1 for a, n in axes.items() if a not in (model_axis, seq_axis)):
                raise ValueError(f"the engine's mesh takes a {seq_axis!r} axis and a "
                                 f"{model_axis!r} axis, got {axes}")
            if device is not None:
                raise ValueError("with a mesh, the devices are the mesh's: leave device None")
            grid, local = mesh.grid(seq_axis, model_axis), mesh.local_grid(seq_axis, model_axis)
            device = local[0][0]
        tp = len(grid[0]) if grid else 1
        if tp > 1:
            if model_cfg.n_heads % tp or model_cfg.n_kv_heads % tp:
                raise ValueError(
                    f"heads ({model_cfg.n_heads}/{model_cfg.n_kv_heads}) not divisible by "
                    f"tensor-parallel degree {tp}")
            if model_cfg.n_experts:
                raise ValueError("tensor-parallel engine does not support MoE")
            if engine_cfg.prefill_mode != "chunked":
                raise ValueError("tensor-parallel engine requires chunked prefill")
        rule = model_cfg.rule
        if not (isinstance(rule, LocalRule) and rule.is_causal
                or type(rule).__name__ == "CausalRule"):
            raise ValueError("the serving engine is autoregressive: ModelConfig.rule must be "
                             "CausalRule or LocalRule(is_causal=True) (the paged kernels "
                             "always enforce left-to-right order)")
        if engine_cfg.prefill_mode not in ("chunked", "bucketed"):
            raise ValueError(f"unknown prefill_mode {engine_cfg.prefill_mode!r}")
        if isinstance(rule, LocalRule) and engine_cfg.prefill_mode != "chunked":
            raise ValueError("sliding-window models require chunked prefill (lazy paging "
                             "and the rolling page table have no bucketed-path analog)")
        if grid is not None and len(grid) > 1:
            if model_cfg.n_experts:
                raise ValueError("context-parallel engine does not support MoE")
            if engine_cfg.prefill_mode != "chunked":
                raise ValueError("context-parallel engine requires chunked prefill")
        self.mcfg = model_cfg
        self.ecfg = engine_cfg
        self.device = torch.device("cuda") if device is None else torch.device(device)
        grid, local = grid or [[self.device]], local or [[self.device]]
        self.cp, self.tp = len(grid), tp
        # the axes as this process sees them (collectives.Axis): sizes, its
        # first shard's index, and its line's group over a process group
        self._seq_ax = mesh.axis(seq_axis) if mesh is not None else Axis(1)
        self._model_ax = mesh.axis(model_axis) if mesh is not None else Axis(1)
        self._refuse = mesh.capture_refusal() if mesh is not None else None
        if self.cp > 1 and engine_cfg.speculative_tokens and (
                engine_cfg.page_size <= engine_cfg.speculative_tokens):
            raise ValueError("page_size must exceed speculative_tokens")
        # projections and embedding cast to the model dtype once, here; under
        # TP each head shard takes its Megatron slices (``megatron_shards``)
        # on its device of seq shard 0, where its projections run, and the
        # full copy keeps only what runs once (the embedding, the final norm)
        self.model = inference_weights(params, self.device)
        self._params = [self.model]
        if tp > 1:
            t0 = self._model_ax.index
            self._params = megatron_shards(self.model, tp, local[0],
                                           shards=range(t0, t0 + len(local[0])))
            self.model.layers = torch.nn.ModuleList()
        # each head shard's device, None where it is the engine's own
        self._moves = [None if torch.device(d) == self.device else torch.device(d)
                       for d in local[0]]
        self._n_heads_loc = model_cfg.n_heads // tp
        self._n_kv_loc = model_cfg.n_kv_heads // tp
        self.ccfg = KVCacheConfig(
            n_kv_heads=model_cfg.n_kv_heads, head_dim=model_cfg.d_head,
            page_size=engine_cfg.page_size, n_pages=engine_cfg.n_pages,
            max_seqs=engine_cfg.max_seqs,
            max_pages_per_seq=engine_cfg.max_pages_per_seq,
            quantized=engine_cfg.quantized_kv, quant_dtype=engine_cfg.kv_quant_dtype,
            dtype=model_cfg.dtype)
        self._ccfg_loc = head_shard_config(self.ccfg, tp)
        self.trash_page = engine_cfg.n_pages - 1
        # caches[r][t][layer]: the caches of the driven seq shard r and head
        # shard t (``n_pages`` is per seq shard, ``n_kv_heads // tp`` heads a
        # head shard); every layer and head shard of a seq shard maps the
        # same pages: one device table per seq shard and device, mirrored on
        # the host (every seq shard's, on every rank)
        self._caches = [[[PagedKVCache.create(self._ccfg_loc, dev)
                          for _ in range(model_cfg.n_layers)] for dev in row] for row in local]
        for row in self._caches:
            tables = {}
            for layers in row:
                for c in layers:
                    c.page_tables = tables.setdefault(c.page_tables.device, c.page_tables)
        # [layer][t]: head shard t's caches of the layer over the seq shards
        self._layer_shards = [[[row[t][i] for row in self._caches]
                               for t in range(len(local[0]))] for i in range(model_cfg.n_layers)]
        self._tables = np.zeros((self.cp, engine_cfg.max_seqs, engine_cfg.max_pages_per_seq),
                                np.int32)
        self._tables_dirty = False
        # one allocator per seq shard (each excludes its trash page); the
        # head shards of a seq shard share it, as they share its pages
        self.allocators = [SharedPageAllocator(engine_cfg.n_pages - 1) for _ in range(self.cp)]
        self.allocator = self.allocators[0]
        # sliding-window models: lazy prompt paging and eviction keep the
        # live page set window-bounded (a rolling page table), so admission
        # reserves only the capped page count; the prefix cache cannot keep
        # evicted prompt pages, so window models run without it
        self._window = rule.strided_window_size if isinstance(rule, LocalRule) else None
        self._pages_cap = -1
        if self._window is not None:
            gamma = max(1, engine_cfg.speculative_tokens + 1)
            span = self._window + gamma + engine_cfg.prefill_chunk
            live_pages = -(-span // engine_cfg.page_size) + 2
            # under CP the live set spreads round-robin: the binding shard
            # holds at most ceil(live / cp) + 1 of its pages
            self._pages_cap = -(-live_pages // self.cp) + 1 if self.cp > 1 else live_pages
            if self._pages_cap > engine_cfg.max_pages_per_seq:
                raise ValueError(
                    f"max_pages_per_seq={engine_cfg.max_pages_per_seq} too small for the "
                    f"window's live set ({self._pages_cap} local pages: window "
                    f"{self._window} + chunk/gamma)")
        self.prefix_cache = (PrefixCache(engine_cfg.page_size)
                             if engine_cfg.prefix_caching and engine_cfg.prefill_mode == "chunked"
                             and self.cp == 1 and self._window is None else None)
        self.scheduler = Scheduler(engine_cfg.max_seqs, engine_cfg.n_pages - 1,
                                   engine_cfg.page_size)
        self._slots: List[Optional[dict]] = [None] * engine_cfg.max_seqs
        self._next_rid = 0
        self._results: Dict[int, List[int]] = {}
        self._prompts: Dict[int, List[int]] = {}
        self._sampling: Dict[int, tuple] = {}
        self.stats = {"steps": 0, "decode_tokens": 0, "prefill_chunks": 0,
                      "prefill_tokens": 0, "admitted": 0, "retired": 0,
                      "pages_in_use_peak": 0, "pages_evicted": 0}
        # drafts proposed to and accepted by greedy slots
        self.spec_stats = {"proposed": 0, "accepted": 0}
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(engine_cfg.seed)
        # logits of the last prompt token of the most recently admitted request
        self.last_prefill_logits: Optional[torch.Tensor] = None
        dev, S = self.device, engine_cfg.max_seqs
        self._inv_freq = _inverse_freqs(model_cfg.d_head, model_cfg.rope_theta, dev)
        # each slot's sampling parameters, set when it is admitted or retired
        self._temperature = torch.zeros(S, dtype=torch.float32, device=dev)
        self._top_k = torch.zeros(S, dtype=torch.int32, device=dev)
        self._top_p = torch.ones(S, dtype=torch.float32, device=dev)
        # the steps' inputs: static device buffers, filled before each call
        self._in_tokens = torch.zeros(S, dtype=torch.long, device=dev)
        self._in_active = torch.zeros(S, dtype=torch.bool, device=dev)
        self._in_drafts = torch.zeros((S, engine_cfg.speculative_tokens + 1), dtype=torch.long,
                                      device=dev)
        self._in_chunk = torch.zeros(engine_cfg.prefill_chunk, dtype=torch.long, device=dev)
        self._in_meta = torch.zeros(3, dtype=torch.int32, device=dev)   # slot, start, true_len
        # the bucketed prefill's: a padded prompt a bucket, and its length
        self._in_prompt = ({b: torch.zeros(b, dtype=torch.long, device=dev)
                            for b in engine_cfg.prefill_buckets}
                           if engine_cfg.prefill_mode == "bucketed" else {})
        self._in_true_len = torch.zeros((), dtype=torch.int32, device=dev)
        # the first-token sampler's: the last prompt token's logits, its slot
        self._in_logits1 = torch.zeros((1, model_cfg.vocab), dtype=model_cfg.dtype, device=dev)
        self._in_slot = torch.zeros(1, dtype=torch.long, device=dev)
        # the devices the steps span, the engine's own first
        self._devices = [torch.device(d) for row in local for d in row]
        self._graph_streams = self._graph_pool = None
        self._decode_step = self._compile(self._decode_step_impl, 2)
        self._spec_step = self._compile(self._spec_step_impl, 2)
        self._chunk_prefill = self._compile(self._chunk_prefill_impl, 1)
        # one graph a bucket, as the JAX engine jits one a bucket
        self._bucket_prefill = self._compile(self._prefill_impl, 1 + 2 * model_cfg.n_layers)
        self._sample1 = self._compile(self._sample1_impl, 1, generators=(self._generator,))

    @property
    def shards(self) -> List[List[PagedKVCache]]:
        """Every (seq shard, head shard)'s layer list, seq shard major."""
        return [layers for row in self._caches for layers in row]

    # ---- model functions ----

    def _on_shards(self, *tensors):
        """``tensors`` on every head shard's device, once a step: one tuple a
        head shard (the tensors themselves on the engine's device)."""
        return [tensors if dev is None else tuple(t.to(dev) for t in tensors)
                for dev in self._moves]

    def _layer(self, i: int, x, per_shard, attend):
        """Decoder layer ``i`` on ``x`` (..., d_model): head shard ``t``
        projects its q/k/v, rotates them by ``per_shard[t] = (cos, sin,
        *extra)`` (``_on_shards``), attends with ``attend(q, k, v, caches,
        *extra)`` on its caches of the layer (one a seq shard) and multiplies
        the output by its rows of ``wo``; the shards' partials add up in
        shard order before the residual add (the JAX engine's ``psum``, over
        the model axis's group on a process-group mesh), and likewise the
        MLP's ``w2`` partials.  One head shard is the plain layer."""
        cfg, lead = self.mcfg, x.shape[:-1]
        h = _rms_norm(x, self._params[0].layers[i].ln1)
        parts = []
        for p, caches, dev, (cos, sin, *extra) in zip(self._params, self._layer_shards[i],
                                                      self._moves, per_shard):
            layer = p.layers[i]
            ht = h if dev is None else h.to(dev)
            q = (ht @ layer.wq).reshape(*lead, self._n_heads_loc, cfg.d_head)
            k = (ht @ layer.wk).reshape(*lead, self._n_kv_loc, cfg.d_head)
            v = (ht @ layer.wv).reshape(*lead, self._n_kv_loc, cfg.d_head)
            o = attend(_rotate(q, cos, sin), _rotate(k, cos, sin), v, caches, *extra)
            parts.append(o.reshape(*lead, -1).to(x.dtype) @ layer.wo)
        x = x + psum(parts, self._model_ax)
        h = _rms_norm(x, self._params[0].layers[i].ln2)
        return x + psum([_mlp(cfg, p.layers[i], h if dev is None else h.to(dev))
                         for p, dev in zip(self._params, self._moves)], self._model_ax)

    def _logits(self, x):
        return _rms_norm(x, self.model.final_norm) @ self.model.embed.T

    # ---- the compiled steps ----

    def _compile(self, impl, n_out_scalars: int, generators=()):
        """The step ``impl``, returning ``n_out_scalars`` tensors, as the
        engine runs it (the JAX engine's ``_compile``, engine.py:339-370):
        on the CPU, ``impl`` itself; on the card, a ``graphs.GraphedStep``
        that captures it as a CUDA graph once per input shape and replays
        it, each replay drawing fresh numbers from ``generators``.  The
        graphs of an engine share one capture stream and one memory pool.
        One process driving shards on several cards captures each step as
        one graph over all of them (``graphs.py``: the engine's device
        first, a joined stream on each other card; the copies between the
        cards and the sums in shard order on the engine's device are nodes
        of it), so there too every step replays or raises.  On a
        process-group mesh the rank's steps are captured on its card with
        their NCCL collectives; a gloo group's cannot be, and the step
        raises when it would capture (never at construction)."""
        if self.device.type != "cuda":
            return impl
        if self._graph_streams is None:
            self._graph_streams = capture_streams(capture_devices(self._devices))
            self._graph_pool = torch.cuda.graph_pool_handle()
        return GraphedStep(impl, n_out_scalars, self._graph_streams, self._graph_pool,
                           generators, self._refuse)

    def _upload(self, buf: torch.Tensor, values) -> torch.Tensor:
        """Fill the static input ``buf`` in place from host ``values``: one
        copy from pinned memory on the card (the caching host allocator
        keeps the pinned block until the copy has run)."""
        host = torch.as_tensor(np.asarray(values), dtype=buf.dtype)
        if buf.device.type == "cuda":
            host = host.pin_memory()
        return buf.copy_(host, non_blocking=True)

    @torch.no_grad()
    def _chunk_prefill_impl(self, tokens, meta):
        """One prefill chunk: ``tokens`` (chunk,) at positions ``start ..
        start + chunk`` of ``slot``, where ``meta`` = int32 (slot, start,
        true_len) on the device; returns (the logits of the last real
        token,).  The chunk kernels' own metas are built from it once a
        chunk by device arithmetic, a row a seq shard."""
        cfg = self.mcfg
        chunk = tokens.shape[0]
        slot, start, true_len = meta[0], meta[1], meta[2]
        pos = start + torch.arange(chunk, device=self.device)
        per_shard = self._on_shards(*_rope_cos_sin(pos, self._inv_freq, cfg.dtype))
        write_meta = chunk_write_meta(slot, start, true_len, self.trash_page, self.cp,
                                      self.device)
        attend_meta = prefill_meta(self._ccfg_loc, slot, start, true_len, cfg.rule, self.cp,
                                   self.device)

        def attend(q, k, v, caches):
            # each seq shard keeps the rows of its own pages; partials merge
            write_tokens_sharded(caches, self._ccfg_loc, write_meta, k.transpose(0, 1),
                                 v.transpose(0, 1), self._seq_ax)
            return prefill_merged(q, caches, self._ccfg_loc, attend_meta, rule=cfg.rule,
                                  axis=self._seq_ax)

        x = self.model.embed[tokens]
        for i in range(cfg.n_layers):
            x = self._layer(i, x, per_shard, attend)
        last = x.index_select(0, (true_len - 1).long().reshape(1))[0]
        return (self._logits(last),)

    def _positions(self):
        """The slots' global lengths before this step's appends: the sum
        over the seq shards of head shard 0's layer 0 lengths (every head
        shard's appends advance its own copy alike)."""
        return global_lengths(self._layer_shards[0][0], self.device, self._seq_ax)

    @torch.no_grad()
    def _decode_step_impl(self, tokens, active):
        """One token for every slot: tokens (S,), active (S,) bool; returns
        (the greedy tokens (S,), the logits (S, vocab))."""
        cfg = self.mcfg
        pos = self._positions()
        glob = pos + active.to(torch.int32)
        cos, sin = _rope_cos_sin(pos, self._inv_freq, cfg.dtype)
        per_shard = self._on_shards(cos, sin, active, pos, glob)

        def attend(q, k, v, caches, active, pos, glob):
            # the append lands on the owner seq shard of the position
            append_owned(caches, self._ccfg_loc, k, v, active, pos, self.trash_page,
                         self._seq_ax)
            return decode_merged(q, caches, self._ccfg_loc, glob, rule=cfg.rule,
                                 axis=self._seq_ax)

        x = self.model.embed[tokens]
        for i in range(cfg.n_layers):
            x = self._layer(i, x, per_shard, attend)
        logits = self._logits(x)
        return torch.argmax(logits.float(), dim=-1), logits

    @torch.no_grad()
    def _spec_step_impl(self, tokens, active):
        """Speculative step: ``tokens`` (S, gamma) = [last, draft_1..] per
        slot.  Appends the gamma tokens' K/V with one append a layer (per
        shard: the tokens in order, each on its position's owner shard),
        verifies them with one multi-token decode per layer, and returns the
        greedy token after each position (S, gamma) and position 0's logits
        (S, vocab), which a sampled slot samples from."""
        cfg = self.mcfg
        S, gamma = tokens.shape
        pos0 = self._positions()
        glob = pos0 + gamma * active.to(torch.int32)
        pos = pos0.long()[:, None] + torch.arange(gamma, device=self.device)
        cos, sin = _rope_cos_sin(pos, self._inv_freq, cfg.dtype)
        per_shard = self._on_shards(cos, sin, active, pos0, glob)

        def attend(q, k, v, caches, active, pos0, glob):
            # each token goes to the owner seq shard of its position
            append_owned(caches, self._ccfg_loc, k, v, active, pos0, self.trash_page,
                         self._seq_ax)
            return decode_merged(q, caches, self._ccfg_loc, glob, rule=cfg.rule,
                                 axis=self._seq_ax)

        x = self.model.embed[tokens]                         # (S, gamma, d_model)
        for i in range(cfg.n_layers):
            x = self._layer(i, x, per_shard, attend)
        logits = self._logits(x)                             # (S, gamma, vocab)
        return torch.argmax(logits.float(), dim=-1), logits[:, 0]

    @torch.no_grad()
    def _sample1_impl(self, logits, slot):
        """The first token of a sampled request (the JAX engine's
        ``_sample1``): ``logits`` (1, vocab) its last prompt token's, ``slot``
        (1,) int64 on the device, whose sampling parameters it takes, drawing
        from the engine's generator; returns (the token (1,) int32,)."""
        return (draw_tokens(logits, self._generator, self._temperature[slot], self._top_k[slot],
                            self._top_p[slot]),)

    def _sample(self, logits, slots=slice(None)):
        """Sample from ``logits`` (n, vocab) with the parameters of ``slots``
        (every slot's by default) and the engine's generator, after the
        step: greedy slots take the argmax."""
        return sample_tokens(logits, self._generator, self._temperature[slots],
                             self._top_k[slots], self._top_p[slots])

    def _set_sampling(self, slot: int, sp: SamplingParams) -> None:
        self._temperature[slot] = sp.temperature
        self._top_k[slot] = sp.top_k
        self._top_p[slot] = sp.top_p

    # ---- host-side serving loop ----

    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               sampling: SamplingParams = SamplingParams(),
               eos_id: Optional[int] = None) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        rid = self._next_rid
        self._next_rid += 1
        # reserve the binding (first) shard's share of the pages; window
        # models are capped by their live set
        cap = self._pages_cap
        if self.cp > 1:
            g = -(-(len(prompt) + max_new_tokens) // self.ecfg.page_size)
            share = -(-g // self.cp)
            cap = share if cap < 0 else min(cap, share)
        self.scheduler.enqueue(Request(rid, len(prompt), max_new_tokens, pages_cap=cap))
        self._results[rid] = list(prompt)
        self._prompts[rid] = list(prompt)
        self._sampling[rid] = (sampling, eos_id)
        return rid

    def _set_table(self, slot: int, logical: int, page: int, shard: int = 0) -> None:
        self._tables[shard, slot, logical] = page
        self._tables_dirty = True

    def _sync_tables(self) -> None:
        """Upload the host page tables if they changed (one small copy a
        seq shard and device: the head shards on one device share it)."""
        if self._tables_dirty:
            for table, row in zip(self._tables[self._seq_ax.index:], self._caches):
                for t in {c[0].page_tables.device: c[0].page_tables for c in row}.values():
                    t.copy_(torch.from_numpy(table))
            self._tables_dirty = False

    def _alloc_pages(self, slot: int, n: int, shard: int = 0):
        """Allocate fresh pages on ``shard``, evicting LRU prefix-cache
        entries if dry."""
        alloc = self.allocators[shard]
        if n > alloc.free_pages and self.prefix_cache is not None:
            self.prefix_cache.evict(alloc, n)
        return alloc.alloc(slot, n)

    def _map_page(self, slot: int, g: int) -> None:
        """Map a fresh page at global logical page ``g`` of ``slot``: on
        shard ``g % cp``, at table slot ``(g // cp) % max_pages_per_seq``
        (window models roll the table; a causal sequence raises past it)."""
        owner, loc = g % self.cp, g // self.cp
        mp = self.ecfg.max_pages_per_seq
        if loc >= mp and self._window is None:
            raise RuntimeError(f"sequence needs local page {loc} on shard {owner} but "
                               f"max_pages_per_seq={mp}; only sliding-window models "
                               f"(ModelConfig.rule = LocalRule) roll the page table")
        self._set_table(slot, loc % mp, self._alloc_pages(slot, 1, owner)[0], owner)

    def _prefill(self, prompt: List[int], slot: int):
        """Prefill ``prompt`` into ``slot`` by the configured mode; returns
        ``(last_logits, pages_evicted, budget_refunded)``."""
        if self.ecfg.prefill_mode == "chunked":
            return self._prefill_chunked(prompt, slot)
        return self._prefill_bucketed(prompt, slot), 0, 0

    def _prefill_chunked(self, prompt: List[int], slot: int):
        """Chunked prefill against the paged cache; every chunk writes each
        shard's own rows and merges the shards' attention partials.  Causal
        models map each shard's round-robin share of the prompt's pages up
        front (shard 0 reusing any cached page-aligned prefix as shared
        refcounted pages); sliding-window models page the prompt lazily and
        evict behind the window after every chunk (``_run_chunks``).
        Returns ``(last_logits, pages_evicted, budget_refunded)``."""
        if self._window is not None:
            last_logits, evicted = self._run_chunks(prompt, slot, 0)
            return last_logits, evicted, 0
        ps, mp = self.ecfg.page_size, self.ecfg.max_pages_per_seq
        G = -(-len(prompt) // ps)
        counts = [len(range(r, G, self.cp)) for r in range(self.cp)]
        for r, cnt in enumerate(counts):
            if cnt > mp:
                raise RuntimeError(f"prompt needs {cnt} local pages on shard {r} but "
                                   f"max_pages_per_seq={mp}")
        cached_tokens, cached_pages = 0, []
        if self.prefix_cache is not None:
            # always leave >= 1 token to prefill so there are logits to sample
            cached_tokens, cached_pages = self.prefix_cache.lookup(
                prompt, max_tokens=len(prompt) - 1)
        if cached_pages:
            self.allocator.share(slot, cached_pages)
        shard_pages = [list(cached_pages) + self._alloc_pages(slot, counts[0] - len(cached_pages))]
        shard_pages += [self._alloc_pages(slot, cnt, r) for r, cnt in enumerate(counts) if r]
        for r, pages in enumerate(shard_pages):
            for local, page in enumerate(pages):
                self._set_table(slot, local, page, r)
        self._sync_tables()
        last_logits, _ = self._run_chunks(prompt, slot, cached_tokens)
        if self.prefix_cache is not None:
            self.prefix_cache.insert(prompt, shard_pages[0], self.allocator)
        return last_logits, 0, 0

    def _run_chunks(self, prompt: List[int], slot: int, start: int):
        """Prefill ``prompt[start:]`` chunk by chunk.  A window model maps
        each page just before the chunk that writes it and, after the chunk,
        releases the pages wholly below the next query row's window, so a
        prompt of any length holds only window + chunk pages at once.
        Returns (the last token's logits, pages evicted)."""
        ps, chunk = self.ecfg.page_size, self.ecfg.prefill_chunk
        lazy = self._window is not None
        last_logits, mapped, evicted = None, 0, 0
        while start < len(prompt):
            n = min(chunk, len(prompt) - start)
            if lazy:
                for g in range(mapped, (start + n - 1) // ps + 1):
                    self._map_page(slot, g)
                mapped = (start + n - 1) // ps + 1
                self._sync_tables()
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens"] += n
            self._upload(self._in_chunk, prompt[start:start + n] + [0] * (chunk - n))
            self._upload(self._in_meta, [slot, start, n])
            last_logits, = self._chunk_prefill(self._in_chunk, self._in_meta)
            start += n
            if lazy:
                keep_from = max(0, start - (self._window - 1)) // ps
                if keep_from > evicted:
                    # the pages recycle inside the slot's capped reservation:
                    # no scheduler refund
                    self._release_global_pages(slot, evicted, keep_from)
                    self.stats["pages_evicted"] += keep_from - evicted
                    evicted = keep_from
        return last_logits, evicted

    def _bucket_for(self, n: int) -> int:
        for b in self.ecfg.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket")

    @torch.no_grad()
    def _prefill_impl(self, tokens, true_len):
        """The whole padded prompt ``tokens`` (bucket,) through the training
        forward's attention (``mha``: the op kernels) with ``_rope``;
        ``true_len`` is the prompt's length, a 0-d int32 tensor on the
        device, so one graph serves every length of a bucket.  Returns the
        last real token's logits and each layer's k and v, (n_kv_heads,
        bucket, d_head): ``(logits, k_0, v_0, k_1, v_1, ...)``."""
        cfg = self.mcfg
        x = self.model.embed[tokens][None]                   # (1, bucket, d_model)
        kvs = []
        for layer in self.model.layers:
            h = _rms_norm(x, layer.ln1)
            b, s, _ = h.shape
            q = (h @ layer.wq).reshape(b, s, cfg.n_heads, cfg.d_head).transpose(1, 2)
            k = (h @ layer.wk).reshape(b, s, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
            v = (h @ layer.wv).reshape(b, s, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
            q, k = _rope(q, cfg.rope_theta), _rope(k, cfg.rope_theta)
            o = mha(q, k, v, rule=cfg.rule, block_config=cfg.block_config)
            x = x + o.transpose(1, 2).reshape(b, s, -1).to(x.dtype) @ layer.wo
            x = x + _mlp(cfg, layer, _rms_norm(x, layer.ln2))
            kvs += [k[0], v[0]]
        last = x[0].index_select(0, (true_len - 1).long().reshape(1))[0]
        return (self._logits(last), *kvs)

    def _prefill_bucketed(self, prompt: List[int], slot: int):
        """The whole prompt in one padded pass (``_bucket_prefill``: the
        bucket's graph on the card), its K/V then written into freshly
        allocated pages, as the JAX engine writes after its jit; returns the
        last token's logits."""
        n = len(prompt)
        bucket = self._bucket_for(n)
        n_pages = -(-n // self.ecfg.page_size)
        if n_pages > self.ecfg.max_pages_per_seq:
            raise RuntimeError(f"prompt needs {n_pages} pages but "
                               f"max_pages_per_seq={self.ecfg.max_pages_per_seq}")
        tokens = self._upload(self._in_prompt[bucket], prompt + [0] * (bucket - n))
        self._upload(self._in_true_len, n)
        last_logits, *kvs = self._bucket_prefill(tokens, self._in_true_len)
        pages = self.allocator.alloc(slot, n_pages)
        for i, page in enumerate(pages):
            self._set_table(slot, i, page)
        self._sync_tables()
        for i, cache in enumerate(self.shards[0]):
            write_prompt(cache, self.ccfg, slot, pages, kvs[2 * i][:, :n], kvs[2 * i + 1][:, :n])
        return last_logits

    def _admit(self):
        for req, slot in self.scheduler.admit():
            self.stats["admitted"] += 1
            prompt = self._prompts.pop(req.rid)
            last_logits, evicted, refunded = self._prefill(prompt, slot)
            # a graphed chunk's logits are overwritten by the next replay
            self.last_prefill_logits = last_logits = last_logits.clone()
            sp, eos_id = self._sampling.pop(req.rid, (SamplingParams(), None))
            self._set_sampling(slot, sp)
            if sp.temperature > 0:
                self._in_logits1.copy_(last_logits[None])
                self._upload(self._in_slot, [slot])
                first_tok = int(self._sample1(self._in_logits1, self._in_slot)[0][0])
            else:
                first_tok = int(torch.argmax(last_logits.float()))
            self._results[req.rid].append(first_tok)
            self._slots[slot] = {
                "rid": req.rid,
                "remaining": req.max_new_tokens - 1,
                "last": first_tok,
                "length": len(prompt),
                "sampling": sp,
                "eos_id": eos_id,
                # the budget reserved at admission, handed back at retirement
                "reserved": req.pages_needed(self.ecfg.page_size),
                # sliding-window bookkeeping, primed by the prefill's eviction
                "evicted": evicted,
                "refunded": refunded,
            }
            if eos_id is not None and first_tok == eos_id:
                self._slots[slot]["remaining"] = 0

    def _ensure_capacity(self, n_tokens: int = 1):
        """Map pages for the next ``n_tokens`` appends of every active slot
        (positions ``length .. length + n_tokens - 1``).  Speculation may
        map a page past the request's reservation, as in the JAX engine."""
        ps = self.ecfg.page_size
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            length = st["length"]
            for g in range(-(-length // ps), (length + n_tokens - 1) // ps + 1):
                self._map_page(slot, g)

    def _evict_window_pages(self):
        """Sliding-window eviction: the pages wholly below every future query
        row's window are dead (the kernels skip them before any load), so
        each slot drops its references to them.  The pages recycle inside
        the slot's capped reservation, so the scheduler gets no refund."""
        if self._window is None:
            return
        ps = self.ecfg.page_size
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            # the next step's oldest query row sits at ``length`` and reaches
            # back strided_window - 1 positions; the window only moves right
            keep_from = max(0, st["length"] - (self._window - 1)) // ps
            if keep_from > st["evicted"]:
                self._release_global_pages(slot, st["evicted"], keep_from)
                self.stats["pages_evicted"] += keep_from - st["evicted"]
                st["evicted"] = keep_from

    def _release_global_pages(self, slot: int, lo: int, hi: int):
        """Drop the slot's references to global logical pages [lo, hi),
        oldest first: each shard releases its round-robin share (its owned
        list is in logical order)."""
        for r in range(self.cp):
            cnt = len(range(lo + (r - lo) % self.cp, hi, self.cp))
            if cnt:
                self.allocators[r].release_prefix(slot, cnt)

    def _retire(self):
        for slot, st in enumerate(self._slots):
            if st is not None and st["remaining"] <= 0:
                self.stats["retired"] += 1
                for alloc in self.allocators:
                    alloc.free(slot)
                self.scheduler.release(slot, st["reserved"] - st["refunded"])
                # zero the slot length so the dead slot reads no pages
                for shard in self.shards:
                    for cache in shard:
                        cache.lengths[slot] = 0
                self._set_sampling(slot, SamplingParams())
                self._slots[slot] = None

    def _note_pages_in_use(self) -> None:
        self.stats["pages_in_use_peak"] = max(
            self.stats["pages_in_use_peak"],
            sum((self.ecfg.n_pages - 1) - a.free_pages for a in self.allocators))

    @property
    def num_active(self) -> int:
        return sum(st is not None for st in self._slots)

    def _propose(self, hist: List[int], n_draft: int) -> List[int]:
        """Prompt-lookup drafts: the continuation of the most recent earlier
        occurrence of the history's last n-gram (n = 3, 2, 1)."""
        w = self.ecfg.spec_lookup_window
        h = hist[-w:] if len(hist) > w else hist
        for n in (3, 2, 1):
            if len(h) <= n:
                continue
            pat = h[-n:]
            for j in range(len(h) - n - 1, -1, -1):
                if h[j:j + n] == pat:
                    cont = h[j + n:j + n + n_draft]
                    if cont:
                        return list(cont) + [cont[-1]] * (n_draft - len(cont))
        return [h[-1]] * n_draft

    def _step_speculative(self) -> int:
        """One speculative step: propose drafts, verify them in one
        multi-token pass, commit the accepted prefix and one model token per
        slot, and roll every layer's lengths back to what was committed
        (later appends overwrite the rejected rows in place)."""
        gamma = self.ecfg.speculative_tokens + 1
        self._admit()
        self._retire()
        if self.num_active == 0:
            return 0
        self._ensure_capacity(gamma)
        self._sync_tables()
        self.stats["steps"] += 1
        self._note_pages_in_use()
        tok_mat = np.zeros((self.ecfg.max_seqs, gamma), np.int64)
        for slot, st in enumerate(self._slots):
            if st is not None:
                tok_mat[slot, 0] = st["last"]
                tok_mat[slot, 1:] = self._propose(self._results[st["rid"]], gamma - 1)
        self._upload(self._in_drafts, tok_mat)
        self._upload(self._in_active, [st is not None for st in self._slots])
        greedy, logits0 = self._spec_step(self._in_drafts, self._in_active)
        sampled0 = (self._sample(logits0).cpu().numpy()
                    if any(st and st["sampling"].temperature > 0 for st in self._slots)
                    else None)
        greedy = greedy.cpu().numpy()
        produced = 0
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            if st["sampling"].temperature > 0:
                new_toks = [int(sampled0[slot])]
            else:
                n_acc = 0
                while n_acc < gamma - 1 and tok_mat[slot, n_acc + 1] == greedy[slot, n_acc]:
                    n_acc += 1
                new_toks = ([int(t) for t in tok_mat[slot, 1:1 + n_acc]]
                            + [int(greedy[slot, n_acc])])
                self.spec_stats["proposed"] += gamma - 1
                self.spec_stats["accepted"] += n_acc
            new_toks = new_toks[:st["remaining"]]
            if st["eos_id"] is not None and st["eos_id"] in new_toks:
                new_toks = new_toks[:new_toks.index(st["eos_id"]) + 1]
                st["remaining"] = len(new_toks)
            # committed K/V: 'last' and the kept drafts; the last emitted
            # token's K/V is appended by the next step
            self._results[st["rid"]].extend(new_toks)
            st["last"] = new_toks[-1]
            st["length"] += len(new_toks)
            st["remaining"] -= len(new_toks)
            produced += len(new_toks)
        self.stats["decode_tokens"] += produced
        # each layer's appends advanced its own lengths by gamma: roll back
        # to the committed lengths (a shard's local length is its owned-token
        # count of the committed global length)
        for r, row in enumerate(self._caches, self._seq_ax.index):
            lengths = torch.tensor(
                [_owned_token_count(st["length"], self.ecfg.page_size, self.cp, r) if st else 0
                 for st in self._slots], dtype=torch.int32)
            on = {}      # one upload a device
            for layers in row:
                for cache in layers:
                    dev = cache.lengths.device
                    cache.lengths.copy_(on.setdefault(dev, lengths.to(dev)))
        self._retire()
        self._evict_window_pages()
        return produced

    def step(self) -> int:
        """Admit, decode one token for all active slots (or, with
        ``speculative_tokens``, verify drafts and commit up to
        ``speculative_tokens + 1``), retire.  Returns the number of tokens
        produced this step."""
        if self.ecfg.speculative_tokens > 0:
            return self._step_speculative()
        self._admit()
        # requests finished at prefill (EOS first, or max_new_tokens == 1)
        # retire before consuming a decode step
        self._retire()
        if self.num_active == 0:
            return 0
        self._ensure_capacity()
        self._sync_tables()
        self.stats["steps"] += 1
        self._note_pages_in_use()
        self._upload(self._in_tokens, [st["last"] if st else 0 for st in self._slots])
        self._upload(self._in_active, [st is not None for st in self._slots])
        greedy, logits = self._decode_step(self._in_tokens, self._in_active)
        if any(st and st["sampling"].temperature > 0 for st in self._slots):
            greedy = self._sample(logits)
        next_host = greedy.cpu().numpy()
        produced = 0
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            tok = int(next_host[slot])
            self._results[st["rid"]].append(tok)
            st["last"] = tok
            st["length"] += 1
            st["remaining"] -= 1
            if st["eos_id"] is not None and tok == st["eos_id"]:
                st["remaining"] = 0
            produced += 1
        self.stats["decode_tokens"] += produced
        self._retire()
        self._evict_window_pages()
        return produced

    def run(self, max_steps: int = 1000) -> Dict[int, List[int]]:
        """Drain the queue; returns {rid: token list (prompt + generated)}."""
        steps = 0
        while (self.scheduler.queued or self.num_active) and steps < max_steps:
            self.step()
            steps += 1
        return dict(self._results)
