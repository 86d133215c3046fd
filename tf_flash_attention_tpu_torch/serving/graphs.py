"""CUDA graphs of the port's compiled entry points.

The port's counterpart of ``jax.jit``: XLA runs a jitted function as one
program, and a CUDA graph replays a captured call as one launch where the
eager call made hundreds or thousands.  Three wrappers share the capture,
the node check and the counts below:

- ``GraphedStep``: the serving engine's steps (the JAX engine's
  ``_compile``, ``serving/engine.py:339-370``, and its bucketed prefill
  and first-token sampler, ``:268-275``);
- ``GraphedTrainStep``: a training step, forward, ``backward()`` and the
  optimizer's step in one graph (``make_sharded_train_step``, JAX
  ``models/transformer.py:332``; ``make_pipeline_train_step``, JAX
  ``models/pipeline.py:158``);
- ``GraphedFunction``: a differentiable callable, a forward graph and a
  backward graph (``ring_flash_attention``, ``ulysses_flash_attention``,
  ``sharded_flash_attention``: JAX's ``jit(shard_map)``);
- ``GraphedCall``: a serving callable that reads and writes KV caches in
  place (``sharded_paged_decode``, ``seq_sharded_paged_decode``,
  ``seq_sharded_paged_prefill``, ``seq_sharded_append``: JAX's
  ``jit(shard_map)`` of ``serving/sharded_decode.py:62`` and
  ``seq_sharded_decode.py:169,201,236``), its graphs keyed by the caches'
  identity as well as the shapes.

The wrapped function's body is device work only: no host sync, no tensor
made from host data (what uploads on first use, as the kernels' tables and
the rotary frequencies, is uploaded by the eager first call), every
persistent tensor updated in place.  Per input signature (shapes and
dtypes) each wrapper:

- runs the function eagerly on the first call: that run is the call's
  result, and it sizes whatever grows lazily (the decode's scratch, the
  optimizer's state);
- then captures it, which records the kernels without running them, with
  the addresses of its inputs and of the weights, caches and optimizer
  state it reads;
- on every later call copies the inputs into the captured ones, replays
  the graph and returns its outputs (``GraphedStep``: the captured tensors
  themselves, which the next replay overwrites; the other two: fresh
  copies, as JAX returns new arrays).

A capture that fails raises; nothing falls back to the eager function.
Graphs are made wherever every device a process drives is a CUDA device
(``capture_devices``): a single-controller layout on one card or on
several, or one rank of a process-group mesh on its card, whose NCCL
collectives the graph captures (a gloo group's cannot be: every wrapper
then raises when a capture is attempted, never running eagerly in its
place, and the caller runs its ``eager`` form).  On the CPU every factory
returns the eager function.

One process driving several cards (JAX's single controller over a mesh of
many devices) captures one graph over all of them: the capture stream is
on the first device, and a side stream on each other device joins the
capture (it waits on the capture stream at the start, and the capture
stream waits on it at the end), so its kernels and the copies between the
cards are nodes of the same graph, in the order the eager code puts them.
Each side stream's allocations during the capture go to the graph's pool
on its device (``_joined``), as the capture stream's do on the first, so no
tensor the graph reads is freed into the memory that other work takes; the
pool on a side device is released with the graph.  Current streams are
per thread, and autograd runs each card's part of a backward in a worker
thread of its own by default, whose current stream is not the capture's:
a graph with a backward runs it with autograd's multithreading off
(``torch.autograd.set_multithreading_enabled(False)``, thread-local), so
that every node, on every card, runs in the capturing thread on the stream
its forward ran on, the capture's.  A replay is launched on the first
device's current stream, which first waits on every other device's current
stream, and each of those then waits on the replay, so work queued around
the call on any card stays in order.

Counts: the kernel wrappers count a captured kernel once in
``native.LAUNCHES`` (they ran at capture); each replay adds the graph's
kernels to ``native.REPLAYED``.  ``Graph.nodes`` counts the graph's kernel
and memory nodes as libcuda holds them (read once, at capture),
``Graph.pool_bytes`` the device memory the capture reserved (by device in
``Graph.pool_by_device``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import weakref
from collections import Counter
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from .. import native

__all__ = ["Graph", "GraphedStep", "GraphedTrainStep", "GraphedFunction", "GraphedCall",
           "graph_nodes", "capture_devices", "capture_streams", "check_capturable",
           "graph_callable",
           "graph_train_step", "train_once",
           "graph_cache_call", "cache_key"]

# CUgraphNodeType (cuda.h): a kernel, a memory copy, a memory set
_CU_KERNEL, _CU_MEMCPY, _CU_MEMSET = 0, 1, 2


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> Optional[Dict[str, int]]:
    """The captured graph's nodes by kind (``kernels``, ``copies``: memory
    copies and sets, ``other``), read through libcuda; None where this
    PyTorch keeps no graph to read (``keep_graph``)."""
    try:
        raw = graph.raw_cuda_graph()
    except (AttributeError, RuntimeError):
        return None
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(n)) != 0:
        return None
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(ctypes.c_void_p(raw), nodes, ctypes.byref(n)) != 0:
        return None
    kinds, kind = Counter(), ctypes.c_int()
    for node in nodes:
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds[kind.value] += 1
    copies = kinds[_CU_MEMCPY] + kinds[_CU_MEMSET]
    return {"kernels": kinds[_CU_KERNEL], "copies": copies,
            "other": n.value - kinds[_CU_KERNEL] - copies}


def _new_graph() -> Tuple["torch.cuda.CUDAGraph", bool]:
    """A graph that keeps its captured form for ``graph_nodes`` where this
    PyTorch can, and whether it does."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True), True
    except TypeError:
        return torch.cuda.CUDAGraph(), False


def capture_devices(devices: Iterable) -> Optional[Tuple[torch.device, ...]]:
    """The CUDA devices ``devices`` name, each once, the first named first
    (where a graph's capture stream lives), or None where any is not a CUDA
    device: a layout on one card (a mesh of ``cuda:0`` repeated) or on
    several is captured as CUDA graphs; the CPU runs eagerly."""
    found = []
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            return None
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d not in found:
            found.append(d)
    return tuple(found) or None


def capture_streams(devices: Sequence[torch.device]) -> Tuple["torch.cuda.Stream", ...]:
    """A new stream on each of ``devices`` (``capture_devices``' order): the
    first captures, the others join its captures."""
    return tuple(torch.cuda.Stream(d) for d in devices)


def check_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Raise a ``ValueError`` unless every param group of ``optimizer`` was
    built with ``capturable=True``, which a captured ``step()`` needs (its
    step count and bias correction on the device; PyTorch refuses to
    capture any other group, ``fused=True`` ones included).  Needs no
    CUDA."""
    for i, group in enumerate(optimizer.param_groups):
        if not group.get("capturable", False):
            raise ValueError(
                f"param group {i} of the {type(optimizer).__name__} is not capturable: a train "
                f"step on CUDA devices is captured as a CUDA graph, so build the optimizer "
                f"with capturable=True (torch.optim.AdamW(params, ..., capturable=True))")


@dataclasses.dataclass
class Graph:
    """One captured signature: the graph, its inputs and outputs, the
    kernels the wrappers launched into it, its nodes, the memory its
    capture reserved on its devices (in all, and by device), the tensors it
    reads that nothing else keeps (held so they are never freed into the
    pool), its replays so far, and the devices it spans (the capture
    stream's first)."""

    graph: "torch.cuda.CUDAGraph"
    inputs: tuple
    outputs: tuple
    launches: Dict[str, int]
    nodes: Optional[Dict[str, int]]
    pool_bytes: int
    held: list
    replays: int = 0
    devices: Tuple[torch.device, ...] = ()
    pool_by_device: Dict[str, int] = dataclasses.field(default_factory=dict)

    def replay(self, streams: Optional[Sequence["torch.cuda.Stream"]] = None) -> None:
        """One replay on the first device's current stream, in order with
        the work queued on every device's current stream (see the module's
        docstring); ``streams``, where given, stand for the current streams
        of ``devices`` (another thread's)."""
        home, *others = streams or [torch.cuda.current_stream(d) for d in self.devices]
        for s in others:
            home.wait_stream(s)
        self.graph.replay()
        for s in others:
            s.wait_stream(home)
        self.replays += 1
        for k, n in self.launches.items():
            native.REPLAYED[k] += n


@contextlib.contextmanager
def _joined(home: "torch.cuda.Stream", others: Sequence["torch.cuda.Stream"], pool):
    """Inside a capture on ``home``: each of ``others`` (a stream on another
    device) made its device's current stream and joined to the capture,
    its allocations going to ``pool`` on its device; the current device is
    ``home``'s within.  At the end ``home`` waits on each, which ends their
    part in the capture."""
    with contextlib.ExitStack() as stack:
        for s in others:
            stack.enter_context(torch.cuda.stream(s))
            s.wait_stream(home)
            torch._C._cuda_beginAllocateCurrentStreamToPool(s.device.index, pool)
            stack.callback(torch._C._cuda_endAllocateToPool, s.device.index, pool)
        stack.enter_context(torch.cuda.device(home.device))
        try:
            yield
        finally:
            for s in others:
                home.wait_stream(s)


def _capture(fn: Callable, streams: Sequence["torch.cuda.Stream"], pool, generators=(),
             held=(), inputs=()) -> Graph:
    """``fn()`` (returning a tuple of tensors) captured on ``streams[0]``
    into ``pool``, the other streams (one a further device) joined
    (``_joined``), with ``generators`` registered so that each replay draws
    fresh numbers from them.  Raises if the graph holds fewer kernels than
    its wrappers launched: a launch left the capture."""
    graph, kept = _new_graph()
    for g in generators:
        graph.register_generator_state(g)
    before = dict(native.LAUNCHES)
    devices = tuple(s.device for s in streams)
    # the capture empties the allocator's cache first: measure after that
    gc.collect()
    torch.cuda.empty_cache()
    reserved = [torch.cuda.memory_reserved(d) for d in devices]
    with torch.cuda.graph(graph, pool=pool, stream=streams[0]), _joined(streams[0], streams[1:],
                                                                         pool):
        outputs = tuple(fn())
    for d in devices[1:]:
        # the graph's own pool on the capture device goes with the graph; so
        # do the pools its capture took on the other devices
        weakref.finalize(graph, torch._C._cuda_releasePool, d.index, pool)
    launches = {k: n - before[k] for k, n in native.LAUNCHES.items() if n > before[k]}
    nodes = None
    if kept:
        nodes = graph_nodes(graph)
        graph.instantiate()      # now, so that the first replay costs no more
    if nodes is not None and nodes["kernels"] < sum(launches.values()):
        raise RuntimeError(f"the graph holds {nodes['kernels']} kernels, fewer than the "
                           f"{sum(launches.values())} its wrappers launched: a launch left "
                           f"the capture")
    by_device = {str(d): torch.cuda.memory_reserved(d) - r for d, r in zip(devices, reserved)}
    return Graph(graph=graph, inputs=tuple(inputs), outputs=outputs, launches=launches,
                 nodes=nodes, pool_bytes=sum(by_device.values()), held=list(held),
                 devices=devices, pool_by_device=by_device)


class GraphedStep:
    """``impl`` captured once per input signature and replayed (see the
    module's docstring): a serving engine's step.  ``streams`` are the
    capture stream and one a further device the step spans
    (``capture_streams``), and ``pool`` the memory pool the engine's graphs
    share;
    ``n_out`` is the number of outputs ``impl`` returns, checked at
    capture; ``generators`` are the ``torch.Generator``s ``impl`` draws
    from.  The first call runs ``impl`` on the capture stream; a later call
    copies its inputs into the captured ones where they are other tensors
    (the engine passes its own static buffers: no copy) and returns the
    captured outputs, which the next replay overwrites.  A bound method is
    held weakly, so that the engine that holds this step, and its graphs,
    go with the engine.  ``refuse``, where set, is why no graph can be
    captured (``collectives.capture_refusal``): a call that would capture
    raises it."""

    def __init__(self, impl: Callable, n_out: int, streams: Sequence["torch.cuda.Stream"], pool,
                 generators=(), refuse: Optional[str] = None):
        self._impl = weakref.WeakMethod(impl) if hasattr(impl, "__self__") else lambda: impl
        self.n_out, self.streams, self.pool = n_out, tuple(streams), pool
        self.stream = self.streams[0]
        self.generators = tuple(generators)
        self.refuse = refuse
        self.graphs: Dict[tuple, Graph] = {}

    @property
    def impl(self) -> Callable:
        return self._impl()

    def __call__(self, *inputs):
        key = tuple((tuple(x.shape), x.dtype) for x in inputs)
        g = self.graphs.get(key)
        if g is None:
            return self._capture(key, inputs)
        for x, static in zip(inputs, g.inputs):
            if x is not static:
                static.copy_(x, non_blocking=True)
        g.replay()
        return g.outputs

    def _capture(self, key, inputs):
        if self.refuse:
            raise RuntimeError(self.refuse)
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = self.impl(*inputs)
        for t in out:
            t.record_stream(cur)
        if len(out) != self.n_out:
            raise ValueError(f"the step returned {len(out)} outputs, {self.n_out} expected")
        self.graphs[key] = _capture(lambda: self.impl(*inputs), self.streams, self.pool,
                                    self.generators, native.scratch_in_use(), inputs)
        cur.wait_stream(self.stream)
        return out


class GraphedTrainStep:
    """A training step ``step(params, tokens) -> loss`` (``loss_fn(params,
    tokens)`` minimised by ``optimizer`` over ``params``' parameters)
    captured as one CUDA graph per ``params`` and signature of ``tokens``
    over the CUDA devices of ``devices`` (``capture_devices``' tuple: one
    card, or one graph across several).

    The first call runs the eager step (``eager``): that run is the call's
    result, and it creates the optimizer's state.  Then the gradients are
    set to None and one step is captured on the capture stream: forward,
    ``backward()`` (whose leaves' gradients the capture allocates in the
    pool: every replay writes them anew, where a gradient left in place
    would accumulate) and ``optimizer.step()``, the backward in the
    capturing thread (``train_once``).  The eager step's gradients
    are copied into the captured ones, so ``p.grad`` holds the last step's
    gradients after every call.  A later call copies ``tokens`` into the
    captured buffer, replays the graph and returns a fresh copy of the 0-d
    loss.  The optimizer must be capturable (``check_capturable``, here),
    and its hyper-parameters are captured as they are: a learning rate
    changed later needs a tensor ``lr``.  ``sync(params)``, where given,
    runs between ``backward()`` and the optimizer's step (a process-group
    step's gradient sums, captured with the rest on NCCL); ``refuse``,
    where set, is why no graph can be captured (``capture_refusal``): a
    call that would capture raises it, and ``eager`` runs the step."""

    def __init__(self, loss_fn: Callable, optimizer: torch.optim.Optimizer, devices,
                 sync: Optional[Callable] = None, refuse: Optional[str] = None):
        check_capturable(optimizer)
        self.loss_fn, self.optimizer, self.sync, self.refuse = loss_fn, optimizer, sync, refuse
        self.streams = capture_streams(devices)
        self.stream = self.streams[0]
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[tuple, Graph] = {}

    def eager(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """One optimizer step run eagerly; returns the loss (before the
        step)."""
        return train_once(self.loss_fn, self.optimizer, params, tokens, self.sync)

    def _parameters(self):
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def __call__(self, params, tokens: torch.Tensor) -> torch.Tensor:
        key = (id(params), tuple(tokens.shape), tokens.dtype, tokens.device)
        g = self.graphs.get(key)
        if g is None:
            return self._capture(key, params, tokens)
        g.inputs[0].copy_(tokens, non_blocking=True)
        g.replay()
        for p, grad in zip(self._parameters(), g.held[1]):
            p.grad = grad
        return g.outputs[0].clone()

    def _capture(self, key, params, tokens):
        if self.refuse:
            raise RuntimeError(self.refuse)
        loss = self.eager(params, tokens)
        eager_grads = [p.grad for p in self._parameters()]
        static = tokens.detach().clone()
        self.optimizer.zero_grad(set_to_none=True)
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)

        def step():
            return (train_once(self.loss_fn, self.optimizer, params, static, self.sync,
                               zero=False),)

        g = _capture(step, self.streams, self.pool, inputs=(static,))
        cur.wait_stream(self.stream)
        grads = [p.grad for p in self._parameters()]
        for mine, eager in zip(grads, eager_grads):
            if mine is not None and eager is not None:
                mine.copy_(eager)
        # params keeps its id (the key) and the captured gradients stay out
        # of the pool's free memory
        g.held += [params, grads]
        self.graphs[key] = g
        return loss


@dataclasses.dataclass
class _Signature:
    """A ``GraphedFunction``'s graphs of one signature: the forward, the
    backward (None without gradients), which inputs take gradients, and
    the number of forward replays so far."""

    fwd: Graph
    bwd: Optional[Graph]
    requires: Tuple[bool, ...]
    generation: int = 0


class _Replayed(torch.autograd.Function):
    """A replay of a signature's forward graph; its backward replays the
    backward graph."""

    @staticmethod
    def forward(ctx, sig: _Signature, *inputs):
        for x, static in zip(inputs, sig.fwd.inputs):
            static.copy_(x)
        sig.fwd.replay()
        sig.generation += 1
        ctx.sig, ctx.generation = sig, sig.generation
        # the caller's current streams: autograd may call the backward in a
        # thread of its own, whose current streams on the other cards differ
        ctx.streams = tuple(torch.cuda.current_stream(d) for d in sig.fwd.devices)
        return sig.fwd.outputs[0].clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        sig = ctx.sig
        if ctx.generation != sig.generation:
            raise RuntimeError("the backward of a graphed call after a later call with the same "
                               "signature: the graph's saved activations are the later call's; "
                               "run each call's backward before the next call")
        sig.bwd.inputs[0].copy_(grad)
        # the first card's stream is this thread's (autograd puts the node
        # on its forward's stream and orders ``grad`` before it)
        sig.bwd.replay((torch.cuda.current_stream(sig.bwd.devices[0]), *ctx.streams[1:]))
        grads = iter(sig.bwd.outputs)
        return (None, *(next(grads).clone() if r else None for r in sig.requires))


class GraphedFunction:
    """``fn(*tensors) -> tensor``, differentiable, captured per input
    signature (shapes, dtypes, devices, which inputs require grad, and
    whether grad mode is on): a forward graph, and a backward graph (the
    gradients with respect to the inputs that require them) where the call
    is differentiable, over the CUDA devices of ``devices`` (one card, or
    one graph each across several).  The first call runs ``fn`` eagerly (the
    call's result), then one eager forward and backward on copies of the
    inputs (which uploads the backward kernels' tables), then the captures,
    each backward in the capturing thread (the module's docstring).  A
    later call replays the forward graph into a fresh output whose backward
    replays the backward graph into fresh gradients.  A signature's graphs
    hold one call's saved activations: the backward of a call must run
    before the next call of its signature, or it raises.  ``eager`` is
    ``fn``; ``refuse``, where set, is why no graph can be captured: a call
    that would capture raises it."""

    def __init__(self, fn: Callable, devices, refuse: Optional[str] = None):
        self.eager, self.refuse = fn, refuse
        self.streams = capture_streams(devices)
        self.stream = self.streams[0]
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[tuple, _Signature] = {}

    def __call__(self, *inputs):
        grad = torch.is_grad_enabled() and any(x.requires_grad for x in inputs)
        key = (tuple((tuple(x.shape), x.dtype, x.device, x.requires_grad) for x in inputs), grad)
        sig = self.graphs.get(key)
        if sig is None:
            if self.refuse:
                raise RuntimeError(self.refuse)
            out = self.eager(*inputs)
            self.graphs[key] = self._capture(inputs, grad)
            return out
        return _Replayed.apply(sig, *inputs)

    def _capture(self, inputs, grad: bool) -> _Signature:
        static = tuple(x.detach().clone().requires_grad_(grad and x.requires_grad)
                       for x in inputs)
        wants = [x for x in static if x.requires_grad]
        with torch.autograd.set_multithreading_enabled(False):
            if grad:
                warm = self.eager(*static)
                torch.autograd.grad(warm, wants, torch.zeros_like(warm))
                del warm
            cur = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(cur)
            fwd = _capture(lambda: (self.eager(*static),), self.streams, self.pool,
                           inputs=static)
            bwd = None
            if grad:
                g_out = torch.zeros_like(fwd.outputs[0])
                # retain_graph: the saved activations stay held, never freed
                # into the pool between a forward replay and its backward's
                bwd = _capture(lambda: torch.autograd.grad(fwd.outputs[0], wants, g_out,
                                                           retain_graph=True),
                               self.streams, self.pool, inputs=(g_out,))
        cur.wait_stream(self.stream)
        return _Signature(fwd, bwd, tuple(x.requires_grad for x in static))


def train_once(loss_fn: Callable, optimizer: torch.optim.Optimizer, params,
               tokens: torch.Tensor, sync: Optional[Callable] = None,
               zero: bool = True) -> torch.Tensor:
    """One optimizer step on ``params`` in place: the loss, ``backward()``,
    ``sync(params)`` where given, the optimizer's step; returns the loss
    (before the step).  ``zero`` first sets the gradients to None.  The
    step runs with autograd's multithreading off: the backward's nodes on
    every card run in the calling thread, on their forwards' streams (a
    capture's across cards; the module's docstring), as the CPU's always
    do."""
    if zero:
        optimizer.zero_grad(set_to_none=True)
    with torch.autograd.set_multithreading_enabled(False):
        loss = loss_fn(params, tokens)
        loss.backward()
        if sync is not None:
            sync(params)
        optimizer.step()
    return loss.detach()


def graph_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer, mesh,
                     sync: Optional[Callable] = None) -> Callable:
    """A train step ``step(params, tokens) -> loss`` on ``mesh``
    (``train_once``): a ``GraphedTrainStep`` where the devices the caller
    drives are CUDA devices (a single-controller layout on one card or
    across several, one graph over them, or a process-group rank on its
    card), else the eager step (the CPU)."""
    devices = capture_devices(mesh.local_devices())
    if devices is not None:
        return GraphedTrainStep(loss_fn, optimizer, devices, sync, mesh.capture_refusal())
    return lambda params, tokens: train_once(loss_fn, optimizer, params, tokens, sync)


def graph_callable(fn: Callable, mesh) -> Callable:
    """``fn`` as a ``GraphedFunction`` where the devices the caller drives
    on ``mesh`` are CUDA devices (``capture_devices``: one card, or one
    graph across several), else ``fn`` itself (the CPU)."""
    devices = capture_devices(mesh.local_devices())
    if devices is None:
        return fn
    return GraphedFunction(fn, devices, mesh.capture_refusal())


def cache_key(caches) -> tuple:
    """The identity of ``caches`` (a ``PagedKVCache`` or nested lists of
    them): the ``data_ptr`` of each of their tensors, in order."""
    if isinstance(caches, (list, tuple)):
        return tuple(cache_key(c) for c in caches)
    return tuple(None if t is None else t.data_ptr()
                 for t in (caches.k_pages, caches.v_pages, caches.k_scales, caches.v_scales,
                           caches.page_tables, caches.lengths))


class GraphedCall:
    """A serving callable ``fn(*args)`` that reads and updates KV caches in
    place, captured per signature and replayed.  Each argument is a tensor
    or caches (a ``PagedKVCache`` or nested lists of them); ``prepare``,
    where given, first maps the public arguments to those (on the host,
    before any graph: a prefill's slot, start and length become a device
    vector).  The signature is the tensors' shapes, dtypes and devices and
    the identity of the caches (``cache_key``: every cache tensor's
    ``data_ptr``): a graph reads and writes the cache tensors at the
    addresses it captured, so it serves only the caches it was captured
    with, and another cache of the same shape gets its own graph rather
    than a replay onto the first one's.  The first call of a signature
    runs ``fn`` on the capture stream (the call's result and its update of
    the caches), then captures it; a later call copies the tensors into the
    captured inputs and replays.  It returns a fresh copy of a tensor
    output (JAX returns new arrays), or the argument that ``fn`` returned
    (an append returns its caches, updated in place where JAX's return new
    ones).  ``eager`` runs ``fn`` without a graph; ``refuse``, where set,
    is why no graph can be captured: a call that would capture raises it."""

    def __init__(self, fn: Callable, devices, refuse: Optional[str] = None,
                 prepare: Optional[Callable] = None):
        self.fn, self.refuse, self.prepare = fn, refuse, prepare
        self.streams = capture_streams(devices)
        self.stream = self.streams[0]
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[tuple, Graph] = {}
        self._returns: Dict[tuple, Optional[int]] = {}

    def eager(self, *args):
        return self.fn(*(self.prepare(*args) if self.prepare else args))

    def __call__(self, *args):
        if self.prepare:
            args = self.prepare(*args)
        key = tuple((tuple(a.shape), a.dtype, a.device) if torch.is_tensor(a) else cache_key(a)
                    for a in args)
        g = self.graphs.get(key)
        if g is None:
            return self._capture(key, args)
        for a, static in zip(args, g.inputs):
            if static is not None:
                static.copy_(a, non_blocking=True)
        g.replay()
        i = self._returns[key]          # -1: the tensor output; else an argument or None
        return g.outputs[0].clone() if i == -1 else None if i is None else args[i]

    def _capture(self, key, args):
        if self.refuse:
            raise RuntimeError(self.refuse)
        static = tuple(a.detach().clone() if torch.is_tensor(a) else None for a in args)
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = self.fn(*args)
        tensor_out = torch.is_tensor(out)
        if tensor_out:
            out.record_stream(cur)
        self._returns[key] = -1 if tensor_out else next(
            (i for i, a in enumerate(args) if a is out), None)
        captured = tuple(a if s is None else s for a, s in zip(args, static))

        def call():
            o = self.fn(*captured)
            return (o,) if tensor_out else ()

        g = _capture(call, self.streams, self.pool, held=[args, *native.scratch_in_use()],
                     inputs=static)
        self.graphs[key] = g
        cur.wait_stream(self.stream)
        return out


def graph_cache_call(fn: Callable, mesh, prepare: Optional[Callable] = None):
    """``fn`` (see ``GraphedCall``) as the serving callables return it on
    ``mesh``: a ``GraphedCall`` where the devices the caller drives are CUDA
    devices (a single-controller mesh on one card or on several, or a
    process-group rank on its card), else ``fn`` (after ``prepare``)
    itself."""
    devices = capture_devices(mesh.local_devices())
    if devices is None:
        return fn if prepare is None else lambda *args: fn(*prepare(*args))
    return GraphedCall(fn, devices, mesh.capture_refusal(), prepare)
