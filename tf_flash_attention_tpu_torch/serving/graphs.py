"""CUDA graphs of the serving engine's steps.

The port's counterpart of the ``jax.jit`` that the JAX engine's
``_compile`` (``serving/engine.py:339-370``) wraps around every step: XLA
runs a step as one program, and a ``GraphedStep`` replays a step as one
CUDA graph, so the host makes one launch where the eager step made a few
hundred.  It wraps a step function ``impl(*inputs) -> outputs`` (a
tuple of tensors) whose body is device work only: no host sync, no tensor
made from host data, every persistent tensor updated in place.  Per input
signature (shapes and dtypes) it captures one ``torch.cuda.CUDAGraph``:

- the first call with a signature runs ``impl`` eagerly on the capture
  stream: that run is the call's result, and it sizes whatever the
  kernels grow lazily (the decode's scratch), so the capture allocates
  nothing that outlives it;
- then it captures a second call on the same stream, which records the
  kernels without running them, with the addresses of the inputs, the
  engine's weights, caches and page tables, and the decode's scratch,
  which the graph holds;
- every later call copies its inputs into the captured ones where they
  are other tensors (the engine passes its own static buffers: no copy),
  replays the graph and returns the captured outputs, which the next
  replay overwrites.

A capture that fails raises; nothing falls back to the eager step.

Counts: the kernel wrappers count a captured kernel once in
``native.LAUNCHES`` (they ran at capture); each replay adds the graph's
kernels to ``native.REPLAYED``.  ``Graph.nodes`` counts the graph's kernel
and memory nodes as libcuda holds them (read once, at capture),
``Graph.pool_bytes`` the device memory the capture reserved.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import weakref
from collections import Counter
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import native

__all__ = ["Graph", "GraphedStep", "graph_nodes"]

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


@dataclasses.dataclass
class Graph:
    """One captured signature of a step: the graph, its inputs and outputs,
    the kernels the wrappers launched into it, its nodes, the memory its
    capture reserved, and the decode scratch it reads (held so it is never
    freed)."""

    graph: "torch.cuda.CUDAGraph"
    inputs: tuple
    outputs: tuple
    launches: Dict[str, int]
    nodes: Optional[Dict[str, int]]
    pool_bytes: int
    held: list
    replays: int = 0


class GraphedStep:
    """``impl`` captured once per input signature and replayed (see the
    module's docstring).  ``stream`` is the capture stream and ``pool`` the
    memory pool the engine's graphs share; ``n_out`` is the number of
    outputs ``impl`` returns, checked at capture.  A bound method is held
    weakly, so that the engine that holds this step, and its graphs, go
    with the engine."""

    def __init__(self, impl: Callable, n_out: int, stream: "torch.cuda.Stream", pool):
        self._impl = weakref.WeakMethod(impl) if hasattr(impl, "__self__") else lambda: impl
        self.n_out, self.stream, self.pool = n_out, stream, pool
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
        g.graph.replay()
        g.replays += 1
        for k, n in g.launches.items():
            native.REPLAYED[k] += n
        return g.outputs

    def _capture(self, key, inputs):
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = self.impl(*inputs)
        for t in out:
            t.record_stream(cur)
        if len(out) != self.n_out:
            raise ValueError(f"the step returned {len(out)} outputs, {self.n_out} expected")
        graph, kept = _new_graph()
        before = dict(native.LAUNCHES)
        # the capture empties the allocator's cache first: measure after that
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.stream.device)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            static_out = self.impl(*inputs)
        cur.wait_stream(self.stream)
        launches = {k: n - before[k] for k, n in native.LAUNCHES.items() if n > before[k]}
        nodes = None
        if kept:
            nodes = graph_nodes(graph)
            graph.instantiate()      # now, so that the first replay costs no more
        if nodes is not None and nodes["kernels"] < sum(launches.values()):
            raise RuntimeError(f"the graph holds {nodes['kernels']} kernels, fewer than the "
                               f"{sum(launches.values())} its wrappers launched: a launch left "
                               f"the capture stream")
        self.graphs[key] = Graph(
            graph=graph, inputs=tuple(inputs), outputs=tuple(static_out), launches=launches,
            nodes=nodes, pool_bytes=torch.cuda.memory_reserved(self.stream.device) - reserved,
            held=native.scratch_in_use())
        return out
