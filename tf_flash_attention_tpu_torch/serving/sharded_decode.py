"""Head-sharded paged decode over a ``model`` mesh axis (port of
``serving/sharded_decode.py``).

The tensor-parallel serving topology: every shard holds the KV pages of
its KV heads (with their scales) and runs the paged decode kernel on its
own heads, so attention needs no collective; the projections around it
do the reduce (``serving/engine.py``).  Page tables and lengths are the
same on every shard.

A head-sharded cache is a list of ``PagedKVCache``, the head shards the
caller drives, each on its shard's device, as in ``seq_sharded_decode.py``:
every shard of the axis where one process drives them all (devices may
repeat: four shards on one card run the same code), the rank's own over a
process group, whose outputs then join by an ``all_gather`` over the
axis.  Shard ``t`` of ``tp`` holds KV heads ``t * n_kv / tp .. (t + 1) *
n_kv / tp`` and so serves query heads ``t * n_q / tp ..``: a GQA group
never spans two shards.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..parallel.collectives import all_gather
from ..parallel.mesh import AXIS_MODEL, Mesh
from .decode import paged_decode_attention
from .graphs import graph_cache_call
from .kv_cache import KVCacheConfig, PagedKVCache

__all__ = ["sharded_paged_decode", "shard_cache_heads", "head_shard_config"]


def head_shard_config(cfg: KVCacheConfig, tp: int) -> KVCacheConfig:
    """One head shard's cache configuration: ``n_kv_heads // tp`` heads;
    raises unless ``tp`` divides the KV heads."""
    if cfg.n_kv_heads % tp:
        raise ValueError(f"n_kv_heads {cfg.n_kv_heads} not divisible by tp {tp}")
    return dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // tp)


def shard_cache_heads(cache: PagedKVCache, cfg: KVCacheConfig, mesh: Mesh,
                      model_axis: str = AXIS_MODEL) -> List[PagedKVCache]:
    """A full cache split into the head shards the caller drives (all of
    them, or the rank's own over a process group), each a copy on its
    shard's device (set-up utility; the engine creates its shards empty)."""
    ax = mesh.axis(model_axis)
    n = head_shard_config(cfg, ax.size).n_kv_heads

    def part(x, t, dev):
        return None if x is None else x[t * n:(t + 1) * n].to(dev, copy=True)

    return [PagedKVCache(k_pages=part(cache.k_pages, t, dev), v_pages=part(cache.v_pages, t, dev),
                         k_scales=part(cache.k_scales, t, dev),
                         v_scales=part(cache.v_scales, t, dev),
                         page_tables=cache.page_tables.to(dev, copy=True),
                         lengths=cache.lengths.to(dev, copy=True))
            for t, dev in enumerate(mesh.local_grid(model_axis), ax.index)]


def sharded_paged_decode(mesh: Mesh, cfg: KVCacheConfig, model_axis: str = AXIS_MODEL,
                         scale: Optional[float] = None):
    """Build ``fn(q, caches) -> o``: paged decode with the KV heads sharded
    over ``model_axis``.

    ``q`` (max_seqs, n_q_heads, d) on any device; ``caches`` one
    ``PagedKVCache`` of ``n_kv_heads // tp`` heads a shard the caller
    drives, on the shard's device (``shard_cache_heads``).  Each shard
    decodes its own query heads and the outputs join on the head axis (an
    ``all_gather`` over a process group), on ``q``'s device.  A
    ``graphs.GraphedCall`` where the caller drives CUDA devices."""
    ax = mesh.axis(model_axis)
    tp, local_cfg = ax.size, head_shard_config(cfg, ax.size)
    n = len(mesh.local_grid(model_axis))

    def fn(q, caches):
        if len(caches) != n:
            raise ValueError(f"{len(caches)} head-shard caches for the {n} shards of the mesh "
                             f"axis this process drives")
        if q.shape[1] % tp:
            raise ValueError(f"{q.shape[1]} query heads not divisible by tp {tp}")
        n_q = q.shape[1] // tp
        outs = [paged_decode_attention(q[:, t * n_q:(t + 1) * n_q].to(c.k_pages.device), c,
                                       local_cfg, scale=scale)
                for t, c in enumerate(caches, ax.index)]
        return torch.cat([o.to(q.device) for o in all_gather(outs, ax)], dim=1)
    return graph_cache_call(fn, mesh)
