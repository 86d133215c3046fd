"""Sequence-sharded (context-parallel) paged attention (PyTorch port).

Counterpart of the JAX package's ``serving/seq_sharded_decode.py``.  The KV
cache of a sequence is sharded along the sequence over a mesh axis: global
logical page ``g`` lives on shard ``g % n`` at local logical index
``g // n``.  Every shard scans only its own pages with the ordinary paged
kernels, which return partial ``(o, l, m)`` online-softmax statistics
(``returning_l_m``, with ``page_stride = n`` and ``page_offset`` = the
shard's index so that masking and window skipping see global positions);
one exact merge (``_merge_partials``) combines them.

A sharded cache is a list of ``PagedKVCache``, the shards the caller
drives, each on its shard's device.  Single-controller, as the JAX
``shard_map`` is, one process drives every shard and the list holds them
all (devices may repeat: four shards on one card or on the CPU run the
same code); queries arrive on the first device, are copied to each
shard's device (no copy when the devices are the same), and the partials
come back to the first device for the merge.  Over a process group (a
``Mesh`` of one rank a slot) the list holds the rank's own shard, and
``axis`` (``Mesh.axis``) gives its index and its line's group.  The merge
and the global lengths are ``collectives.py``'s ``pmax``/``psum``, as the
JAX merge is, in either form: a sum in shard order, so a rank's merge is
bit-equal to the single-controller one.  Appends route to each position's
owner shard: every shard's ``append_tokens_batched`` takes the global
lengths (the sum of the shards' local ones) with its page stride and
offset and stores only the tokens on its own pages (on the card the owner
test runs in the kernel).

The four callables (``seq_sharded_paged_decode``, ``_prefill``,
``seq_sharded_append`` and ``sharded_decode.sharded_paged_decode``) are
compiled as JAX's ``jit(shard_map)`` is where the caller drives CUDA
devices (one card, or several from one process: one graph across them):
``graphs.GraphedCall``, one graph a signature and set of caches.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..mask_rules import CausalRule, MaskRule
from ..parallel.collectives import Axis, pmax, psum
from ..parallel.mesh import Mesh
from .decode import paged_decode_attention, paged_multitoken_decode
from .graphs import graph_cache_call
from .kv_cache import (KVCacheConfig, PagedKVCache, append_tokens_batched, write_prompt,
                       write_tokens_meta)
from .prefill import prefill_meta, prefill_with_meta
from .sharded_decode import head_shard_config

__all__ = ["create_seq_sharded_cache", "write_prompt_seq_sharded",
           "seq_sharded_paged_decode", "seq_sharded_paged_prefill",
           "seq_sharded_append", "global_lengths", "decode_merged", "prefill_merged",
           "write_tokens_sharded", "append_owned", "slot_meta"]


def create_seq_sharded_cache(cfg: KVCacheConfig, mesh: Mesh, axis: str,
                             head_axis=None):
    """One empty ``PagedKVCache`` per shard of ``axis`` the caller drives
    (every shard, or over a process group its own), on its device.  ``cfg``
    describes ONE shard (``n_pages`` and ``max_pages_per_seq`` are
    per-shard capacities).

    With ``head_axis`` the KV heads shard over that mesh axis too (tensor x
    context parallel): a list over the seq shards of lists over the head
    shards, each cache of ``n_kv_heads // tp`` heads on the device at (seq
    shard, head shard).  The head shards of a seq shard map the same pages:
    they share one page-table tensor where they share a device (the caller
    keeps copies on other devices equal); each keeps its own lengths, as
    each of its appends advances them."""
    if head_axis is None:
        return [PagedKVCache.create(cfg, dev) for dev in mesh.local_grid(axis)]
    loc = head_shard_config(cfg, int(mesh.shape[head_axis]))
    out = []
    for row in mesh.local_grid(axis, head_axis):
        caches, tables = [], {}
        for dev in row:
            c = PagedKVCache.create(loc, dev)
            c.page_tables = tables.setdefault(c.page_tables.device, c.page_tables)
            caches.append(c)
        out.append(caches)
    return out


def write_prompt_seq_sharded(caches: List[PagedKVCache], cfg: KVCacheConfig, mesh: Mesh,
                             axis: str, slot: int, per_shard_pages, k: torch.Tensor,
                             v: torch.Tensor) -> List[PagedKVCache]:
    """Write a prompt's K/V (n_kv_heads, t, head_dim) round-robin across the
    shards the caller drives, in place (set-up utility).
    ``per_shard_pages[r]`` lists shard ``r``'s free physical pages to use
    (host ints)."""
    ax = mesh.axis(axis)
    n, ps = ax.size, cfg.page_size
    n_global = -(-k.shape[1] // ps)
    for r, cache in enumerate(caches, ax.index):
        g_pages = range(r, n_global, n)                # global pages on shard r
        if not g_pages:
            continue
        dev = cache.k_pages.device
        k_loc = torch.cat([k[:, g * ps:(g + 1) * ps] for g in g_pages], dim=1).to(dev)
        v_loc = torch.cat([v[:, g * ps:(g + 1) * ps] for g in g_pages], dim=1).to(dev)
        write_prompt(cache, cfg, slot, list(per_shard_pages[r])[:len(g_pages)], k_loc, v_loc)
    return caches


def _axis(caches, axis: Optional[Axis]) -> Axis:
    """``axis``, or the single-controller axis of ``caches``' shards."""
    return Axis(len(caches)) if axis is None else axis


def _merge_partials(parts, device, axis: Optional[Axis] = None) -> torch.Tensor:
    """Exact cross-shard online-softmax merge (base-2 domain, as in the
    kernels): the partials ``[(o, l, m)]`` of the caller's shards -> float32
    o on ``device`` (JAX's ``pmax`` of m and ``psum`` of the weighted o and
    of l, in shard order).  ``o`` arrives rounded to the activation dtype,
    as the JAX kernels write it before their merge."""
    parts = [tuple(x.to(device) for x in p) for p in parts]
    ax = _axis(parts, axis)
    m_star = pmax([m for _, _, m in parts], ax)
    ws = [l * torch.exp2(m - m_star) for _, l, m in parts]   # 0 for shards with no keys
    num = psum([o.float() * w[..., None] for (o, _, _), w in zip(parts, ws)], ax)
    den = psum(ws, ax)
    return num / torch.where(den == 0.0, torch.ones_like(den), den)[..., None]


def global_lengths(caches: List[PagedKVCache], device, axis: Optional[Axis] = None
                   ) -> torch.Tensor:
    """The sequences' global lengths: the sum of the shards' local ones."""
    return psum([c.lengths.to(device) for c in caches], _axis(caches, axis)).to(torch.int32)


def decode_merged(q: torch.Tensor, caches: List[PagedKVCache], cfg: KVCacheConfig,
                  glob: torch.Tensor, *, scale: Optional[float] = None,
                  rule: MaskRule = CausalRule(), axis: Optional[Axis] = None) -> torch.Tensor:
    """Context-parallel decode of ``q`` (S, n_q, d), or (S, gamma, n_q, d)
    for the multi-token verify, against every shard (the caller's, merged
    over ``axis`` where it is a process group's); ``glob`` (S,) int32
    holds the global lengths the queries' K/V are counted in.  Returns o in
    ``q``'s dtype on ``q``'s device.  One shard is the plain decode."""
    fn = paged_decode_attention if q.dim() == 3 else paged_multitoken_decode
    ax = _axis(caches, axis)
    if ax.size == 1:
        return fn(q, caches[0], cfg, scale=scale, rule=rule)
    parts = []
    for r, cache in enumerate(caches, ax.index):
        dev = cache.k_pages.device
        parts.append(fn(q.to(dev), cache, cfg, scale=scale, rule=rule, returning_l_m=True,
                        page_stride=ax.size, page_offset=r, global_lengths=glob.to(dev)))
    return _merge_partials(parts, q.device, ax).to(q.dtype)


def prefill_merged(q: torch.Tensor, caches: List[PagedKVCache], cfg: KVCacheConfig,
                   meta: torch.Tensor, *, scale: Optional[float] = None,
                   rule: MaskRule = CausalRule(), axis: Optional[Axis] = None) -> torch.Tensor:
    """Context-parallel chunked prefill: every shard scans its own pages for
    the whole chunk, and the partials merge.  ``meta`` holds a row a shard
    of the axis (``prefill.prefill_meta`` with the shards' count as the page
    stride), on any device: each row goes to its shard's.  One shard is the
    plain prefill."""
    ax = _axis(caches, axis)
    if ax.size == 1:
        return prefill_with_meta(q, caches[0], cfg, meta[0].to(q.device), scale=scale,
                                 rule=rule)
    parts = []
    for r, cache in enumerate(caches, ax.index):
        dev = cache.k_pages.device
        parts.append(prefill_with_meta(q.to(dev), cache, cfg, meta[r].to(dev), scale=scale,
                                       rule=rule, returning_l_m=True, page_stride=ax.size))
    return _merge_partials(parts, q.device, ax).to(q.dtype)


def write_tokens_sharded(caches: List[PagedKVCache], cfg: KVCacheConfig, meta: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor, axis: Optional[Axis] = None) -> None:
    """A prompt chunk's K/V (n_kv_heads, chunk, head_dim) into every shard
    the caller drives: each keeps the rows of its own pages (the chunk
    write with the page stride; ``meta`` holds a row a shard of the axis,
    ``kv_cache.chunk_write_meta``) and its local length becomes its
    owned-token count."""
    ax = _axis(caches, axis)
    for r, cache in enumerate(caches, ax.index):
        dev = cache.k_pages.device
        write_tokens_meta(cache, cfg, meta[r].to(dev), k.to(dev), v.to(dev),
                          page_stride=ax.size)


def append_owned(caches: List[PagedKVCache], cfg: KVCacheConfig, k_new: torch.Tensor,
                 v_new: torch.Tensor, active: torch.Tensor, glob: torch.Tensor,
                 trash_page: int, axis: Optional[Axis] = None) -> None:
    """Appends of every active slot from global position ``glob`` (S,)
    int32 on: ``k_new, v_new`` (S, n_kv, d), one token, or (S, T, n_kv, d),
    T tokens at ``glob .. glob + T - 1``, each stored by the owner shard of
    its position; the other shards store nothing and do not advance.  One
    launch a shard; one shard is the plain append."""
    ax = _axis(caches, axis)
    if ax.size == 1:
        append_tokens_batched(caches[0], cfg, k_new, v_new, active, trash_page)
        return
    for r, cache in enumerate(caches, ax.index):
        dev = cache.k_pages.device
        append_tokens_batched(cache, cfg, k_new.to(dev), v_new.to(dev), active.to(dev),
                              trash_page, global_lengths=glob.to(dev), page_stride=ax.size,
                              page_offset=r)


def _check_shards(caches, n):
    if len(caches) != n:
        raise ValueError(f"{len(caches)} shard caches for the {n} shards of the mesh axis "
                         f"this process drives")


def slot_meta(slot, start, true_len, device) -> torch.Tensor:
    """A chunk's (slot, start, true_len), ints or 0-d tensors, as the int32
    vector on ``device`` that the compiled prefill reads."""
    return torch.stack([torch.as_tensor(x, dtype=torch.int32).reshape(()).to(device)
                        for x in (slot, start, true_len)])


def seq_sharded_paged_decode(mesh: Mesh, cfg: KVCacheConfig, axis: str, *,
                             scale: Optional[float] = None, rule: MaskRule = CausalRule()):
    """Build ``fn(q, caches) -> o``: context-parallel decode over ``axis``.

    ``q`` (max_seqs, n_q_heads, d) on the mesh's first device (the rank's,
    over a process group); ``caches`` from ``create_seq_sharded_cache``/
    ``write_prompt_seq_sharded``.  Window rules work: the kernels mask on
    global positions and each shard skips its pages below the window before
    any load.  A ``graphs.GraphedCall`` where the caller drives CUDA
    devices (``graph_cache_call``).
    """
    ax, n = mesh.axis(axis), len(mesh.local_grid(axis))

    def fn(q, caches):
        _check_shards(caches, n)
        return decode_merged(q, caches, cfg, global_lengths(caches, q.device, ax), scale=scale,
                             rule=rule, axis=ax)
    return graph_cache_call(fn, mesh)


def seq_sharded_paged_prefill(mesh: Mesh, cfg: KVCacheConfig, axis: str, *,
                              scale: Optional[float] = None, rule: MaskRule = CausalRule()):
    """Build ``fn(q, caches, slot, start, true_len) -> o``: context-parallel
    chunked prefill.  The chunk's K/V must already be written (round-robin,
    like the rest of the cache).  ``slot``, ``start`` and ``true_len`` (ints
    or 0-d tensors) travel to the device as one int32 vector before the
    call (``slot_meta``), so one graph serves every chunk of a shape."""
    ax, n = mesh.axis(axis), len(mesh.local_grid(axis))

    def fn(q, caches, meta):
        _check_shards(caches, n)
        return prefill_merged(q, caches, cfg,
                              prefill_meta(cfg, meta[0], meta[1], meta[2], rule, ax.size,
                                           q.device),
                              scale=scale, rule=rule, axis=ax)

    def prepare(q, caches, slot, start, true_len):
        return q, caches, slot_meta(slot, start, true_len, q.device)
    return graph_cache_call(fn, mesh, prepare)


def seq_sharded_append(mesh: Mesh, cfg: KVCacheConfig, axis: str, trash_page: int):
    """Build ``fn(caches, k_new, v_new, active) -> caches``: one decode-step
    append routed to each position's owner shard, in place.  The target page
    of every slot must already be mapped in the owner shard's table."""
    ax, n = mesh.axis(axis), len(mesh.local_grid(axis))

    def fn(caches, k_new, v_new, active):
        _check_shards(caches, n)
        append_owned(caches, cfg, k_new, v_new, active,
                     global_lengths(caches, k_new.device, ax), trash_page, ax)
        return caches
    return graph_cache_call(fn, mesh)
