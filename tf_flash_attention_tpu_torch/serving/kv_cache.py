"""Paged, optionally int8-quantized KV cache (PyTorch port).

Counterpart of ``tf_flash_attention_tpu/serving/kv_cache.py`` with the same
layouts, so cache states compare element for element:

  k_pages, v_pages:   (n_kv_heads, n_pages, page_size, head_dim_store)
  k_scales, v_scales: (n_kv_heads, n_pages, 1, page_size) float32
  page_tables:        (max_seqs, max_pages_per_seq) int32
  lengths:            (max_seqs,) int32

Payloads are int8 with one float32 scale per token, or unquantized in the
model dtype.  Unlike the JAX pytree, ``PagedKVCache`` is a mutable holder:
the writes below update its page tensors in place (the JAX engine donates
the caches to get the same effect).

Two writes have CUDA kernels (``csrc/serving_kernels.cu``):
``write_tokens_at`` (chunked prefill, kernel ``kv_chunk_write``) and
``append_tokens_batched`` (decode step, kernel ``kv_append``).  Each has a
plain PyTorch version beside it, which the wrapper takes only for tensors
on the CPU.  Several padding rows or inactive slots may write the reserved
trash page at once; its contents are garbage by design, and nothing reads
it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..block_sizes import LANE, pad_to

__all__ = ["KVCacheConfig", "PagedKVCache", "PageAllocator", "write_tokens_at",
           "append_tokens_batched", "write_prompt", "assign_page",
           "gather_sequence_kv"]

_NOT_PORTED = ("fp8 and int4 KV caches are not ported yet (ROADMAP queue 2: "
               "fp8/int4 variants of the serving kernels)")


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    n_kv_heads: int
    head_dim: int
    page_size: int = 512
    n_pages: int = 64
    max_seqs: int = 8
    max_pages_per_seq: int = 16
    quantized: bool = True
    quant_dtype: object = torch.int8
    dtype: torch.dtype = torch.bfloat16   # payload dtype when not quantized

    def __post_init__(self):
        if self.quantized and self.quant_dtype != torch.int8:
            raise NotImplementedError(_NOT_PORTED)

    @property
    def head_dim_store(self) -> int:
        # the JAX layout pads the stored feature dim to 128 lanes
        return pad_to(self.head_dim, LANE)

    @property
    def payload_dtype(self) -> torch.dtype:
        return torch.int8 if self.quantized else self.dtype


@dataclasses.dataclass
class PagedKVCache:
    """Device tensors of one layer's cache; the writes mutate them in place."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scales: Optional[torch.Tensor]
    v_scales: Optional[torch.Tensor]
    page_tables: torch.Tensor
    lengths: torch.Tensor

    @staticmethod
    def create(cfg: KVCacheConfig, device=None) -> "PagedKVCache":
        shape = (cfg.n_kv_heads, cfg.n_pages, cfg.page_size, cfg.head_dim_store)
        scales_shape = (cfg.n_kv_heads, cfg.n_pages, 1, cfg.page_size)
        scales = (lambda: torch.ones(scales_shape, dtype=torch.float32, device=device)
                  ) if cfg.quantized else (lambda: None)
        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=cfg.payload_dtype, device=device),
            v_pages=torch.zeros(shape, dtype=cfg.payload_dtype, device=device),
            k_scales=scales(),
            v_scales=scales(),
            page_tables=torch.zeros((cfg.max_seqs, cfg.max_pages_per_seq),
                                    dtype=torch.int32, device=device),
            lengths=torch.zeros((cfg.max_seqs,), dtype=torch.int32, device=device),
        )


def _pad_feature(x: torch.Tensor, d_store: int) -> torch.Tensor:
    d = x.shape[-1]
    return x if d == d_store else F.pad(x, (0, d_store - d))


def _quantize_tokens(x: torch.Tensor, qdtype=torch.int8):
    """Per-token symmetric int8 quantization: x (..., t, d) ->
    (int8 payload, float32 scales (..., t, 1)).  ``torch.round`` rounds half
    to even, as ``jnp.round`` does, so payloads match the JAX package bit
    for bit."""
    if qdtype != torch.int8:
        raise NotImplementedError(_NOT_PORTED)
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: on CUDA, division by a Python scalar is a multiply by
    # its reciprocal, which is not the IEEE quotient the reference takes
    scale = torch.where(amax == 0.0, torch.ones_like(amax),
                        amax / torch.full_like(amax, 127.0))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _store_rows(cache: PagedKVCache, cfg: KVCacheConfig, phys, offset, k, v):
    """Scatter token rows k, v (n_kv, t, d) to (phys[i], offset[i])."""
    phys, offset = phys.long(), offset.long()
    for pages, scales, new in ((cache.k_pages, cache.k_scales, k),
                               (cache.v_pages, cache.v_scales, v)):
        vals = _pad_feature(new, cfg.head_dim_store)
        if cfg.quantized:
            qv, sc = _quantize_tokens(vals)
            pages[:, phys, offset, :] = qv
            scales[:, phys, 0, offset] = sc[..., 0]
        else:
            pages[:, phys, offset, :] = vals.to(pages.dtype)


def write_prompt(cache: PagedKVCache, cfg: KVCacheConfig, slot: int,
                 pages, k: torch.Tensor, v: torch.Tensor) -> PagedKVCache:
    """Bulk-write a prompt's K/V (n_kv, t, head_dim) into pre-allocated
    physical ``pages`` (host ints, ``ceil(t / page_size)`` of them) and
    map them in the slot's page table.  Test and set-up utility."""
    t = k.shape[1]
    n_used = -(-t // cfg.page_size)
    if len(pages) < n_used:
        raise ValueError(f"{len(pages)} pages cannot hold {t} tokens")
    pos = torch.arange(t, device=k.device)
    page_idx = torch.as_tensor([int(p) for p in pages[:n_used]], device=k.device)
    _store_rows(cache, cfg, page_idx[pos // cfg.page_size], pos % cfg.page_size, k, v)
    cache.page_tables[slot, :n_used] = page_idx.to(torch.int32)
    cache.lengths[slot] = t
    return cache


def assign_page(cache: PagedKVCache, slot: int, logical_page: int,
                physical_page: int) -> PagedKVCache:
    """Map ``logical_page`` of ``slot`` to ``physical_page`` (in place)."""
    cache.page_tables[slot, logical_page] = physical_page
    return cache


def _write_tokens_plain(cache, cfg, slot, start, k, v, true_len, trash_page):
    chunk = k.shape[1]
    idx = torch.arange(chunk, device=k.device)
    pos = start + idx
    logical = (pos // cfg.page_size) % cfg.max_pages_per_seq
    phys = cache.page_tables[slot].long()[logical]
    phys = torch.where(idx < true_len, phys, torch.full_like(phys, trash_page))
    _store_rows(cache, cfg, phys, pos % cfg.page_size, k, v)


def _check_device(cache, *tensors):
    for t in tensors:
        if t.device != cache.k_pages.device:
            raise ValueError(f"tensor on {t.device}, cache on {cache.k_pages.device}")


def write_tokens_at(cache: PagedKVCache, cfg: KVCacheConfig, slot: int,
                    start: int, k: torch.Tensor, v: torch.Tensor,
                    true_len: int, trash_page: int) -> PagedKVCache:
    """Write a prompt chunk's K/V at absolute position ``start``, in place.

    ``k, v``: (n_kv_heads, chunk, head_dim).  Rows past ``true_len`` (chunk
    padding) go to the reserved ``trash_page``.  The slot's length becomes
    ``start + true_len``.  On a CUDA cache this launches ``kv_chunk_write``
    (quantization fused in); on the CPU it runs the plain version.
    """
    if k.shape != v.shape or k.shape[0] != cfg.n_kv_heads or k.shape[2] != cfg.head_dim:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)}")
    if k.device.type == "cpu":
        _write_tokens_plain(cache, cfg, slot, start, k, v, true_len, trash_page)
    elif k.device.type == "cuda":
        _check_device(cache, k, v)
        k, v = k.contiguous(), v.contiguous()
        native.kv_chunk_write(cache, cfg, slot, start, k, v, true_len, trash_page)
        native.LAUNCHES["kv_chunk_write"] += 1
    else:
        raise ValueError(f"unsupported device {k.device}")
    cache.lengths[slot] = start + true_len
    return cache


def _append_plain(cache, cfg, k_new, v_new, active, trash_page):
    lengths = cache.lengths.long()
    logical = (lengths // cfg.page_size) % cfg.max_pages_per_seq
    phys = cache.page_tables.long().gather(1, logical[:, None])[:, 0]
    phys = torch.where(active, phys, torch.full_like(phys, trash_page))
    _store_rows(cache, cfg, phys, lengths % cfg.page_size,
                k_new.transpose(0, 1), v_new.transpose(0, 1))


def append_tokens_batched(cache: PagedKVCache, cfg: KVCacheConfig,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          active: torch.Tensor, trash_page: int) -> PagedKVCache:
    """Append one token per slot, in place: ``k_new, v_new`` (max_seqs,
    n_kv_heads, head_dim) land at (page of ``length``, ``length % page``);
    inactive slots write the trash page and do not advance.  On a CUDA
    cache this launches ``kv_append``; on the CPU it runs the plain
    version."""
    if (k_new.shape != v_new.shape or k_new.shape[1] != cfg.n_kv_heads
            or k_new.shape[2] != cfg.head_dim):
        raise ValueError(f"k/v shapes {tuple(k_new.shape)}, {tuple(v_new.shape)}")
    active = active.to(torch.bool)
    if k_new.device.type == "cpu":
        _append_plain(cache, cfg, k_new, v_new, active, trash_page)
    elif k_new.device.type == "cuda":
        _check_device(cache, k_new, v_new, active)
        native.kv_append(cache, cfg, k_new.contiguous(), v_new.contiguous(),
                         active.contiguous(), trash_page)
        native.LAUNCHES["kv_append"] += 1
    else:
        raise ValueError(f"unsupported device {k_new.device}")
    cache.lengths += active.to(torch.int32)
    return cache


def gather_sequence_kv(cache: PagedKVCache, cfg: KVCacheConfig, slot: int,
                       length: Optional[int] = None):
    """Host-side: gather and dequantize one sequence's K/V -> float32 numpy
    (n_kv_heads, length, head_dim), the values the attention kernels see.
    Test and debug utility."""
    table = cache.page_tables[slot].cpu().numpy()
    L = int(cache.lengths[slot]) if length is None else int(length)
    n_used = -(-L // cfg.page_size)
    mp = cfg.max_pages_per_seq
    pages = [int(table[i % mp]) for i in range(n_used)]

    def tokens(p, s):
        x = p[:, pages].float()                       # (n_kv, n_used, page, d)
        if cfg.quantized:
            x = x * s[:, pages, 0][..., None]
        return x.reshape(cfg.n_kv_heads, -1, x.shape[-1])[:, :L, :cfg.head_dim]

    k = tokens(cache.k_pages, cache.k_scales)
    v = tokens(cache.v_pages, cache.v_scales)
    return k.cpu().numpy(), v.cpu().numpy()


class PageAllocator:
    """Host-side free-list page allocator (the runtime's memory manager)."""

    def __init__(self, n_pages: int):
        self._free = list(range(n_pages - 1, -1, -1))
        self._owned = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, slot: int, n: int):
        if n > len(self._free):
            raise MemoryError(f"out of KV pages: want {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(slot, []).extend(pages)
        return pages

    def owned(self, slot: int):
        return list(self._owned.get(slot, []))

    def free(self, slot: int):
        pages = self._owned.pop(slot, [])
        self._free.extend(reversed(pages))
        return pages
