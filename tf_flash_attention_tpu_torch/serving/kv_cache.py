"""Paged, optionally int8/fp8/int4-quantized KV cache (PyTorch port).

Counterpart of ``tf_flash_attention_tpu/serving/kv_cache.py`` with the same
layouts, so cache states compare element for element (``pack`` = tokens
per stored byte row: 2 for int4, else 1):

  k_pages, v_pages:   (n_kv_heads, n_pages, page_size // pack, head_dim_store)
  k_scales, v_scales: (n_kv_heads, n_pages, pack, page_size // pack) float32
  page_tables:        (max_seqs, max_pages_per_seq) int32
  lengths:            (max_seqs,) int32

Payloads are int8, fp8 (e4m3 or e5m2) or int4 with one float32 scale per
token, or unquantized in the model dtype.  int4 packs token pairs along the
token axis: byte row r of a page holds token 2r in its low nibble and
token 2r + 1 in its high nibble; scale sublane 0 holds the even tokens'
scales, sublane 1 the odd ones'.  Unlike the JAX pytree, ``PagedKVCache``
is a mutable holder: the writes below update its page tensors in place
(the JAX engine donates the caches to get the same effect).

Two writes have CUDA kernels (``csrc/serving_kernels.cu``):
``write_tokens_at`` (chunked prefill, kernel ``kv_chunk_write``) and
``append_tokens_batched`` (decode step, kernel ``kv_append``: one token a
slot, or speculation's T in order; for int4 a read-modify-write of a
nibble where a byte row's other token is not in the launch).  Each has a
plain PyTorch version beside it, the JAX package's XLA-scatter
specification, which the wrapper takes only for tensors on the CPU.  The
kernels read K/V where the projection leaves them (strided views, no
copy) and set the lengths themselves.  A chunk write takes its per-call
scalars as the JAX kernel does, one int32 ``meta`` vector on the device
(``chunk_write_meta``: slot, start, total, trash page, page offset), which
the kernel reads and derives its kept rows from, so one CUDA graph of the
engine's chunked prefill serves every chunk; ``slot``, ``start`` and
``true_len`` may be Python ints or 0-d tensors.  Several padding rows or
inactive slots may write the reserved trash page at once; its contents
are garbage by design, and nothing reads it (the kernels skip those
rows).  Under sequence sharding
(``seq_sharded_decode.py``) a chunk write with ``page_stride``/
``page_offset`` keeps only the rows of its shard's pages
(``_owned_rows``), and its length becomes the shard's owned-token count
(``_owned_token_count``); an append with them stores only the tokens whose
global position (``global_lengths`` + i) is on the shard's pages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .. import native
from ..block_sizes import LANE, pad_to

__all__ = ["KVCacheConfig", "PagedKVCache", "PageAllocator", "write_tokens_at",
           "chunk_write_meta", "append_tokens_batched", "append_token", "write_prompt",
           "assign_page", "gather_sequence_kv"]

# per-token symmetric quantization: the largest magnitude maps to this value
_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _is_int4(qdtype) -> bool:
    return isinstance(qdtype, str) and qdtype == "int4"


def _quant_max(qdtype) -> float:
    if _is_int4(qdtype):
        return 7.0
    if isinstance(qdtype, torch.dtype) and qdtype in _QMAX:
        return _QMAX[qdtype]
    raise ValueError(f"unsupported quant dtype {qdtype}")


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    n_kv_heads: int
    head_dim: int
    page_size: int = 512
    n_pages: int = 64
    max_seqs: int = 8
    max_pages_per_seq: int = 16
    quantized: bool = True
    # torch.int8, torch.float8_e4m3fn, torch.float8_e5m2, or the string
    # "int4" (nibble-packed int8 bytes)
    quant_dtype: object = torch.int8
    dtype: torch.dtype = torch.bfloat16   # payload dtype when not quantized

    def __post_init__(self):
        if self.quantized:
            _quant_max(self.quant_dtype)
            if self.is_int4 and self.page_size % 2:
                raise ValueError(f"int4 KV needs an even page size, got {self.page_size}")

    @property
    def head_dim_store(self) -> int:
        # the JAX layout pads the stored feature dim to 128 lanes
        return pad_to(self.head_dim, LANE)

    @property
    def is_int4(self) -> bool:
        return self.quantized and _is_int4(self.quant_dtype)

    @property
    def tok_pack(self) -> int:
        """Tokens per stored byte row (2 for int4, else 1)."""
        return 2 if self.is_int4 else 1

    @property
    def page_rows(self) -> int:
        """Payload rows per page (= page_size / tok_pack)."""
        return self.page_size // self.tok_pack

    @property
    def payload_dtype(self) -> torch.dtype:
        if not self.quantized:
            return self.dtype
        return torch.int8 if self.is_int4 else self.quant_dtype


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
        """An empty cache on ``device`` (the CUDA card unless ``"cpu"`` is
        given)."""
        device = torch.device("cuda") if device is None else torch.device(device)
        shape = (cfg.n_kv_heads, cfg.n_pages, cfg.page_rows, cfg.head_dim_store)
        scales_shape = (cfg.n_kv_heads, cfg.n_pages, cfg.tok_pack, cfg.page_rows)
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
    """Per-token symmetric quantization to ``qdtype``: x (..., t, d) ->
    (payload, float32 scales (..., t, 1)).  int4 values come back unpacked,
    one int8 in [-7, 7] per token (pack pairs with ``_pack_nibbles``).
    ``torch.round`` rounds half to even, as ``jnp.round`` does, and the
    fp8 casts round to nearest even, as XLA's do, so payloads match the
    JAX package bit for bit."""
    qmax = _quant_max(qdtype)
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: on CUDA, division by a Python scalar is a multiply by
    # its reciprocal, which is not the IEEE quotient the reference takes
    scale = torch.where(amax == 0.0, torch.ones_like(amax),
                        amax / torch.full_like(amax, qmax))
    scaled = x32 / scale
    if _is_int4(qdtype) or qdtype == torch.int8:
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    else:
        q = scaled.to(qdtype)
    return q, scale


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7] (..., t, d) -> int8 bytes (..., t//2, d):
    token 2r in the low nibble of byte row r, token 2r+1 in the high one."""
    lo = q[..., 0::2, :].to(torch.int32) & 0xF
    hi = q[..., 1::2, :].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.int8)


def _pack_scales(sc: torch.Tensor) -> torch.Tensor:
    """Per-token scales (..., t) -> (..., 2, t//2): sublane 0 the even
    tokens', sublane 1 the odd tokens'."""
    return torch.stack([sc[..., 0::2], sc[..., 1::2]], dim=-2)


def _unpack_nibbles(x: torch.Tensor):
    """Sign-extend packed int4 bytes with shifts: (..., rows, d) int8 ->
    (even, odd) int32 pair, each (..., rows, d)."""
    xi = x.to(torch.int32)
    return (xi << 28) >> 28, (xi << 24) >> 28


def _store_rows(cache: PagedKVCache, cfg: KVCacheConfig, phys, offset, k, v):
    """Scatter whole token rows k, v (n_kv, t, d) to (phys[i], offset[i])
    (int8, fp8 or unquantized payloads)."""
    phys, offset = phys.long(), offset.long()
    for pages, scales, new in ((cache.k_pages, cache.k_scales, k),
                               (cache.v_pages, cache.v_scales, v)):
        vals = _pad_feature(new, cfg.head_dim_store)
        if cfg.quantized:
            qv, sc = _quantize_tokens(vals, cfg.quant_dtype)
            pages[:, phys, offset, :] = qv
            scales[:, phys, 0, offset] = sc[..., 0]
        else:
            pages[:, phys, offset, :] = vals.to(pages.dtype)


def _store_byte_rows(cache: PagedKVCache, cfg: KVCacheConfig, phys, offset, k, v):
    """int4: quantize token pairs (2r, 2r+1) of k, v (n_kv, t, d), t even,
    and store each pair's byte row at (phys[2r], offset[2r] // 2)."""
    phys_b, off_b = phys[0::2].long(), offset[0::2].long() // 2
    for pages, scales, new in ((cache.k_pages, cache.k_scales, k),
                               (cache.v_pages, cache.v_scales, v)):
        qv, sc = _quantize_tokens(_pad_feature(new, cfg.head_dim_store), cfg.quant_dtype)
        scp = _pack_scales(sc[..., 0])                    # (n_kv, 2, t/2)
        pages[:, phys_b, off_b, :] = _pack_nibbles(qv)
        scales[:, phys_b, 0, off_b] = scp[:, 0]
        scales[:, phys_b, 1, off_b] = scp[:, 1]


def write_prompt(cache: PagedKVCache, cfg: KVCacheConfig, slot: int,
                 pages, k: torch.Tensor, v: torch.Tensor) -> PagedKVCache:
    """Bulk-write a prompt's K/V (n_kv, t, head_dim) into pre-allocated
    physical ``pages`` (host ints, ``ceil(t / page_size)`` of them) and
    map them in the slot's page table.  The prompt is zero-padded to whole
    pages, as in the JAX package.  Test and set-up utility."""
    t = k.shape[1]
    n_used = -(-t // cfg.page_size)
    if len(pages) < n_used:
        raise ValueError(f"{len(pages)} pages cannot hold {t} tokens")
    pad = n_used * cfg.page_size - t
    k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
    pos = torch.arange(n_used * cfg.page_size, device=k.device)
    page_idx = torch.as_tensor([int(p) for p in pages[:n_used]], device=k.device)
    store = _store_byte_rows if cfg.is_int4 else _store_rows
    store(cache, cfg, page_idx[pos // cfg.page_size], pos % cfg.page_size, k, v)
    cache.page_tables[slot, :n_used] = page_idx.to(torch.int32)
    cache.lengths[slot] = t
    return cache


def assign_page(cache: PagedKVCache, slot: int, logical_page: int,
                physical_page: int) -> PagedKVCache:
    """Map ``logical_page`` of ``slot`` to ``physical_page`` (in place)."""
    cache.page_tables[slot, logical_page] = physical_page
    return cache


def _owned_token_count(total: int, page_size: int, stride: int, offset: int) -> int:
    """Tokens in [0, total) on the shard owning every ``stride``-th page
    starting at ``offset`` (sequence sharding; stride 1 owns everything)."""
    if stride == 1:
        return total
    n_g = total // page_size
    full = (n_g - offset + stride - 1) // stride if n_g > offset else 0
    tail = total % page_size if n_g % stride == offset else 0
    return full * page_size + tail


def _owned_rows(cfg: KVCacheConfig, start: int, true_len: int, page_stride: int = 1,
                page_offset: int = 0) -> tuple:
    """The stored rows a chunk write at ``start`` keeps on the shard of
    ``page_stride``/``page_offset``: the chunk's tokens ``[start, start +
    true_len)`` rounded up to whole stored rows (int4: byte rows of two
    tokens) on its pages, as ``(local0, rows, length)``.  They are the
    shard's local positions ``local0 .. local0 + pack * rows - 1``; local
    position l is global position ``((l // page) * stride + offset) * page
    + l % page``, and ``length`` is the slot's owned-token count after the
    write.  The kernel derives the same from its ``meta`` on the device
    (``chunk_span`` in ``csrc/serving_kernels.cu``); this is its host
    specification."""
    ps, pack = cfg.page_size, cfg.tok_pack
    local0 = _owned_token_count(start, ps, page_stride, page_offset)
    end = _owned_token_count(start + -(-true_len // pack) * pack, ps, page_stride, page_offset)
    return (local0, (end - local0) // pack,
            _owned_token_count(start + true_len, ps, page_stride, page_offset))


def device_scalar(x, device) -> torch.Tensor:
    """A Python int or a 0-d tensor as a 0-d int32 tensor on ``device``,
    made there by a fill or a cast: no tensor from host data, so a CUDA
    graph may capture it."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(x), dtype=torch.int32, device=device)


def meta_device(scalars, device) -> torch.device:
    """Where a meta vector is built: on ``device`` when a scalar is a
    tensor (no host sync), else on the CPU, whose few ops cost less than
    launches, and uploaded once."""
    return device if any(isinstance(x, torch.Tensor) for x in scalars) else torch.device("cpu")


def chunk_write_meta(slot, start, true_len, trash_page: int, page_stride: int = 1,
                     device=None) -> torch.Tensor:
    """The chunk write's scalars, a row a shard: int32 (page_stride, 5) rows
    ``[slot, start, start + true_len, trash_page, r]`` for the shard of page
    offset r, the JAX wrapper's ``meta`` (kv_cache.py:386-389), on
    ``device`` (the CPU by default), made by device arithmetic from 0-d
    tensors, or on the host from ints (``meta_device``)."""
    device = torch.device("cpu" if device is None else device)
    on = meta_device((slot, start, true_len), device)
    slot, start, true_len = (device_scalar(x, on) for x in (slot, start, true_len))
    head = torch.stack([slot, start, start + true_len, torch.full_like(slot, trash_page)])
    offsets = torch.arange(page_stride, dtype=torch.int32, device=on)
    meta = torch.cat([head.expand(page_stride, 4), offsets[:, None]], dim=1)
    return meta.to(device, non_blocking=True)


def _write_tokens_plain(cache, cfg, meta, k, v, page_stride=1):
    """The chunk write of ``meta`` (one row of ``chunk_write_meta``) in
    plain PyTorch, the slot's length included (the CPU's path); reads
    ``meta`` back to the host."""
    slot, start, total, trash_page, page_offset = meta.tolist()
    true_len = total - start
    chunk = k.shape[1]
    idx = torch.arange(chunk, device=k.device)
    pos = start + idx
    g = pos // cfg.page_size
    logical = ((g - page_offset) // page_stride) % cfg.max_pages_per_seq
    phys = cache.page_tables[slot].long()[logical]
    # rows of another shard's pages and padding rows go to the trash page;
    # int4: a byte row follows its even token (pages hold whole byte rows),
    # so it goes to the trash page only if both of its tokens are padding
    own = (idx < true_len) & (g % page_stride == page_offset)
    phys = torch.where(own, phys, torch.full_like(phys, trash_page))
    store = _store_byte_rows if cfg.is_int4 else _store_rows
    store(cache, cfg, phys, pos % cfg.page_size, k, v)
    cache.lengths[slot] = _owned_token_count(total, cfg.page_size, page_stride, page_offset)


def _check_device(cache, *tensors):
    for t in tensors:
        if t.device != cache.k_pages.device:
            raise ValueError(f"tensor on {t.device}, cache on {cache.k_pages.device}")


def write_tokens_at(cache: PagedKVCache, cfg: KVCacheConfig, slot, start, k: torch.Tensor,
                    v: torch.Tensor, true_len, trash_page: int, page_stride: int = 1,
                    page_offset: int = 0) -> PagedKVCache:
    """Write a prompt chunk's K/V at absolute position ``start``, in place.
    ``slot``, ``start`` and ``true_len`` are Python ints or 0-d tensors, as
    the JAX entry takes Python or traced scalars (``chunk_write_meta``).

    ``k, v``: (n_kv_heads, chunk, head_dim), for example the transposed
    (chunk, n_kv_heads, head_dim) projection (the kernel reads any head and
    row strides; other views are copied).  Rows past ``true_len`` (chunk
    padding) go to the reserved ``trash_page`` (the kernel skips them: its
    contents are garbage either way).  The slot's length becomes
    ``start + true_len``.  An int4 cache needs an even ``start`` and an
    even chunk (whole byte rows).  On a CUDA cache this launches
    ``kv_chunk_write`` (quantization and the length fused in; a 0-d
    tensor ``start`` is not checked for int4's evenness, as a traced one
    is not); on the CPU it runs the plain version.

    Sequence sharding: with ``page_stride``/``page_offset`` this cache holds
    every ``page_stride``-th global page starting at ``page_offset`` (global
    page g at local logical page ``(g - offset) // stride``); rows of other
    shards' pages are padding too and the slot's (local) length
    becomes its owned-token count.
    """
    if k.shape != v.shape or k.shape[0] != cfg.n_kv_heads or k.shape[2] != cfg.head_dim:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)}")
    if cfg.is_int4 and ((isinstance(start, int) and start % 2) or k.shape[1] % 2):
        raise ValueError(f"int4 chunked writes need an even start and chunk, got "
                         f"start {start}, chunk {k.shape[1]}")
    if not 0 <= page_offset < page_stride:
        raise ValueError(f"page offset {page_offset} outside stride {page_stride}")
    meta = chunk_write_meta(slot, start, true_len, trash_page, page_stride, k.device)
    write_tokens_meta(cache, cfg, meta[page_offset], k, v, page_stride)
    return cache


def write_tokens_meta(cache: PagedKVCache, cfg: KVCacheConfig, meta: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, page_stride: int = 1) -> None:
    """``write_tokens_at`` with its scalars in ``meta``, a row of
    ``chunk_write_meta`` on k's device (the engine builds the rows once a
    chunk): ``kv_chunk_write`` on a CUDA cache, the plain version on the
    CPU."""
    if k.device.type == "cpu":
        _write_tokens_plain(cache, cfg, meta, k, v, page_stride)
    elif k.device.type == "cuda":
        _check_device(cache, k, v, meta)
        if k.stride() != v.stride() or k.stride(-1) != 1:
            k, v = k.contiguous(), v.contiguous()
        native.kv_chunk_write(cache, cfg, meta, k, v, page_stride)
    else:
        raise ValueError(f"unsupported device {k.device}")


def _append_plain(cache, cfg, k_new, v_new, active, trash_page):
    lengths = cache.lengths.long()
    logical = (lengths // cfg.page_size) % cfg.max_pages_per_seq
    phys = cache.page_tables.long().gather(1, logical[:, None])[:, 0]
    phys = torch.where(active, phys, torch.full_like(phys, trash_page))
    _store_token(cache, cfg, phys, lengths % cfg.page_size, k_new, v_new)


def _store_token(cache, cfg, phys, offset, k_new, v_new):
    """Store one token a row of ``k_new, v_new`` (S, n_kv, d) at
    (``phys[i]``, ``offset[i]``)."""
    if not cfg.is_int4:
        _store_rows(cache, cfg, phys, offset, k_new.transpose(0, 1), v_new.transpose(0, 1))
        return
    brow, nib = offset // 2, offset % 2
    for pages, scales, new in ((cache.k_pages, cache.k_scales, k_new),
                               (cache.v_pages, cache.v_scales, v_new)):
        vals = _pad_feature(new, cfg.head_dim_store).transpose(0, 1)   # (n_kv, S, d)
        qv, sc = _quantize_tokens(vals, cfg.quant_dtype)
        old = pages[:, phys, brow, :].to(torch.int32)
        q32 = qv.to(torch.int32) & 0xF
        # an even token owns the byte (its odd partner does not exist yet);
        # an odd token keeps the even one in the low nibble
        byte = torch.where(nib[None, :, None] == 0, q32, (old & 0xF) | (q32 << 4))
        pages[:, phys, brow, :] = byte.to(torch.int8)
        scales[:, phys, nib, brow] = sc[..., 0]


def append_token(cache: PagedKVCache, cfg: KVCacheConfig, slot: int,
                 k_new: torch.Tensor, v_new: torch.Tensor) -> PagedKVCache:
    """Append one token's K/V (n_kv_heads, head_dim) for sequence ``slot``,
    in place, in plain PyTorch (no kernel: the engine appends through
    ``append_tokens_batched``).  The page and the offset in it follow from
    the slot's length; the page table must already map that page.  For
    int4 an even position owns its whole byte and an odd one keeps the
    even token in the low nibble."""
    length = cache.lengths[slot:slot + 1].long()
    logical = (length // cfg.page_size) % cfg.max_pages_per_seq
    phys = cache.page_tables[slot].long()[logical]
    _store_token(cache, cfg, phys, length % cfg.page_size, k_new[None], v_new[None])
    cache.lengths[slot] += 1
    return cache


def _owner_mask(active, glob, i, cfg, page_stride, page_offset):
    """The slots whose token i this shard stores: active, and (sharded) at
    global position ``glob + i`` on one of its pages (the JAX engine's
    ``mine = active & (owner == me)``)."""
    if page_stride == 1:
        return active
    return active & ((glob.long() + i) // cfg.page_size % page_stride == page_offset)


def _append_tokens_plain(cache, cfg, k_new, v_new, active, trash_page, glob=None,
                         page_stride=1, page_offset=0):
    """T tokens a slot, (S, T, n_kv, d), as T ordered appends of one token
    with their owner masks, each advancing the lengths of the slots it
    stores (the kernel's specification)."""
    for i in range(k_new.shape[1]):
        mine = _owner_mask(active, glob, i, cfg, page_stride, page_offset)
        _append_plain(cache, cfg, k_new[:, i], v_new[:, i], mine, trash_page)
        cache.lengths += mine.to(torch.int32)


def append_tokens_batched(cache: PagedKVCache, cfg: KVCacheConfig,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          active: torch.Tensor, trash_page: int,
                          global_lengths: Optional[torch.Tensor] = None,
                          page_stride: int = 1, page_offset: int = 0) -> PagedKVCache:
    """Append tokens, in place: ``k_new, v_new`` (max_seqs, n_kv_heads,
    head_dim), one token a slot, land at (page of ``length``, ``length %
    page``); inactive slots write the trash page and do not advance.
    (max_seqs, T, n_kv_heads, head_dim) appends T tokens a slot in order,
    as T calls of one token would (speculation's gamma; for int4 the two
    tokens of a byte row pair up).  Sequence sharding: with
    ``page_stride``/``page_offset`` this cache stores only the tokens whose
    global position ``global_lengths[s] + i`` (int32, max_seqs) is on its
    pages, each at its local length, which advances by the tokens stored.
    On a CUDA cache this launches ``kv_append`` (the owner test and the
    lengths in the kernel); on the CPU it runs the plain version."""
    t_axis = k_new.dim() == 4
    if (k_new.shape != v_new.shape or k_new.dim() not in (3, 4)
            or k_new.shape[1 + t_axis] != cfg.n_kv_heads or k_new.shape[-1] != cfg.head_dim):
        raise ValueError(f"k/v shapes {tuple(k_new.shape)}, {tuple(v_new.shape)}")
    if not 0 <= page_offset < page_stride or (page_stride > 1 and global_lengths is None):
        raise ValueError(f"a sharded append (offset {page_offset}, stride {page_stride}) "
                         f"needs global lengths")
    active = active.to(torch.bool)
    if k_new.device.type == "cpu":
        if not t_axis:
            k_new, v_new = k_new[:, None], v_new[:, None]
        _append_tokens_plain(cache, cfg, k_new, v_new, active, trash_page, global_lengths,
                             page_stride, page_offset)
    elif k_new.device.type == "cuda":
        _check_device(cache, k_new, v_new, active,
                      *(() if global_lengths is None else (global_lengths,)))
        if k_new.stride() != v_new.stride() or k_new.stride(-1) != 1:
            k_new, v_new = k_new.contiguous(), v_new.contiguous()
        native.kv_append(cache, cfg, k_new, v_new, active,
                         None if page_stride == 1 else global_lengths, page_stride, page_offset)
    else:
        raise ValueError(f"unsupported device {k_new.device}")
    return cache


def _page_tokens(pages: torch.Tensor, scales: Optional[torch.Tensor],
                 cfg: KVCacheConfig):
    """Pages (..., page_rows, D) and their scales (..., pack, page_rows) ->
    float32 token values (..., page_size, D), not yet scaled, and token
    scales (..., page_size) or None.  Exact: every payload is representable
    in float32 (and in bf16, the quantized caches' compute type)."""
    if cfg.is_int4:
        even, odd = _unpack_nibbles(pages)
        x = torch.stack([even, odd], dim=-2).flatten(-3, -2).float()
        sc = scales.transpose(-1, -2).flatten(-2)       # t = 2r + nibble
        return x, sc
    return pages.float(), (scales[..., 0, :] if cfg.quantized else None)


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
        x, sc = _page_tokens(p[:, pages], None if s is None else s[:, pages], cfg)
        if sc is not None:
            x = x * sc[..., None]
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
