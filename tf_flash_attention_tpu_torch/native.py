"""Build, load and call the port's CUDA kernels.

Each source in ``csrc/`` is compiled with nvcc into a shared library with a
plain C interface on first use, all of them at once (one nvcc process per
source), and loaded with ``ctypes``.  The libraries live in
``build/torch_kernels/`` at the root of the checkout, and each file name
carries a hash of its source and the flags, so an edit rebuilds.  A failed
build or load raises; there is no fallback.

Each C entry launches one kernel on the given stream (PyTorch's current
stream), allocates nothing and returns ``cudaGetLastError()``; the Python
functions below allocate the outputs, and raise if that code is not 0.
``LAUNCHES`` counts, per kernel, the launches the wrappers made: ``_call``
adds one where the C entry has launched, and nowhere else.

``native_tile_classes`` is the JAX package's hook for its C++ schedule
classifier (``csrc/fa_native.cc``), which is not ported: it returns
``None``, which sends ``schedule.py`` to its NumPy classifier (the spec).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .block_sizes import LANE, MAX_HEAD_DIM
from .mask_rules import CausalRule, FullRule, LocalRule
from .sync_modes import ref_log2

__all__ = ["LAUNCHES", "SERVING_KERNELS", "ATTENTION_KERNELS", "KERNEL_SOURCES",
           "reset_launch_counts", "build", "library", "native_tile_classes"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# no --use_fast_math: the int8 quantization must divide and round exactly
# as the reference does, and exp2f must stay accurate
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

SERVING_KERNELS = ("paged_decode", "paged_prefill", "kv_chunk_write", "kv_append")
ATTENTION_KERNELS = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv",
                     "flash_bwd_qouter", "banded_fwd", "banded_bwd", "window_fwd",
                     "window_bwd", "resident_fwd")
LAUNCHES = {name: 0 for name in SERVING_KERNELS + ATTENTION_KERNELS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float16: 3}

_libs = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def native_tile_classes(pack, rule, block_q: int, block_kv: int):
    """The C++ schedule classifier is not ported: ``None`` (NumPy spec)."""
    return None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _lib_path(source: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [_CSRC / source] + sorted(_CSRC.glob("*.cuh")):
        digest.update(path.read_bytes())
    return _BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source whose library is missing, all nvcc processes
    started together; returns ``{source: library path}``."""
    paths = {src: _lib_path(src) for src in _SIGNATURES}
    todo = [src for src, path in paths.items() if not path.exists()]
    if not todo:
        return paths
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(_CSRC / src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((src, tmp, proc))
    errors = []
    for src, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"{src}: nvcc failed ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, paths[src])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class FaRule(ctypes.Structure):
    """The sync pack and mask rule as the kernels read them
    (``struct FaRule`` in ``csrc/attention_common.cuh``)."""

    _fields_ = [("ndim", _I),
                ("q_shape", _I * 2), ("q_stride", _I * 2), ("q_offset", _I * 2),
                ("k_shape", _I * 2), ("k_stride", _I * 2), ("k_offset", _I * 2),
                ("shift0", _I), ("kind", _I), ("window", _I), ("log2_stride", _I),
                ("is_causal", _I), ("q_len", _I), ("k_len", _I)]


_R = ctypes.POINTER(FaRule)

# per source: C entry -> argument types (the stream, last, is added below)
_SIGNATURES = {
    "serving_kernels.cu": {
        # act, kv, k, v, k_pages, v_pages, k_scales, v_scales, table_row,
        # n_kv, chunk, d, d_store, page_size, n_pages, max_pages, start,
        # true_len, trash
        "fa_kv_chunk_write": [_I, _I] + [_P] * 7 + [_I] * 10,
        # act, kv, k_new, v_new, k_pages, v_pages, k_scales, v_scales, tables,
        # lengths, active, S, n_kv, d, d_store, page_size, n_pages, max_pages,
        # trash
        "fa_kv_append": [_I, _I] + [_P] * 9 + [_I] * 8,
        # act, kv, q, k_pages, v_pages, k_scales, v_scales, tables, lengths, o,
        # S, n_q, n_kv, d, d_store, page_size, n_pages, max_pages,
        # scale_log2e, window, log2_stride, is_local
        "fa_paged_decode": [_I, _I] + [_P] * 8 + [_I] * 8 + [_F] + [_I] * 3,
        # act, kv, q, k_pages, v_pages, k_scales, v_scales, table_row, o,
        # chunk, n_q, n_kv, d, d_store, page_size, n_pages, max_pages, start,
        # total, first_live, count, window, log2_stride, is_local
        "fa_paged_prefill": [_I, _I] + [_P] * 7 + [_I] * 15,
    },
    "attention_kernels.cu": {
        # dtype, q, k, v, o, l, m, table, counts, needs, num_steps, block_q,
        # block_kv, B, g, d, v_d, rule
        "fa_flash_fwd": [_I] + [_P] * 9 + [_I] * 7 + [_R],
        # dtype, q, k, v, dout, lse2, delta, dq_acc, dk, dv, table, counts,
        # needs, num_steps, block_q, block_kv, B, g, d, v_d, dk_scale, rule
        "fa_flash_bwd_fused": [_I] + [_P] * 12 + [_I] * 7 + [_F, _R],
        # dtype, q, k, v, dout, lse2, delta, dq, table, counts, needs,
        # num_steps, block_q, block_kv, B, g, d, v_d, scale, rule
        "fa_flash_bwd_dq": [_I] + [_P] * 10 + [_I] * 7 + [_F, _R],
        # dtype, q, k, v, dout, lse2, delta, dk, dv, table, counts, needs,
        # num_steps, block_q, block_kv, B, g, d, v_d, scale, rule
        "fa_flash_bwd_dkv": [_I] + [_P] * 11 + [_I] * 7 + [_F, _R],
        # dtype, q, k, v, dout, lse2, delta, dq, dk_acc, dv_acc, table,
        # counts, needs, num_steps, block_q, block_kv, B, g, d, v_d, scale, rule
        "fa_flash_bwd_qouter": [_I] + [_P] * 12 + [_I] * 7 + [_F, _R],
    },
    "band_kernels.cu": {
        # dtype, q, k, v, o, l, m, seg, block_q, block_kv, B, g, d, v_d, rule
        "fa_banded_fwd": [_I] + [_P] * 7 + [_I] * 6 + [_R],
        "fa_resident_fwd": [_I] + [_P] * 7 + [_I] * 6 + [_R],
        # dtype, q, k, v, o, l, m, starts, band, sub_q, masked, B, g, d, v_d,
        # rule
        "fa_window_fwd": [_I] + [_P] * 7 + [_I] * 7 + [_R],
        # dtype, q, k, v, dout, lse2, delta, dq_acc, dk, dv, seg, block_q,
        # block_kv, B, g, d, v_d, dk_scale, rule
        "fa_banded_bwd": [_I] + [_P] * 10 + [_I] * 6 + [_F, _R],
        # dtype, q, k, v, dout, lse2, delta, dq_acc, dk, dv, starts, band,
        # sub_kv, B, g, d, v_d, dk_scale, rule
        "fa_window_bwd": [_I] + [_P] * 10 + [_I] * 6 + [_F, _R],
    },
}

#: the source file of each kernel, by its ``LAUNCHES`` name
KERNEL_SOURCES = {entry[3:]: src for src, entries in _SIGNATURES.items() for entry in entries}


def library(source: str = "serving_kernels.cu") -> ctypes.CDLL:
    """The loaded library of one source (every source is built on first call)."""
    if source not in _libs:
        paths = build()
        for src, path in paths.items():
            if src in _libs:
                continue
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES[src].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes + [_P]
                fn.restype = ctypes.c_int
            _libs[src] = lib
    return _libs[source]


def _call(name: str, *args) -> None:
    """Launch the C entry ``name`` (``fa_<kernel>``) on the current stream and
    count the launch."""
    kernel = name[3:]
    lib = library(KERNEL_SOURCES[kernel])
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")
    LAUNCHES[kernel] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _codes(act: torch.dtype, cache) -> tuple:
    if act not in (torch.float32, torch.bfloat16):
        raise TypeError(f"activations must be float32 or bfloat16, got {act}")
    kv = cache.k_pages.dtype
    if kv != torch.int8 and kv != act:
        raise TypeError(f"an unquantized cache holds the activations' dtype: "
                        f"{kv} cache, {act} activations")
    return _DTYPE_CODE[act], _DTYPE_CODE[kv]


def _cache_dims(cache, cfg) -> list:
    for t in (cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales,
              cache.page_tables, cache.lengths):
        if t is not None and not t.is_contiguous():
            raise ValueError("cache tensors must be contiguous")
    if cache.page_tables.dtype != torch.int32 or cache.lengths.dtype != torch.int32:
        raise TypeError("page tables and lengths must be int32")
    return [cfg.page_size, cfg.n_pages, cfg.max_pages_per_seq]


def _rule_args(rule) -> list:
    if isinstance(rule, LocalRule):
        return [rule.window_size, rule.log2_stride_size, 1]
    return [0, 0, 0]


def kv_chunk_write(cache, cfg, slot, start, k, v, true_len, trash_page) -> None:
    """Launch ``kv_chunk_write``: quantize and store k, v (n_kv, chunk, d)."""
    n_kv, chunk, d = k.shape
    act, kv = _codes(k.dtype, cache)
    dims = _cache_dims(cache, cfg)
    table_row = cache.page_tables[slot]
    _call("fa_kv_chunk_write", act, kv, k.data_ptr(), v.data_ptr(),
          cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
          _ptr(cache.k_scales), _ptr(cache.v_scales), table_row.data_ptr(),
          n_kv, chunk, d, cfg.head_dim_store, *dims, start, true_len, trash_page)


def kv_append(cache, cfg, k_new, v_new, active, trash_page) -> None:
    """Launch ``kv_append``: one token row per (slot, kv head)."""
    S, n_kv, d = k_new.shape
    act, kv = _codes(k_new.dtype, cache)
    dims = _cache_dims(cache, cfg)
    if active.dtype != torch.bool or active.shape != (S,):
        raise ValueError("active must be a bool vector of max_seqs entries")
    _call("fa_kv_append", act, kv, k_new.data_ptr(), v_new.data_ptr(),
          cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
          _ptr(cache.k_scales), _ptr(cache.v_scales),
          cache.page_tables.data_ptr(), cache.lengths.data_ptr(), active.data_ptr(),
          S, n_kv, d, cfg.head_dim_store, *dims, trash_page)


def paged_decode(q, cache, cfg, scale_log2e, rule) -> torch.Tensor:
    """Launch ``paged_decode``: q (S, n_q, d) -> o of the same shape."""
    S, n_q, d = q.shape
    act, kv = _codes(q.dtype, cache)
    dims = _cache_dims(cache, cfg)
    if cfg.head_dim_store not in (128, 256) or n_q // cfg.n_kv_heads > 16:
        raise ValueError(f"paged_decode takes head_dim_store 128 or 256 and at most 16 "
                         f"q heads per kv head, got {cfg.head_dim_store}, {n_q}/{cfg.n_kv_heads}")
    o = torch.empty_like(q)
    _call("fa_paged_decode", act, kv, q.data_ptr(), cache.k_pages.data_ptr(),
          cache.v_pages.data_ptr(), _ptr(cache.k_scales), _ptr(cache.v_scales),
          cache.page_tables.data_ptr(), cache.lengths.data_ptr(), o.data_ptr(),
          S, n_q, cfg.n_kv_heads, d, cfg.head_dim_store, *dims,
          float(scale_log2e), *_rule_args(rule))
    return o


def paged_prefill(qs, cache, cfg, slot, start, total, first_live, count,
                  rule) -> torch.Tensor:
    """Launch ``paged_prefill``: prescaled q (chunk, n_q, d) -> o."""
    chunk, n_q, d = qs.shape
    act, kv = _codes(qs.dtype, cache)
    dims = _cache_dims(cache, cfg)
    if cfg.page_size % 32:
        raise ValueError(f"paged_prefill needs page_size % 32 == 0, got {cfg.page_size}")
    if cfg.head_dim_store not in (128, 256):
        raise ValueError(f"paged_prefill takes head_dim_store 128 or 256, "
                         f"got {cfg.head_dim_store}")
    o = torch.empty_like(qs)
    table_row = cache.page_tables[slot]
    _call("fa_paged_prefill", act, kv, qs.data_ptr(), cache.k_pages.data_ptr(),
          cache.v_pages.data_ptr(), _ptr(cache.k_scales), _ptr(cache.v_scales),
          table_row.data_ptr(), o.data_ptr(), chunk, n_q, cfg.n_kv_heads, d,
          cfg.head_dim_store, *dims, start, total, first_live, count,
          *_rule_args(rule))
    return o


# ---- the op path's attention kernels ----

_RULE_KIND = {FullRule: 0, CausalRule: 1, LocalRule: 2}


def fa_rule(pack, rule) -> FaRule:
    """The kernels' view of a sync pack and mask rule; a rule outside the
    three built-in families has no device predicate and raises."""
    kind = _RULE_KIND.get(type(rule))
    if kind is None:
        raise NotImplementedError(f"the CUDA kernels evaluate FullRule, CausalRule and "
                                  f"LocalRule only, got {type(rule).__name__}")
    if pack.ndim not in (1, 2):
        raise ValueError(f"1 or 2 sequence dims, got {pack.ndim}")
    r = FaRule()
    r.ndim = pack.ndim
    for name, desc in (("q", pack.q), ("k", pack.k)):
        for field in ("shape", "stride", "offset"):
            vals = list(getattr(desc, field)) + [0] * (2 - pack.ndim)
            getattr(r, f"{name}_{field}")[:] = vals
    r.shift0 = ref_log2(pack.reference_shape)[1] if pack.ndim == 2 else 0
    r.kind = kind
    if kind == 2:
        r.window, r.log2_stride, r.is_causal = (rule.window_size, rule.log2_stride_size,
                                                int(rule.is_causal))
    r.q_len = int(np.prod(pack.q.shape))
    r.k_len = int(np.prod(pack.k.shape))
    return r


_TABLES = {}


def device_tables(key, arrays, device) -> tuple:
    """The int32 ``arrays`` (a schedule's tables, band segments or starts) as
    tensors on ``device``, uploaded once per ``key`` (pack, rule, blocks,
    route)."""
    key = (key, str(device))
    tabs = _TABLES.get(key)
    if tabs is None:
        tabs = tuple(torch.from_numpy(np.ascontiguousarray(t, np.int32)).to(device)
                     for t in arrays)
        _TABLES[key] = tabs
    return tabs


#: opt-in shared memory of one block on the H100 (227 KB)
MAX_SMEM = 232448


def window_fwd_smem(band: int, d: int, v_d: int) -> int:
    """Shared memory of ``window_fwd`` (``band_kernels.cu``): the query tile
    (32 rows), one K or V tile (64 rows, 32 past d 128) and the whole
    band's float32 scores."""
    bn = 32 if max(d, v_d) > 128 else 64
    return 4 * (32 * (d | 1) + bn * max(d | 1, v_d | 1) + 32 * (band + 1) + 64)


def _check_attn(q, k, v, rule_c: FaRule, do=None, stats=()) -> int:
    """Validate what the attention kernels index; returns the dtype code."""
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"the attention kernels take float32, bfloat16 or float16, "
                        f"got {q.dtype}")
    for t in (q, k, v) + (() if do is None else (do,)):
        if t.dtype != q.dtype or not t.is_cuda or not t.is_contiguous() or t.dim() != 3:
            raise ValueError("the attention kernels take contiguous 3-d CUDA tensors "
                             "of one dtype")
    B, q_len, d = q.shape
    B_kv, k_len, v_d = v.shape
    if (tuple(k.shape) != (B_kv, k_len, d) or B % B_kv
            or (q_len, k_len) != (rule_c.q_len, rule_c.k_len)
            or max(d, v_d) > MAX_HEAD_DIM
            or (do is not None and tuple(do.shape) != (B, q_len, v_d))):
        raise ValueError(f"inconsistent attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, rule lengths "
                         f"({rule_c.q_len}, {rule_c.k_len}), head dims <= {MAX_HEAD_DIM}")
    for t in stats:
        if (t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous()
                or tuple(t.shape) != (B, q_len)):
            raise ValueError("lse2 and delta must be contiguous float32 (B, q_len) "
                             "CUDA tensors")
    return _DTYPE_CODE[q.dtype]


def _sched_args(tables, block_q, block_kv) -> list:
    table, counts, needs = tables
    return [table.data_ptr(), counts.data_ptr(), needs.data_ptr(), table.shape[1],
            block_q, block_kv]


def flash_fwd(q_scaled, k, v, rule_c: FaRule, tables, block_q, block_kv):
    """Launch ``flash_fwd``: prescaled q (B, q_len, d), k (B_kv, k_len, d),
    v (B_kv, k_len, v_d) -> o (B, q_len, v_d), l, natural-log m (B, q_len)."""
    code = _check_attn(q_scaled, k, v, rule_c)
    B, q_len, d = q_scaled.shape
    v_d = v.shape[2]
    o = torch.empty((B, q_len, v_d), dtype=q_scaled.dtype, device=q_scaled.device)
    l = torch.empty((B, q_len), dtype=torch.float32, device=q_scaled.device)
    m = torch.empty_like(l)
    _call("fa_flash_fwd", code, q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(),
          o.data_ptr(), l.data_ptr(), m.data_ptr(), *_sched_args(tables, block_q, block_kv),
          B, B // k.shape[0], d, v_d, ctypes.byref(rule_c))
    return o, l, m


def flash_bwd_fused(q_scaled, k, v, do, lse2, delta, rule_c: FaRule, tables_t, block_q,
                    block_kv, dk_scale):
    """Launch ``flash_bwd_fused`` over the transposed schedule; returns the
    unscaled float32 dQ accumulator (B, q_len, d), dk and dv."""
    code = _check_attn(q_scaled, k, v, rule_c, do, (lse2, delta))
    B, q_len, d = q_scaled.shape
    dq_acc = torch.zeros((B, q_len, d), dtype=torch.float32, device=q_scaled.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("fa_flash_bwd_fused", code, q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse2.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
          dv.data_ptr(), *_sched_args(tables_t, block_q, block_kv), B, B // k.shape[0], d,
          v.shape[2], float(dk_scale), ctypes.byref(rule_c))
    return dq_acc, dk, dv


def flash_bwd_dq(q_scaled, k, v, do, lse2, delta, rule_c: FaRule, tables, block_q, block_kv,
                 scale):
    """Launch ``flash_bwd_dq`` (q-outer schedule); returns dq (B, q_len, d)."""
    code = _check_attn(q_scaled, k, v, rule_c, do, (lse2, delta))
    B, q_len, d = q_scaled.shape
    dq = torch.empty_like(q_scaled)
    _call("fa_flash_bwd_dq", code, q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(),
          *_sched_args(tables, block_q, block_kv), B, B // k.shape[0], d, v.shape[2],
          float(scale), ctypes.byref(rule_c))
    return dq


def flash_bwd_dkv(q, k_scaled, v, do, lse2, delta, rule_c: FaRule, tables_t, block_q,
                  block_kv, scale):
    """Launch ``flash_bwd_dkv`` (transposed schedule): unscaled q, prescaled
    k; returns dk (B_kv, k_len, d) and dv."""
    code = _check_attn(q, k_scaled, v, rule_c, do, (lse2, delta))
    B, q_len, d = q.shape
    dk, dv = torch.empty_like(k_scaled), torch.empty_like(v)
    _call("fa_flash_bwd_dkv", code, q.data_ptr(), k_scaled.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse2.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          *_sched_args(tables_t, block_q, block_kv), B, B // k_scaled.shape[0], d,
          v.shape[2], float(scale), ctypes.byref(rule_c))
    return dk, dv


def banded_fwd(q_scaled, k, v, rule_c: FaRule, seg, block_q, block_kv):
    """Launch ``banded_fwd``: as ``flash_fwd``, walking ``seg`` (the
    schedule's band segments, ``(rows, 4)`` int32 on the card)."""
    code = _check_attn(q_scaled, k, v, rule_c)
    B, q_len, d = q_scaled.shape
    v_d = v.shape[2]
    o = torch.empty((B, q_len, v_d), dtype=q_scaled.dtype, device=q_scaled.device)
    l = torch.empty((B, q_len), dtype=torch.float32, device=q_scaled.device)
    m = torch.empty_like(l)
    _call("fa_banded_fwd", code, q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(),
          o.data_ptr(), l.data_ptr(), m.data_ptr(), seg.data_ptr(), block_q, block_kv,
          B, B // k.shape[0], d, v_d, ctypes.byref(rule_c))
    return o, l, m


def window_fwd(q_scaled, k, v, rule_c: FaRule, starts, band, sub_q, masked):
    """Launch ``window_fwd``: one key band ``[starts[i], + band)`` per
    ``sub_q`` query rows (``starts`` int32 on the card); ``masked`` false
    only where every element of every band is visible."""
    code = _check_attn(q_scaled, k, v, rule_c)
    B, q_len, d = q_scaled.shape
    v_d = v.shape[2]
    if band % LANE or sub_q % LANE or window_fwd_smem(band, d, v_d) > MAX_SMEM:
        raise ValueError(f"window_fwd takes lane-aligned bands whose scores fit shared "
                         f"memory, got band {band}, sub_q {sub_q}, d {d}, v_d {v_d}")
    o = torch.empty((B, q_len, v_d), dtype=q_scaled.dtype, device=q_scaled.device)
    l = torch.empty((B, q_len), dtype=torch.float32, device=q_scaled.device)
    m = torch.empty_like(l)
    _call("fa_window_fwd", code, q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(),
          o.data_ptr(), l.data_ptr(), m.data_ptr(), starts.data_ptr(), band, sub_q,
          int(bool(masked)), B, B // k.shape[0], d, v_d, ctypes.byref(rule_c))
    return o, l, m


def banded_bwd(q_scaled, k, v, do, lse2, delta, rule_c: FaRule, seg_t, block_q, block_kv,
               dk_scale):
    """Launch ``banded_bwd``: as ``flash_bwd_fused``, walking ``seg_t`` (the
    transposed schedule's band segments on the card)."""
    code = _check_attn(q_scaled, k, v, rule_c, do, (lse2, delta))
    B, q_len, d = q_scaled.shape
    dq_acc = torch.zeros((B, q_len, d), dtype=torch.float32, device=q_scaled.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("fa_banded_bwd", code, q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse2.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
          dv.data_ptr(), seg_t.data_ptr(), block_q, block_kv, B, B // k.shape[0], d,
          v.shape[2], float(dk_scale), ctypes.byref(rule_c))
    return dq_acc, dk, dv


def window_bwd(q_scaled, k, v, do, lse2, delta, rule_c: FaRule, starts_t, band, sub_kv,
               dk_scale):
    """Launch ``window_bwd``: one query band ``[starts_t[i], + band)`` per
    ``sub_kv`` key rows; returns the unscaled float32 dQ accumulator, dk, dv."""
    code = _check_attn(q_scaled, k, v, rule_c, do, (lse2, delta))
    B, q_len, d = q_scaled.shape
    if band % LANE or sub_kv % LANE:
        raise ValueError(f"window_bwd takes lane-aligned bands, got band {band}, "
                         f"sub_kv {sub_kv}")
    dq_acc = torch.zeros((B, q_len, d), dtype=torch.float32, device=q_scaled.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("fa_window_bwd", code, q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse2.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
          dv.data_ptr(), starts_t.data_ptr(), band, sub_kv, B, B // k.shape[0], d,
          v.shape[2], float(dk_scale), ctypes.byref(rule_c))
    return dq_acc, dk, dv


def resident_fwd(q_scaled, k, v, rule_c: FaRule, seg, block_q, block_kv):
    """Launch ``resident_fwd``: as ``banded_fwd``, one CTA per query row."""
    code = _check_attn(q_scaled, k, v, rule_c)
    B, q_len, d = q_scaled.shape
    v_d = v.shape[2]
    o = torch.empty((B, q_len, v_d), dtype=q_scaled.dtype, device=q_scaled.device)
    l = torch.empty((B, q_len), dtype=torch.float32, device=q_scaled.device)
    m = torch.empty_like(l)
    _call("fa_resident_fwd", code, q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(),
          o.data_ptr(), l.data_ptr(), m.data_ptr(), seg.data_ptr(), block_q, block_kv,
          B, B // k.shape[0], d, v_d, ctypes.byref(rule_c))
    return o, l, m


def flash_bwd_qouter(q_scaled, k, v, do, lse2, delta, rule_c: FaRule, tables, block_q,
                     block_kv, scale):
    """Launch ``flash_bwd_qouter`` (q-outer schedule); returns dq (B, q_len,
    d) and the unscaled float32 dK and dV accumulators (B_kv, k_len, ·)."""
    code = _check_attn(q_scaled, k, v, rule_c, do, (lse2, delta))
    B, q_len, d = q_scaled.shape
    dq = torch.empty_like(q_scaled)
    dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    _call("fa_flash_bwd_qouter", code, q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk_acc.data_ptr(),
          dv_acc.data_ptr(), *_sched_args(tables, block_q, block_kv), B, B // k.shape[0], d,
          v.shape[2], float(scale), ctypes.byref(rule_c))
    return dq, dk_acc, dv_acc
