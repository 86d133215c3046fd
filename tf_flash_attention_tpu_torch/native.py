"""Build, load and call the port's CUDA kernels.

``csrc/serving_kernels.cu`` is compiled with nvcc into a shared library with
a plain C interface on first use, and loaded with ``ctypes``.  The library
lives in ``build/torch_kernels/`` at the root of the checkout, and its file
name carries a hash of the sources and flags, so an edit rebuilds.  A
failed build or load raises; there is no fallback.

Each C entry launches one kernel on the given stream (PyTorch's current
stream), allocates nothing and returns ``cudaGetLastError()``; the Python
functions below allocate the outputs, and raise if that code is not 0.
``LAUNCHES`` counts, per kernel, the launches the serving wrappers made.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .mask_rules import LocalRule

__all__ = ["LAUNCHES", "reset_launch_counts", "build", "library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("serving_kernels.cu",)
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# no --use_fast_math: the int8 quantization must divide and round exactly
# as the reference does, and exp2f must stay accurate
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"paged_decode": 0, "paged_prefill": 0, "kv_chunk_write": 0,
            "kv_append": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def build() -> Path:
    """Compile the kernels if the library for these sources is missing."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    lib_path = _BUILD_DIR / f"libfa_serving_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(_CSRC / n) for n in _SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # act, kv, k, v, k_pages, v_pages, k_scales, v_scales, table_row,
    # n_kv, chunk, d, d_store, page_size, n_pages, max_pages, start,
    # true_len, trash, stream
    "fa_kv_chunk_write": [_I, _I] + [_P] * 7 + [_I] * 10 + [_P],
    # act, kv, k_new, v_new, k_pages, v_pages, k_scales, v_scales, tables,
    # lengths, active, S, n_kv, d, d_store, page_size, n_pages, max_pages,
    # trash, stream
    "fa_kv_append": [_I, _I] + [_P] * 9 + [_I] * 8 + [_P],
    # act, kv, q, k_pages, v_pages, k_scales, v_scales, tables, lengths, o,
    # S, n_q, n_kv, d, d_store, page_size, n_pages, max_pages,
    # scale_log2e, window, log2_stride, is_local, stream
    "fa_paged_decode": [_I, _I] + [_P] * 8 + [_I] * 8 + [_F] + [_I] * 3 + [_P],
    # act, kv, q, k_pages, v_pages, k_scales, v_scales, table_row, o,
    # chunk, n_q, n_kv, d, d_store, page_size, n_pages, max_pages, start,
    # total, first_live, count, window, log2_stride, is_local, stream
    "fa_paged_prefill": [_I, _I] + [_P] * 7 + [_I] * 15 + [_P],
}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _call(name: str, *args) -> None:
    err = getattr(library(), name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


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
