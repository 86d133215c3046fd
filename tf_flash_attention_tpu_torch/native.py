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
adds one where the C entry has launched, and nowhere else.  A serving
kernel launched with its sequence-sharding arguments on (the ``(l, m)``
outputs, a page stride, global lengths) counts under its variant's name,
``<kernel>[cp]`` (``CP_VARIANTS``), so a context-parallel run shows its own
launches.

``native_tile_classes`` is the JAX package's hook for its C++ schedule
classifier (``csrc/fa_native.cc``), which is not ported: it returns
``None``, which sends ``schedule.py`` to its NumPy classifier (the spec).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .block_sizes import LANE
from .mask_rules import CausalRule, FullRule, LocalRule
from .sync_modes import ref_log2

__all__ = ["LAUNCHES", "SERVING_KERNELS", "CP_VARIANTS", "ATTENTION_KERNELS",
           "EXPERIMENT_KERNELS", "KERNEL_SOURCES", "reset_launch_counts", "build", "library",
           "native_tile_classes"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# no --use_fast_math: the int8 quantization must divide and round exactly
# as the reference does, and exp2f must stay accurate; -Xptxas -v reports
# each kernel's registers and spills (``BUILD_LOG``, ``ptxas_summary``)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SERVING_KERNELS = ("paged_decode", "paged_multitoken_decode", "paged_prefill",
                   "kv_chunk_write", "kv_append")
# the sequence-sharded variants of four of them (kv_append shards by its
# ``active`` mask and has none)
CP_VARIANTS = tuple(f"{k}[cp]" for k in SERVING_KERNELS if k != "kv_append")
ATTENTION_KERNELS = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv",
                     "flash_bwd_qouter", "banded_fwd", "banded_bwd", "window_fwd",
                     "window_bwd", "resident_fwd")
# the experiment tools' kernels (``experiments/``), one name per Pallas site
EXPERIMENT_KERNELS = ("exp_resident_fwd", "exp_int4_int8ref", "exp_int4_s32", "exp_int4_twopage",
                      "exp_int4_fourpage", "exp_int4_int8_2pg", "exp_int4_bitcast",
                      "exp_vpu_ladder", "exp_paged_decode", "exp_kv_unroll")
LAUNCHES = {name: 0 for name in
            SERVING_KERNELS + CP_VARIANTS + ATTENTION_KERNELS + EXPERIMENT_KERNELS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float16: 3,
               torch.float8_e4m3fn: 4, torch.float8_e5m2: 5}
# an int4 cache stores nibble pairs in int8 bytes: its payload has a code of
# its own
_INT4_CODE = 6

_libs = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


#: what the last launch of a kernel reported, by kernel: ``body``
#: ("tensor-core" or "scalar") for ``flash_bwd_qouter``, ``paged_prefill``
#: and ``paged_prefill[cp]``; for each persistent walk (``resident_fwd`` and
#: the three experiment forwards) also ``grid`` (CTAs), ``items`` (work
#: items) and ``group_rows`` (the rows a group of the walk)
WALKS = {}


def _walk(kernel: str, out) -> None:
    WALKS[kernel] = dict(grid=out[0], items=out[1], group_rows=out[2],
                         body="tensor-core" if out[3] else "scalar")


def _body(kernel: str, body) -> None:
    WALKS[kernel] = dict(body="tensor-core" if body.value else "scalar")


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


#: each source this process built: ``seconds`` from the start of the build
#: to its nvcc's end, and ptxas's report (``ptxas``, its stderr)
BUILD_LOG = {}


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
    t0 = time.perf_counter()

    def finish(job):
        _, err = job[2].communicate()
        return err, time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        ends = list(pool.map(finish, jobs))
    errors = []
    for (src, tmp, proc), (err, seconds) in zip(jobs, ends):
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"{src}: nvcc failed ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, paths[src])
            BUILD_LOG[src] = dict(seconds=seconds, ptxas=err)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def ptxas_summary(source: str) -> list:
    """The kernels of a source this process built, from ptxas's report: one
    dict each with the (demangled, where ``cu++filt`` is at hand) name,
    ``registers``, ``spill_stores`` and ``spill_loads`` in bytes, and
    ``warnings``, ptxas's performance notes on it (C7510-C7520: ``wgmma``
    serialized)."""
    kernels, cur = [], None
    for line in BUILD_LOG[source]["ptxas"].splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            cur = dict(name=m.group(1), registers=0, spill_stores=0, spill_loads=0, warnings=[])
            kernels.append(cur)
        elif cur is None:
            continue
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            cur["registers"] = int(m.group(1))
        elif re.search(r"\(C75\d\d\)", line):   # names its function
            owner = max((k for k in kernels if k["name"] in line), key=lambda k: len(k["name"]),
                        default=cur)
            owner["warnings"].append(line.split(":", 1)[-1].strip())
    filt = shutil.which("cu++filt") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cu++filt")
    if kernels and os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(k["name"] for k in kernels),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(kernels):
            for k, name in zip(kernels, names):
                k["name"] = name
    return kernels


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
        # true_len, trash, page_stride, page_offset
        "fa_kv_chunk_write": [_I, _I] + [_P] * 7 + [_I] * 12,
        # act, kv, k_new, v_new, k_pages, v_pages, k_scales, v_scales, tables,
        # lengths, active, S, n_kv, d, d_store, page_size, n_pages, max_pages,
        # trash
        "fa_kv_append": [_I, _I] + [_P] * 9 + [_I] * 8,
        # act, kv, q, k_pages, v_pages, k_scales, v_scales, tables, lengths,
        # glob_lengths, o, l, m, S, n_q, n_kv, d, d_store, page_size, n_pages,
        # max_pages, page_stride, page_offset, scale_log2e, window,
        # log2_stride, is_local (glob_lengths, l, m nullable)
        "fa_paged_decode": [_I, _I] + [_P] * 11 + [_I] * 10 + [_F] + [_I] * 3,
        # as fa_paged_decode, with gamma after S
        "fa_paged_multitoken_decode": [_I, _I] + [_P] * 11 + [_I] * 11 + [_F] + [_I] * 3,
        # act, kv, q, k_pages, v_pages, k_scales, v_scales, table_row, o, l,
        # m, chunk, n_q, n_kv, d, d_store, page_size, n_pages, max_pages,
        # page_stride, page_offset, start, total, first_live, count, window,
        # log2_stride, is_local, body (1 int out) (l, m nullable)
        "fa_paged_prefill": [_I, _I] + [_P] * 9 + [_I] * 17 + [_P],
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
        # counts, needs, num_steps, block_q, block_kv, B, g, d, v_d, scale,
        # body (1 int out), rule
        "fa_flash_bwd_qouter": [_I] + [_P] * 12 + [_I] * 7 + [_F, _P, _R],
        # dtype, a, k, v, s, o: the tensor-core building blocks on one tile
        "fa_tc_tile_check": [_I] + [_P] * 5,
        # dtype, x, y, z, dst, kt, st, o, dq: the tensor-core backward's
        # products on one tile
        "fa_tc_bwd_tile_check": [_I] + [_P] * 8,
    },
    "band_kernels.cu": {
        # dtype, q, k, v, o, l, m, seg, block_q, block_kv, B, g, d, v_d, rule
        "fa_banded_fwd": [_I] + [_P] * 7 + [_I] * 6 + [_R],
        # dtype, q, k, v, o, l, m, seg, next_item, block_q, block_kv, B, g,
        # d, v_d, walk (4 ints out), rule
        "fa_resident_fwd": [_I] + [_P] * 8 + [_I] * 6 + [_P, _R],
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
    "exp_decode_kernels.cu": {
        # q, k, ks, v, vs, o, B, n_kv, G, pages, rows, scale_log2e
        **{f"fa_{name}": [_P] * 6 + [_I] * 5 + [_F]
           for name in ("exp_int4_int8ref", "exp_int4_s32", "exp_int4_twopage",
                        "exp_int4_fourpage", "exp_int4_int8_2pg", "exp_int4_bitcast")},
        # variant, q, k_pages, v_pages, k_scales, v_scales, tables, lengths, o,
        # q_codes, s_int, p_codes, S, n_kv, G, n_pages, page, max_pages,
        # scale_log2e (the codes nullable)
        "fa_exp_paged_decode": [_I] + [_P] * 11 + [_I] * 6 + [_F],
    },
    "exp_forward_kernels.cu": {
        # q, k, v, o, next_item, B, S, d, block_q, block_kv, walk (4 ints out)
        "fa_exp_resident_fwd": [_P] * 5 + [_I] * 5 + [_P],
        # rung, q, k, v, o, next_item, B, S, d, block_q, block_kv, walk
        "fa_exp_vpu_ladder": [_I] + [_P] * 5 + [_I] * 5 + [_P],
        # nkv, fused, q, k, v, o, next_item, B, S, d, block_kv, scale_log2e, walk
        "fa_exp_kv_unroll": [_I, _I] + [_P] * 5 + [_I] * 4 + [_F, _P],
    },
}

#: the source file of each kernel, by its ``LAUNCHES`` name
KERNEL_SOURCES = {entry[3:]: src for src, entries in _SIGNATURES.items() for entry in entries
                  if entry[3:] in LAUNCHES}
KERNEL_SOURCES.update({v: KERNEL_SOURCES[v[:-4]] for v in CP_VARIANTS})


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


def _launch(source: str, name: str, *args) -> None:
    """Launch the C entry ``name`` of ``source`` on the current stream;
    raises if it did not launch."""
    err = getattr(library(source), name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


def _call(name: str, *args, cp: bool = False) -> None:
    """Launch the C entry ``name`` (``fa_<kernel>``) on the current stream and
    count the launch (under ``<kernel>[cp]`` when ``cp``)."""
    kernel = name[3:]
    _launch(KERNEL_SOURCES[kernel], name, *args)
    LAUNCHES[f"{kernel}[cp]" if cp else kernel] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _codes(act: torch.dtype, cache, cfg) -> tuple:
    """(activation, payload) codes of the kernels' dispatch."""
    if act not in (torch.float32, torch.bfloat16):
        raise TypeError(f"activations must be float32 or bfloat16, got {act}")
    kv = cache.k_pages.dtype
    if kv != cfg.payload_dtype:
        raise TypeError(f"cache payload {kv}, config says {cfg.payload_dtype}")
    if not cfg.quantized and kv != act:
        raise TypeError(f"an unquantized cache holds the activations' dtype: "
                        f"{kv} cache, {act} activations")
    return _DTYPE_CODE[act], _INT4_CODE if cfg.is_int4 else _DTYPE_CODE[kv]


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


def kv_chunk_write(cache, cfg, slot, start, k, v, true_len, trash_page, page_stride=1,
                   page_offset=0) -> None:
    """Launch ``kv_chunk_write``: quantize and store k, v (n_kv, chunk, d);
    with a page stride, only the rows of this shard's pages."""
    n_kv, chunk, d = k.shape
    act, kv = _codes(k.dtype, cache, cfg)
    dims = _cache_dims(cache, cfg)
    table_row = cache.page_tables[slot]
    _call("fa_kv_chunk_write", act, kv, k.data_ptr(), v.data_ptr(),
          cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
          _ptr(cache.k_scales), _ptr(cache.v_scales), table_row.data_ptr(),
          n_kv, chunk, d, cfg.head_dim_store, *dims, start, true_len, trash_page,
          page_stride, page_offset, cp=page_stride != 1)


def kv_append(cache, cfg, k_new, v_new, active, trash_page) -> None:
    """Launch ``kv_append``: one token row per (slot, kv head)."""
    S, n_kv, d = k_new.shape
    act, kv = _codes(k_new.dtype, cache, cfg)
    dims = _cache_dims(cache, cfg)
    if active.dtype != torch.bool or active.shape != (S,):
        raise ValueError("active must be a bool vector of max_seqs entries")
    _call("fa_kv_append", act, kv, k_new.data_ptr(), v_new.data_ptr(),
          cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
          _ptr(cache.k_scales), _ptr(cache.v_scales),
          cache.page_tables.data_ptr(), cache.lengths.data_ptr(), active.data_ptr(),
          S, n_kv, d, cfg.head_dim_store, *dims, trash_page)


def _lm(q, rows_shape, returning_l_m) -> tuple:
    """float32 (l, m) outputs of ``rows_shape``, or (None, None)."""
    if not returning_l_m:
        return None, None
    return (torch.empty(rows_shape, dtype=torch.float32, device=q.device),
            torch.empty(rows_shape, dtype=torch.float32, device=q.device))


#: the decode kernel's staging buffers (two of 32 KB) and rows a block
_DEC_STAGE, _DEC_ROWS = 32 * 1024, 16


def _check_smem(what: str, n_bytes: int) -> None:
    """The memory guard of a launch: ``n_bytes`` of shared memory a block."""
    if n_bytes > MAX_SMEM:
        raise ValueError(f"{what} needs {n_bytes} bytes of shared memory a block, more "
                         f"than the {MAX_SMEM} the H100 has")


def _decode_args(q, cache, cfg, gamma, returning_l_m, global_lengths) -> tuple:
    """Checks, outputs and the leading arguments shared by the two decode
    entries."""
    S, n_q, d = q.shape[0], q.shape[-2], q.shape[-1]
    act, kv = _codes(q.dtype, cache, cfg)
    dims = _cache_dims(cache, cfg)
    D, page = cfg.head_dim_store, cfg.page_size
    if D % LANE or D * (1 if cfg.quantized else cfg.payload_dtype.itemsize) > _DEC_STAGE:
        raise ValueError(f"the decode kernels take a head_dim_store that is a multiple of "
                         f"{LANE} whose stored row fits a {_DEC_STAGE}-byte stage, got {D}")
    rows = min(n_q // cfg.n_kv_heads * gamma, _DEC_ROWS)
    _check_smem(f"decode at head_dim_store {D}, page {page}",
                2 * _DEC_STAGE + 4 * (rows * (D + page) + 2 * page + 3 * rows))
    if global_lengths is not None and (global_lengths.dtype != torch.int32
                                       or not global_lengths.is_contiguous()):
        raise TypeError("global_lengths must be a contiguous int32 vector")
    o = torch.empty_like(q)
    l, m = _lm(q, q.shape[:-1], returning_l_m)
    outs = (o, l, m) if returning_l_m else o
    return outs, (act, kv, q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
                  _ptr(cache.k_scales), _ptr(cache.v_scales), cache.page_tables.data_ptr(),
                  cache.lengths.data_ptr(), _ptr(global_lengths), o.data_ptr(), _ptr(l),
                  _ptr(m)), (n_q, cfg.n_kv_heads, d, cfg.head_dim_store, *dims)


def paged_decode(q, cache, cfg, scale_log2e, rule, returning_l_m=False, page_stride=1,
                 page_offset=0, global_lengths=None):
    """Launch ``paged_decode``: q (S, n_q, d) -> o of the same shape, or
    (o, l, m) with l, m float32 (S, n_q)."""
    outs, lead, dims = _decode_args(q, cache, cfg, 1, returning_l_m, global_lengths)
    _call("fa_paged_decode", *lead, q.shape[0], *dims, page_stride, page_offset,
          float(scale_log2e), *_rule_args(rule),
          cp=returning_l_m or page_stride != 1 or global_lengths is not None)
    return outs


def paged_multitoken_decode(q, cache, cfg, scale_log2e, rule, returning_l_m=False,
                            page_stride=1, page_offset=0, global_lengths=None):
    """Launch ``paged_multitoken_decode``: q (S, gamma, n_q, d) -> o of the
    same shape (and l, m (S, gamma, n_q)); draft i of a slot sits at
    position ``length - gamma + i`` (the global length, where given)."""
    S, gamma = q.shape[:2]
    outs, lead, dims = _decode_args(q, cache, cfg, gamma, returning_l_m, global_lengths)
    _call("fa_paged_multitoken_decode", *lead, S, gamma, *dims, page_stride, page_offset,
          float(scale_log2e), *_rule_args(rule),
          cp=returning_l_m or page_stride != 1 or global_lengths is not None)
    return outs


def paged_prefill(qs, cache, cfg, slot, start, total, first_live, count, rule,
                  returning_l_m=False, page_stride=1, page_offset=0):
    """Launch ``paged_prefill``: prescaled q (chunk, n_q, d) -> o, or (o, l,
    m) with l, m float32 (chunk, n_q); ``first_live`` and ``count`` are the
    local page range.  ``prefill_body`` names the body; the launch's own
    report is in ``WALKS``."""
    chunk, n_q, d = qs.shape
    act, kv = _codes(qs.dtype, cache, cfg)
    dims = _cache_dims(cache, cfg)
    D, page = cfg.head_dim_store, cfg.page_size
    if D % LANE:
        raise ValueError(f"paged_prefill takes a head_dim_store that is a multiple of {LANE}, "
                         f"got {D}")
    _check_smem(f"paged_prefill at head_dim_store {D}, page {page}",
                PREFILL_TC_SMEM if prefill_body(qs.dtype, cfg) == "tensor-core"
                else prefill_smem(D, page))
    o = torch.empty_like(qs)
    l, m = _lm(qs, (chunk, n_q), returning_l_m)
    table_row = cache.page_tables[slot]
    body = ctypes.c_int(0)
    cp = returning_l_m or page_stride != 1
    _call("fa_paged_prefill", act, kv, qs.data_ptr(), cache.k_pages.data_ptr(),
          cache.v_pages.data_ptr(), _ptr(cache.k_scales), _ptr(cache.v_scales),
          table_row.data_ptr(), o.data_ptr(), _ptr(l), _ptr(m), chunk, n_q, cfg.n_kv_heads, d,
          cfg.head_dim_store, *dims, page_stride, page_offset, start, total, first_live, count,
          *_rule_args(rule), ctypes.byref(body), cp=cp)
    _body("paged_prefill[cp]" if cp else "paged_prefill", body)
    return (o, l, m) if returning_l_m else o


#: the keys of the tensor-core prefill's stages (a page holds whole stages)
PREFILL_STAGE_KEYS = 64


def prefill_body(act_dtype: torch.dtype, cfg) -> str:
    """The body ``paged_prefill`` runs (the C dispatch ``Prefill::run``):
    bf16 activations at ``head_dim_store`` 128 on pages of a multiple of 64
    tokens on the tensor cores (every payload, flat and ``[cp]``); float32
    activations (the lossless gate's), other stored widths and pages of 8,
    16 or 32 tokens on the scalar body."""
    tc = (act_dtype == torch.bfloat16 and cfg.head_dim_store == 128
          and cfg.page_size % PREFILL_STAGE_KEYS == 0)
    return "tensor-core" if tc else "scalar"


def prefill_smem(D: int, page: int) -> int:
    """Shared memory of the scalar prefill body: the float32 Q and K/V
    sub-tiles (32 rows, stored width D), the 32 rows' scores over a page,
    the page's scales and the row statistics (C ``Prefill::launch``)."""
    return 4 * (64 * (D + 1) + 32 * (page + 1) + 2 * page + 96)


#: the tensor-core prefill (C ``tc::kPfSmem``): 1 KB of alignment, Q (64
#: rows of 128 bf16 columns), a ring of two 64-key stages, each its bf16 K
#: and V tiles, the raw payload rows and the 64 K and V scales, and six
#: barriers
PREFILL_TC_SMEM = 1024 + 64 * 256 + 2 * (2 * 64 * 256 + 2 * 64 * 128 + 2 * 64 * 4) + 48


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


# ---- shared memory of the op kernels (mirrors csrc/attention_common.cuh,
# band_kernels.cu and attention_fwd_tc.cuh) ----

def _dim_class(d: int, v_d: int) -> int:
    """The scalar bodies' head-dim class: max(d, v_d) <= 128, <= 256, wider."""
    w = max(d, v_d)
    return 0 if w <= 128 else 1 if w <= 256 else 2


#: (BM, BN) CTA tiles of the scalar forward and backward bodies per class
_FWD_TILES = ((64, 64), (64, 32), (16, 16))
_BWD_TILES = ((64, 64), (32, 32), (16, 16))


def window_fwd_smem(band: int, d: int, v_d: int) -> int:
    """Shared memory of ``window_fwd`` (``band_kernels.cu``): the query tile
    (32 rows), one K or V tile (64, 32 or 16 rows by the head-dim class) and
    the whole band's float32 scores."""
    bn = (64, 32, 16)[_dim_class(d, v_d)]
    return 4 * (32 * (d | 1) + bn * max(d | 1, v_d | 1) + 32 * (band + 1) + 64)


def fwd_smem(d: int, v_d: int) -> int:
    """Shared memory of the scalar forward body (``flash_fwd_kernel``)."""
    bm, bn = _FWD_TILES[_dim_class(d, v_d)]
    return 4 * ((bm + bn) * (d | 1) + bn * (v_d | 1) + bm * (bn + 1) + 3 * bm)


def bwd_smem(d: int, v_d: int, score_tiles: int) -> int:
    """Shared memory of a scalar backward body (two score tiles, one for the
    split dQ kernel)."""
    bm, bn = _BWD_TILES[_dim_class(d, v_d)]
    return 4 * ((bm + bn) * ((d | 1) + (v_d | 1)) + score_tiles * bm * (bn + 1) + 2 * bm)


#: the widest class of the tensor-core forward: its 128-row Q tile in
#: shared memory, padded to 512 columns; wider heads run the scalar body
TC_MAX_D = 512


def tc_fwd_smem(d: int, v_d: int) -> int:
    """Shared memory of the tensor-core forward (``attention_fwd_tc.cuh``):
    Q (128 rows) and two K/V stages in 128-byte swizzled slabs of 64
    columns (Q and K padded to the class's width: 128, 256 or 512), 1 KB of
    alignment, the six barriers and the resident walk's item slot (C
    ``fwd_tc_smem``)."""
    bn, vn = (128, 128) if d <= 128 and v_d <= 128 else (64, 256) if d <= 256 else (32, 256)
    ds = {128: 2, 64: 4, 32: 8}[bn]
    return 1024 + ds * 128 * 128 + 2 * (ds + vn // 64) * bn * 128 + 8 * 6 + 8


def fwd_body(dtype: torch.dtype, d: int, v_d: int) -> str:
    """The body ``flash_fwd``, ``banded_fwd`` and ``resident_fwd`` run (the C
    dispatch ``fwd_any``): bf16 and fp16 at d <= ``TC_MAX_D`` on the tensor
    cores, float32 (TF32 would not hold its limit) and wider heads on the
    scalar body."""
    tc = dtype in (torch.bfloat16, torch.float16) and d <= TC_MAX_D
    return "tensor-core" if tc else "scalar"


#: the tensor-core backward (``attention_bwd_tc.cuh``): 128 kv rows a CTA,
#: K and V whole, a ring of two 64-row Q / dO stages and two dS^T tiles, all
#: in 128-byte swizzled slabs of 64 columns (d and v_d padded to 128), a
#: float (64, 64) dQ box per consumer warpgroup, the stages' lse2 and delta
#: rows, 1 KB of alignment and the barriers
TC_BWD_SMEM = (1024 + 2 * 2 * 128 * 128 + 2 * 2 * 2 * 64 * 128 + 2 * 128 * 128 + 2 * 64 * 64 * 4
               + 2 * 2 * 64 * 4 + 40)


def bwd_body(dtype: torch.dtype, d: int, v_d: int, q_len: int = 1, k_len: int = 1) -> str:
    """The body ``flash_bwd_fused``, ``banded_bwd`` and ``flash_bwd_qouter``
    run (the C dispatches ``bwd_fused_any`` and ``bwd_qouter_any``): bf16 and
    fp16 with max(d, v_d) <= 128 on the tensor cores, everything else, and
    an empty q or k, on the scalar body."""
    tc = (dtype in (torch.bfloat16, torch.float16) and max(d, v_d) <= 128
          and q_len > 0 and k_len > 0)
    return "tensor-core" if tc else "scalar"


#: the tensor-core q-outer backward (``attention_qouter_tc.cuh``): 128 query
#: rows a CTA, Q and dO whole and a ring of two 64-key K / V stages, all in
#: 128-byte swizzled slabs of 64 columns (d and v_d padded to 128), the
#: T(P) and T(dS) tiles (128 rows x 64 keys), a float (64, 128) partial per
#: consumer warpgroup, the rows' lse2 and delta, 1 KB of alignment and the
#: barriers (C ``kQoSmem``)
QOUTER_TC_SMEM = (1024 + 2 * 2 * 128 * 128 + 2 * 2 * 2 * 64 * 128 + 2 * 128 * 128
                  + 2 * 64 * 128 * 4 + 2 * 128 * 4 + 40)


def _check_bwd_smem(name: str, dtype: torch.dtype, d: int, v_d: int, q_len: int = 1,
                    k_len: int = 1) -> None:
    """The fused table, banded and q-outer backwards, on the body they run."""
    tc = QOUTER_TC_SMEM if name == "flash_bwd_qouter" else TC_BWD_SMEM
    _check_smem(f"{name} at d {d}, v_d {v_d}",
                tc if bwd_body(dtype, d, v_d, q_len, k_len) == "tensor-core"
                else bwd_smem(d, v_d, 2))


def _check_fwd_smem(name: str, dtype: torch.dtype, d: int, v_d: int) -> None:
    """The table, banded and resident forwards, on the body they run."""
    _check_smem(f"{name} at d {d}, v_d {v_d}",
                tc_fwd_smem(d, v_d) if fwd_body(dtype, d, v_d) == "tensor-core"
                else fwd_smem(d, v_d))


def tc_tile_check(a, k, v):
    """The tensor-core forward's building blocks on one tile, for the card
    tests: a, k (64, 64) and v (64, 128) of bf16 or fp16 give ``s = a k^T``
    and ``o = T(s) v`` as float32 (64, 64) and (64, 128).  Not a kernel of
    any path: not counted in ``LAUNCHES``."""
    if (a.dtype not in (torch.bfloat16, torch.float16) or any(
            t.dtype != a.dtype or not t.is_cuda or not t.is_contiguous() for t in (a, k, v))
            or a.shape != (64, 64) or k.shape != (64, 64) or v.shape != (64, 128)):
        raise ValueError("tc_tile_check takes contiguous bf16 or fp16 CUDA tensors a, k "
                         "(64, 64) and v (64, 128)")
    s = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    o = torch.empty((64, 128), dtype=torch.float32, device=a.device)
    _launch("attention_kernels.cu", "fa_tc_tile_check", _DTYPE_CODE[a.dtype], a.data_ptr(),
            k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr())
    return s, o


def tc_bwd_tile_check(x, y, z, dst, kt):
    """The tensor-core backward's products on one tile, for the card tests:
    x, y (64, 64), z (64, 128), dst (128, 64) and kt (128, 128) of bf16 or
    fp16 give ``st = x y^T`` (the S^T and dP^T product), ``o = T(st) z``
    (dV and dK: A from the fragments, z through the transpose bit) and ``dq =
    dst^T kt`` (dQ: A and B through the transpose bits) as float32 (64, 64),
    (64, 128) and (64, 128).  Not a kernel of any path: not counted in
    ``LAUNCHES``."""
    shapes = ((x, (64, 64)), (y, (64, 64)), (z, (64, 128)), (dst, (128, 64)), (kt, (128, 128)))
    if x.dtype not in (torch.bfloat16, torch.float16) or any(
            t.dtype != x.dtype or not t.is_cuda or not t.is_contiguous() or t.shape != shape
            for t, shape in shapes):
        raise ValueError("tc_bwd_tile_check takes contiguous bf16 or fp16 CUDA tensors x, y "
                         "(64, 64), z (64, 128), dst (128, 64) and kt (128, 128)")
    outs = [torch.empty(shape, dtype=torch.float32, device=x.device)
            for shape in ((64, 64), (64, 128), (64, 128))]
    _launch("attention_kernels.cu", "fa_tc_bwd_tile_check", _DTYPE_CODE[x.dtype],
            *(t.data_ptr() for t, _ in shapes), *(t.data_ptr() for t in outs))
    return tuple(outs)


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
            or (do is not None and tuple(do.shape) != (B, q_len, v_d))):
        raise ValueError(f"inconsistent attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, rule lengths "
                         f"({rule_c.q_len}, {rule_c.k_len})")
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
    _check_fwd_smem("flash_fwd", q_scaled.dtype, d, v_d)
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
    _check_bwd_smem("flash_bwd_fused", q_scaled.dtype, d, v.shape[2], q_len, k.shape[1])
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
    _check_smem(f"flash_bwd_dq at d {d}, v_d {v.shape[2]}", bwd_smem(d, v.shape[2], 1))
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
    _check_smem(f"flash_bwd_dkv at d {d}, v_d {v.shape[2]}", bwd_smem(d, v.shape[2], 2))
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
    _check_fwd_smem("banded_fwd", q_scaled.dtype, d, v_d)
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
               dk_scale, with_dq=True):
    """Launch ``banded_bwd``: as ``flash_bwd_fused``, walking ``seg_t`` (the
    transposed schedule's band segments on the card).  ``with_dq=False``
    measures what dQ costs: the tensor-core body then skips the dS^T tile,
    the dQ product and its reduction, and the dQ accumulator is ``None``."""
    code = _check_attn(q_scaled, k, v, rule_c, do, (lse2, delta))
    B, q_len, d = q_scaled.shape
    _check_bwd_smem("banded_bwd", q_scaled.dtype, d, v.shape[2], q_len, k.shape[1])
    if not with_dq and bwd_body(q_scaled.dtype, d, v.shape[2]) != "tensor-core":
        raise ValueError("only the tensor-core body of banded_bwd runs without dQ")
    dq_acc = torch.zeros((B, q_len, d), dtype=torch.float32,
                         device=q_scaled.device) if with_dq else None
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("fa_banded_bwd", code, q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse2.data_ptr(), delta.data_ptr(), _ptr(dq_acc), dk.data_ptr(),
          dv.data_ptr(), seg_t.data_ptr(), block_q, block_kv, B, B // k.shape[0], d,
          v.shape[2], float(dk_scale), ctypes.byref(rule_c))
    return dq_acc, dk, dv


def window_bwd(q_scaled, k, v, do, lse2, delta, rule_c: FaRule, starts_t, band, sub_kv,
               dk_scale):
    """Launch ``window_bwd``: one query band ``[starts_t[i], + band)`` per
    ``sub_kv`` key rows; returns the unscaled float32 dQ accumulator, dk, dv."""
    code = _check_attn(q_scaled, k, v, rule_c, do, (lse2, delta))
    B, q_len, d = q_scaled.shape
    _check_smem(f"window_bwd at d {d}, v_d {v.shape[2]}", bwd_smem(d, v.shape[2], 2))
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
    """Launch ``resident_fwd``: as ``banded_fwd``, the rows' query tiles
    walked in row order (bf16 / fp16: persistent CTAs on the tensor-core
    body, taking (row, query tile) items from a work counter by groups of
    the rows one wave of the grid covers; float32 and d > ``TC_MAX_D``: a
    CTA a row on the scalar body).  The launch is in ``WALKS``."""
    code = _check_attn(q_scaled, k, v, rule_c)
    B, q_len, d = q_scaled.shape
    v_d = v.shape[2]
    _check_fwd_smem("resident_fwd", q_scaled.dtype, d, v_d)
    o = torch.empty((B, q_len, v_d), dtype=q_scaled.dtype, device=q_scaled.device)
    l = torch.empty((B, q_len), dtype=torch.float32, device=q_scaled.device)
    m = torch.empty_like(l)
    next_item = torch.zeros(1, dtype=torch.int32, device=q_scaled.device)
    walk = (ctypes.c_int * 4)()
    _call("fa_resident_fwd", code, q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(),
          o.data_ptr(), l.data_ptr(), m.data_ptr(), seg.data_ptr(), next_item.data_ptr(),
          block_q, block_kv, B, B // k.shape[0], d, v_d, walk, ctypes.byref(rule_c))
    _walk("resident_fwd", walk)
    return o, l, m


def flash_bwd_qouter(q_scaled, k, v, do, lse2, delta, rule_c: FaRule, tables, block_q,
                     block_kv, scale):
    """Launch ``flash_bwd_qouter`` (q-outer schedule); returns dq (B, q_len,
    d) and the unscaled float32 dK and dV accumulators (B_kv, k_len, ·).
    ``bwd_body`` names the body; the launch's own report is in ``WALKS``."""
    code = _check_attn(q_scaled, k, v, rule_c, do, (lse2, delta))
    B, q_len, d = q_scaled.shape
    v_d = v.shape[2]
    _check_bwd_smem("flash_bwd_qouter", q_scaled.dtype, d, v_d, q_len, k.shape[1])
    dq = torch.empty_like(q_scaled)
    dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    body = ctypes.c_int(0)
    _call("fa_flash_bwd_qouter", code, q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk_acc.data_ptr(),
          dv_acc.data_ptr(), *_sched_args(tables, block_q, block_kv), B, B // k.shape[0], d,
          v_d, float(scale), ctypes.byref(body), ctypes.byref(rule_c))
    _body("flash_bwd_qouter", body)
    return dq, dk_acc, dv_acc


# ---- the experiment tools' kernels (experiments/) ----

#: the ladder's rungs in the order of exp_vpu_attrib's main (the kernel's codes)
LADDER_RUNGS = ("prod", "nomax", "noexp", "nosum", "bf16exp", "mm")
#: exp_decode's strategies (the kernel's codes); a ``_t`` suffix names the
#: scale layout only
DECODE_VARIANTS = ("current", "postscale", "int8mm")
#: the pages per step of each exp_int4_unpack kernel
INT4_NPG = {"exp_int4_int8ref": 1, "exp_int4_int8_2pg": 2, "exp_int4_s32": 1,
            "exp_int4_twopage": 2, "exp_int4_fourpage": 4, "exp_int4_bitcast": 1}


def _check_exp(*tensors, dtype=None) -> None:
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous() or (dtype is not None and t.dtype != dtype):
            raise ValueError(f"the experiment kernels take contiguous CUDA tensors"
                             f"{'' if dtype is None else f' of {dtype}'}, got {t.dtype} "
                             f"on {t.device}")


def _check_fwd(q, k, v) -> tuple:
    _check_exp(q, k, v, dtype=torch.bfloat16)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape or q.shape[2] > 128:
        raise ValueError(f"q, k, v must be (B, S, d <= 128) of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return tuple(q.shape)


#: the body of each experiment forward (``exp_forward_kernels.cu``)
EXP_FWD_BODY = {"exp_resident_fwd": "tensor-core", "exp_vpu_ladder": "tensor-core",
                "exp_kv_unroll": "tensor-core"}


def _exp_groups(name: str, *head, q, k, v, block_kv: int, tail=()):
    """Launch the ladder or kv_unroll (``name``) on the persistent
    tensor-core body: items of 128 query rows from a zeroed counter, merges
    of ``block_kv`` keys (a multiple of 128 dividing S).  The launch is in
    ``WALKS``."""
    B, S, d = _check_fwd(q, k, v)
    if block_kv % LANE or S % block_kv:
        raise ValueError(f"{name} takes merges of a multiple of {LANE} keys dividing S, got "
                         f"S {S}, {block_kv} keys")
    o = torch.empty_like(q)
    next_item = torch.zeros(1, dtype=torch.int32, device=q.device)
    walk = (ctypes.c_int * 4)()
    _call(f"fa_{name}", *head, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
          next_item.data_ptr(), B, S, d, *tail, walk)
    _walk(name, walk)
    return o


def exp_resident_fwd(q_scaled, k, v, block_q: int, block_kv: int):
    """Launch ``exp_resident_fwd``: exact causal attention of prescaled bf16
    q (B, S, d) on the resident tensor-core forward with the tool's bf16
    merge, items of ``block_q`` rows (a multiple of 128) and merges of
    ``block_kv`` keys (64 or a multiple of 128), S a multiple of both.  The
    launch is in ``WALKS``."""
    B, S, d = _check_fwd(q_scaled, k, v)
    if block_q % LANE or S % block_q or S % block_kv or (block_kv != LANE // 2
                                                          and block_kv % LANE):
        raise ValueError(f"exp_resident_fwd takes block_q a multiple of {LANE}, block_kv "
                         f"{LANE // 2} or a multiple of {LANE}, and S a multiple of both, got "
                         f"S {S}, block_q {block_q}, block_kv {block_kv}")
    o = torch.empty_like(q_scaled)
    next_item = torch.zeros(1, dtype=torch.int32, device=q_scaled.device)
    walk = (ctypes.c_int * 4)()
    _call("fa_exp_resident_fwd", q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
          next_item.data_ptr(), B, S, d, block_q, block_kv, walk)
    _walk("exp_resident_fwd", walk)
    return o


def exp_vpu_ladder(rung: str, q_scaled, k, v, block_q: int, block_kv: int):
    """Launch ``exp_vpu_ladder`` on one rung (``LADDER_RUNGS``, each a
    compiled merge policy): the block-causal forward of prescaled bf16 q
    (B, S, d), query blocks of ``block_q`` rows (a multiple of 128 dividing
    S), merges of ``block_kv`` keys.  The launch is in ``WALKS``."""
    if block_q % LANE or q_scaled.shape[1] % block_q:
        raise ValueError(f"exp_vpu_ladder takes block_q a multiple of {LANE} dividing S, got "
                         f"S {q_scaled.shape[1]}, block_q {block_q}")
    return _exp_groups("exp_vpu_ladder", LADDER_RUNGS.index(rung), q=q_scaled, k=k, v=v,
                       block_kv=block_kv, tail=(block_q, block_kv))


def exp_kv_unroll(q, k, v, nkv: int, fused: bool, block_kv: int, scale_log2e: float):
    """Launch ``exp_kv_unroll``: full attention of bf16 (B, S, d), merges of
    ``block_kv`` keys or (``fused``) of ``nkv * block_kv``.  The launch is in
    ``WALKS``."""
    return _exp_groups("exp_kv_unroll", nkv, int(bool(fused)), q=q, k=k, v=v,
                       block_kv=nkv * block_kv if fused else block_kv,
                       tail=(block_kv, float(scale_log2e)))


def exp_int4_decode(kernel: str, q, k, ks, v, vs, scale_log2e: float):
    """Launch one of exp_int4_unpack's kernels (``INT4_NPG``): q (B, n_kv,
    G, 128) bf16 over the K/V every row shares, k, v (n_kv, pages, rows,
    128) int8 (int4: nibble pairs), scales (n_kv, pages, pack, rows)."""
    _check_exp(q, dtype=torch.bfloat16)
    _check_exp(k, v, dtype=torch.int8)
    _check_exp(ks, vs, dtype=torch.float32)
    B, n_kv, G, d = q.shape
    _, pages, rows, _ = k.shape
    pack = 1 if kernel.startswith("exp_int4_int8") else 2
    if (d != 128 or k.shape != (n_kv, pages, rows, d) or v.shape != k.shape
            or ks.shape != (n_kv, pages, pack, rows) or vs.shape != ks.shape
            or pages % INT4_NPG[kernel]):
        raise ValueError(f"{kernel}: inconsistent shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, scales {tuple(ks.shape)} (d 128, pages a "
                         f"multiple of {INT4_NPG[kernel]})")
    o = torch.empty_like(q)
    _call(f"fa_{kernel}", q.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr(),
          o.data_ptr(), B, n_kv, G, pages, rows, float(scale_log2e))
    return o


def exp_paged_decode(variant: str, q, k_pages, v_pages, k_scales, v_scales, tables, lengths,
                     scale_log2e: float, codes: bool = False):
    """Launch ``exp_paged_decode`` (``DECODE_VARIANTS``): q (S, n_q, 128)
    bf16 over an int8 paged cache, scales (n_kv, n_pages, 1, page) or
    (n_kv, n_pages, page, 1).  Returns o, or with ``codes`` (int8mm) (o, q
    codes (S, n_q, 128) int8, integer scores (S, n_q, max_pages * page)
    int32, p codes (S, n_q, max_pages * page) int8), zero past each slot's
    live pages."""
    _check_exp(q, dtype=torch.bfloat16)
    _check_exp(k_pages, v_pages, dtype=torch.int8)
    _check_exp(k_scales, v_scales, dtype=torch.float32)
    _check_exp(tables, lengths, dtype=torch.int32)
    S, n_q, d = q.shape
    n_kv, n_pages, page, _ = k_pages.shape
    max_pages = tables.shape[1]
    if (d != 128 or n_q % n_kv or v_pages.shape != k_pages.shape
            or k_scales.numel() != n_kv * n_pages * page or v_scales.shape != k_scales.shape
            or tables.shape[0] != S or lengths.shape != (S,)):
        raise ValueError(f"exp_paged_decode: inconsistent shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, scales {tuple(k_scales.shape)}, tables "
                         f"{tuple(tables.shape)}")
    if codes and variant != "int8mm":
        raise ValueError("only the int8mm variant has codes")
    o = torch.empty_like(q)
    extra = (torch.zeros((S, n_q, d), dtype=torch.int8, device=q.device),
             torch.zeros((S, n_q, max_pages * page), dtype=torch.int32, device=q.device),
             torch.zeros((S, n_q, max_pages * page), dtype=torch.int8, device=q.device)
             ) if codes else (None, None, None)
    _call("fa_exp_paged_decode", DECODE_VARIANTS.index(variant), q.data_ptr(),
          k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(),
          tables.data_ptr(), lengths.data_ptr(), o.data_ptr(), *(_ptr(t) for t in extra), S, n_kv,
          n_q // n_kv, n_pages, page, max_pages, float(scale_log2e))
    return (o, *extra) if codes else o
