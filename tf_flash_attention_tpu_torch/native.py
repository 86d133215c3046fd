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
launches.  A serving engine's step captured as a CUDA graph
(``serving/graphs.py``) counts its kernels once in ``LAUNCHES``, where the
wrappers ran at capture, and each replay's in ``REPLAYED``.

The host runtime, ``csrc/fa_native.cc`` (a copy of the JAX package's
source: the schedule classifier, the FLOPs estimator and the
continuous-batching scheduler), is built the same way on first use, with
the host C++ compiler (``CXX``, else ``c++`` or ``g++``), into the same
directory, and its bindings keep the JAX package's names
(``get_lib``, ``native_tile_classes``, ``native_estimate_forward_flops``,
``NativeScheduler``).  Its build too raises when it fails; ``FA_NO_NATIVE``
set in the environment turns it off, and ``schedule.py`` then classifies
with its NumPy spec, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .block_sizes import LANE
from .mask_rules import CausalRule, FullRule, LocalRule, MaskRule
from .schedule import build_schedule, sequence_orders
from .sync_modes import ref_log2

__all__ = ["LAUNCHES", "REPLAYED", "SERVING_KERNELS", "CP_VARIANTS", "ATTENTION_KERNELS",
           "EXPERIMENT_KERNELS", "KERNEL_SOURCES", "reset_launch_counts", "build",
           "compile_sources", "library", "get_lib", "native_tile_classes",
           "native_estimate_forward_flops", "NativeScheduler"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# no --use_fast_math: the int8 quantization must divide and round exactly
# as the reference does, and exp2f must stay accurate; -Xptxas -v reports
# each kernel's registers and spills (``BUILD_LOG``, ``ptxas_summary``)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SERVING_KERNELS = ("paged_decode", "paged_multitoken_decode", "paged_prefill",
                   "kv_chunk_write", "kv_append")
# the sequence-sharded variants of four of them (kv_append's owner test is
# one more test in its one kernel: it has none)
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
#: the launches CUDA-graph replays made, per kernel (no wrapper runs there)
REPLAYED = dict.fromkeys(LAUNCHES, 0)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float16: 3,
               torch.float8_e4m3fn: 4, torch.float8_e5m2: 5}
# an int4 cache stores nibble pairs in int8 bytes: its payload has a code of
# its own
_INT4_CODE = 6

_libs = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = REPLAYED[name] = 0


#: what the last launch of a kernel reported, by kernel: ``body``
#: ("tensor-core" or "scalar") for ``flash_bwd_qouter``, the split pair
#: (``flash_bwd_dq``, ``flash_bwd_dkv``), the window kernels (``window_fwd``,
#: ``window_bwd``), ``paged_prefill`` and
#: ``paged_prefill[cp]``; ("vector" or "scalar") for ``kv_chunk_write``,
#: ``kv_chunk_write[cp]`` and ``kv_append``; for the decodes (``paged_decode``,
#: ``paged_multitoken_decode`` and their ``[cp]`` forms) also ``splits`` and
#: ``ctas``; the same three for the int4 unpack tool's six sites
#: (``INT4_TC_UNPACK``) and ``exp_paged_decode``; for each
#: persistent walk (``resident_fwd`` and
#: the three experiment forwards) also ``grid`` (CTAs), ``items`` (work
#: items) and ``group_rows`` (the rows a group of the walk)
WALKS = {}


def _walk(kernel: str, out) -> None:
    WALKS[kernel] = dict(grid=out[0], items=out[1], group_rows=out[2],
                         body="tensor-core" if out[3] else "scalar")


def _body(kernel: str, body) -> None:
    WALKS[kernel] = dict(body="tensor-core" if body.value else "scalar")


HOST_SOURCE = "fa_native.cc"
# the JAX package's csrc/Makefile flags
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
_host_lock = threading.Lock()
_host_lib = None


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError(f"no host C++ compiler (CXX, c++ or g++) to build {HOST_SOURCE}")


def _host_lib_path() -> Path:
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    digest.update((_CSRC / HOST_SOURCE).read_bytes())
    return _BUILD_DIR / f"libfa_native_{digest.hexdigest()[:16]}.so"


def _configure(lib):
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    p_i32, p_i64, p_u8 = (ctypes.POINTER(t) for t in (i32, i64, ctypes.c_uint8))
    lib.fa_build_tile_classes.restype = i32
    lib.fa_build_tile_classes.argtypes = [
        i32, p_i32, p_i32, p_i32, p_i32, p_i32, p_i32, p_i32,
        i32, i32, i32, i32, i32, i32, i32, i32,
        p_u8, p_u8, p_i32, p_i32,
    ]
    lib.fa_estimate_forward_flops.restype = ctypes.c_double
    lib.fa_estimate_forward_flops.argtypes = [p_u8, i32, i32, i64, i64, i32, i32, i32, i32, i64]
    lib.fa_sched_create.restype = ctypes.c_void_p
    lib.fa_sched_create.argtypes = [i32, i64, i32]
    lib.fa_sched_destroy.restype = None
    lib.fa_sched_destroy.argtypes = [ctypes.c_void_p]
    lib.fa_sched_enqueue.restype = None
    lib.fa_sched_enqueue.argtypes = [ctypes.c_void_p, i64, i64, i64]
    lib.fa_sched_enqueue_capped.restype = None
    lib.fa_sched_enqueue_capped.argtypes = [ctypes.c_void_p, i64, i64, i64, i64]
    lib.fa_sched_queued.restype = i64
    lib.fa_sched_queued.argtypes = [ctypes.c_void_p]
    lib.fa_sched_admit.restype = i32
    lib.fa_sched_admit.argtypes = [ctypes.c_void_p, p_i64, p_i32, i32]
    lib.fa_sched_release.restype = None
    lib.fa_sched_release.argtypes = [ctypes.c_void_p, i32, i64]
    lib.fa_sched_refund.restype = None
    lib.fa_sched_refund.argtypes = [ctypes.c_void_p, i64]
    return lib


def get_lib():
    """The host runtime library, compiled from ``csrc/fa_native.cc`` on
    first use (a failed build raises); None when ``FA_NO_NATIVE`` is set.
    Concurrent processes each compile to a temporary file and rename it
    into place."""
    global _host_lib
    if os.environ.get("FA_NO_NATIVE"):
        return None
    with _host_lock:
        if _host_lib is None:
            path = _host_lib_path()
            if not path.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
                os.close(fd)
                try:
                    res = subprocess.run([_cxx(), *HOST_FLAGS, "-o", tmp, str(_CSRC / HOST_SOURCE)],
                                         capture_output=True, text=True)
                    if res.returncode != 0:
                        raise RuntimeError(f"{HOST_SOURCE}: the host build failed "
                                           f"({res.returncode}):\n{res.stderr}")
                    os.replace(tmp, path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            _host_lib = _configure(ctypes.CDLL(str(path)))
        return _host_lib


def _i32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def native_tile_classes(pack, rule, block_q: int, block_kv: int):
    """The C++ tile classifier: ``(live, partial)`` bool arrays (q tiles, kv
    tiles), or None where it does not apply (``FA_NO_NATIVE``, or a rule
    other than full, causal and local: a custom ``MaskRule`` has no C++
    kind), which sends ``schedule.py`` to its NumPy classifier."""
    lib = get_lib()
    if lib is None:
        return None
    if isinstance(rule, FullRule):
        kind, window, log2s, causal = 0, 0, 0, 0
    elif isinstance(rule, CausalRule):
        kind, window, log2s, causal = 1, 0, 0, 0
    elif isinstance(rule, LocalRule):
        kind, window = 2, rule.window_size
        log2s, causal = rule.log2_stride_size, int(rule.is_causal)
    else:
        return None
    q_len, k_len = int(np.prod(pack.q.shape)), int(np.prod(pack.k.shape))
    n_q, n_k = -(-q_len // block_q), -(-k_len // block_kv)
    live = np.zeros(n_q * n_k, dtype=np.uint8)
    partial = np.zeros(n_q * n_k, dtype=np.uint8)
    nq_out, nk_out = ctypes.c_int32(), ctypes.c_int32()
    # the int32 copies stay referenced here through the call
    held = [np.ascontiguousarray(x, dtype=np.int32) for x in (
        pack.q.shape, pack.q.stride, pack.q.offset, pack.k.shape, pack.k.stride, pack.k.offset,
        ref_log2(pack.reference_shape))]
    u8 = ctypes.POINTER(ctypes.c_uint8)
    status = lib.fa_build_tile_classes(
        pack.ndim, *(_i32_ptr(h) for h in held), kind, window, log2s, causal,
        block_q, block_kv, int(q_len % block_q != 0), int(k_len % block_kv != 0),
        live.ctypes.data_as(u8), partial.ctypes.data_as(u8),
        ctypes.byref(nq_out), ctypes.byref(nk_out))
    if status != 0:
        return None
    if (nq_out.value, nk_out.value) != (n_q, n_k):
        raise RuntimeError(f"tile grid {(nq_out.value, nk_out.value)} != {(n_q, n_k)}")
    return live.reshape(n_q, n_k).astype(bool), partial.reshape(n_q, n_k).astype(bool)


def native_estimate_forward_flops(live: np.ndarray, q_len: int, k_len: int,
                                  block_q: int, block_kv: int,
                                  d: int, v_d: int, batch: int):
    """The C++ FLOPs estimate over the live tiles (``flops.py``'s
    ``estimate_forward_flops``); None when ``FA_NO_NATIVE`` is set."""
    lib = get_lib()
    if lib is None:
        return None
    live_u8 = np.ascontiguousarray(live, dtype=np.uint8)
    n_q, n_k = live_u8.shape
    return float(lib.fa_estimate_forward_flops(
        live_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_q, n_k, q_len, k_len,
        block_q, block_kv, d, v_d, batch))


class NativeScheduler:
    """The C++ continuous-batching scheduler (``serving/scheduler.py``'s
    ``Scheduler`` is its spec): FCFS admission under a page budget."""

    def __init__(self, max_seqs: int, n_pages: int, page_size: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("the host runtime is off (FA_NO_NATIVE)")
        self._lib = lib
        self._h = lib.fa_sched_create(max_seqs, n_pages, page_size)
        self._max_seqs = max_seqs

    def enqueue(self, rid: int, prompt_len: int, max_new_tokens: int,
                pages_cap: int = -1) -> None:
        """Queue a request; ``pages_cap`` >= 0 caps the pages it reserves
        (a window model's rolling set), -1 reserves its whole length."""
        self._lib.fa_sched_enqueue_capped(self._h, rid, prompt_len, max_new_tokens, pages_cap)

    @property
    def queued(self) -> int:
        return int(self._lib.fa_sched_queued(self._h))

    def admit(self):
        """``[(rid, slot)]`` admitted in queue order while slots and pages last."""
        rids = np.zeros(self._max_seqs, dtype=np.int64)
        slots = np.zeros(self._max_seqs, dtype=np.int32)
        n = self._lib.fa_sched_admit(self._h, rids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                     _i32_ptr(slots), self._max_seqs)
        return [(int(rids[i]), int(slots[i])) for i in range(n)]

    def release(self, slot: int, pages_held: int) -> None:
        self._lib.fa_sched_release(self._h, slot, pages_held)

    def refund(self, n_pages: int) -> None:
        self._lib.fa_sched_refund(self._h, n_pages)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.fa_sched_destroy(h)


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


def compile_sources(csrc: Path, outputs: dict) -> None:
    """Compile each ``csrc / source`` into ``outputs[source]``, all nvcc
    processes started together; each one's seconds and ptxas report go to
    ``BUILD_LOG``.  Raises if any fails."""
    nvcc = _nvcc()
    jobs = []
    for src, out in outputs.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(csrc / src)],
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
            os.replace(tmp, outputs[src])
            BUILD_LOG[src] = dict(seconds=seconds, ptxas=err)
    if errors:
        raise RuntimeError("\n".join(errors))


def build() -> dict:
    """Compile every source whose library is missing, all nvcc processes
    started together; returns ``{source: library path}``."""
    paths = {src: _lib_path(src) for src in _SIGNATURES}
    todo = {src: path for src, path in paths.items() if not path.exists()}
    if todo:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compile_sources(_CSRC, todo)
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


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class FaRule(ctypes.Structure):
    """The sync pack and mask rule as the kernels read them
    (``struct FaRule`` in ``csrc/attention_common.cuh``)."""

    _fields_ = [("ndim", _I),
                ("q_shape", _I * 2), ("q_stride", _I * 2), ("q_offset", _I * 2),
                ("k_shape", _I * 2), ("k_stride", _I * 2), ("k_offset", _I * 2),
                ("shift0", _I), ("kind", _I), ("window", _I), ("log2_stride", _I),
                ("is_causal", _I), ("q_len", _I), ("k_len", _I),
                ("mask_cols", _I), ("mask_index", _P), ("mask_bits", _P)]


_R = ctypes.POINTER(FaRule)

# per source: C entry -> argument types (the stream, last, is added below)
_SIGNATURES = {
    "serving_kernels.cu": {
        # act, kv, k, v, k_pages, v_pages, k_scales, v_scales, tables,
        # lengths, meta (slot, start, total, trash_page, page_offset), chunk,
        # n_kv, head_stride, row_stride, d, d_store, page_size, n_pages,
        # max_pages, page_stride, body (1 int out)
        "fa_kv_chunk_write": [_I, _I] + [_P] * 9 + [_I, _I, _L, _L] + [_I] * 6 + [_P],
        # act, kv, k, v, k_pages, v_pages, k_scales, v_scales, tables,
        # lengths, active, glob, S, T, n_kv, slot_stride, tok_stride,
        # head_stride, d, d_store, page_size, n_pages, max_pages, page_stride,
        # page_offset, body (1 int out) (glob nullable)
        "fa_kv_append": [_I, _I] + [_P] * 10 + [_I] * 3 + [_L] * 3 + [_I] * 7 + [_P],
        # act, kv, q, k_pages, v_pages, k_scales, v_scales, tables, lengths,
        # glob_lengths, o, l, m, S, n_q, n_kv, d, d_store, page_size, n_pages,
        # max_pages, page_stride, page_offset, scale_log2e, window,
        # log2_stride, is_local, ws, tickets, splits, walk (3 ints out)
        # (glob_lengths, l, m nullable)
        "fa_paged_decode": [_I, _I] + [_P] * 11 + [_I] * 10 + [_F] + [_I] * 3 + [_P, _P, _I, _P],
        # as fa_paged_decode, with gamma after S
        "fa_paged_multitoken_decode": [_I, _I] + [_P] * 11 + [_I] * 11 + [_F] + [_I] * 3
                                      + [_P, _P, _I, _P],
        # the int4 unpack tool's sites on the decode's tensor-core body: q, k,
        # ks, v, vs, o, tables, lengths, ws, tickets, B, n_kv, G, pages, rows,
        # splits, scale_log2e, walk (3 ints out)
        **{f"fa_{name}": [_P] * 10 + [_I] * 6 + [_F, _P]
           for name in ("exp_int4_int8ref", "exp_int4_s32", "exp_int4_twopage",
                        "exp_int4_fourpage", "exp_int4_int8_2pg", "exp_int4_bitcast")},
        # exp_decode on the decode's tensor-core body: variant, q, k_pages,
        # v_pages, k_scales, v_scales, tables, lengths, o, q_codes, s_int,
        # p_codes, ws, tickets, S, n_kv, G, n_pages, page, max_pages, splits,
        # scale_log2e, walk (3 ints out) (the codes nullable)
        "fa_exp_paged_decode": [_I] + [_P] * 13 + [_I] * 7 + [_F, _P],
        # act, kv, q, k_pages, v_pages, k_scales, v_scales, tables, meta
        # (slot, count, total, start, first_live, page_offset), o, l, m,
        # chunk, n_q, n_kv, d, d_store, page_size, n_pages, max_pages,
        # page_stride, window, log2_stride, is_local, body (1 int out) (l, m
        # nullable)
        "fa_paged_prefill": [_I, _I] + [_P] * 10 + [_I] * 12 + [_P],
    },
    "attention_kernels.cu": {
        # dtype, q, k, v, o, l, m, table, counts, needs, num_steps, block_q,
        # block_kv, B, g, d, v_d, rule
        "fa_flash_fwd": [_I] + [_P] * 9 + [_I] * 7 + [_R],
        # dtype, q, k, v, dout, lse2, delta, dq_acc, dk, dv, table, counts,
        # needs, num_steps, block_q, block_kv, B, g, d, v_d, dk_scale, rule
        "fa_flash_bwd_fused": [_I] + [_P] * 12 + [_I] * 7 + [_F, _R],
        # dtype, q, k, v, dout, lse2, delta, dq, table, counts, needs,
        # num_steps, block_q, block_kv, B, g, d, v_d, scale, body (1 int
        # out), rule
        "fa_flash_bwd_dq": [_I] + [_P] * 10 + [_I] * 7 + [_F, _P, _R],
        # dtype, q, k, v, dout, lse2, delta, dk, dv, table, counts, needs,
        # num_steps, block_q, block_kv, B, g, d, v_d, scale, body (1 int
        # out), rule
        "fa_flash_bwd_dkv": [_I] + [_P] * 11 + [_I] * 7 + [_F, _P, _R],
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
        # dtype, q, k, v, o, l, m, starts, seg, band, sub_q, masked, B, g, d,
        # v_d, body (1 int out), rule
        "fa_window_fwd": [_I] + [_P] * 8 + [_I] * 7 + [_P, _R],
        # dtype, q, k, v, dout, lse2, delta, dq_acc, dk, dv, seg, block_q,
        # block_kv, B, g, d, v_d, dk_scale, rule
        "fa_banded_bwd": [_I] + [_P] * 10 + [_I] * 6 + [_F, _R],
        # dtype, q, k, v, dout, lse2, delta, dq_acc, dk, dv, starts, seg, band,
        # sub_kv, B, g, d, v_d, dk_scale, body (1 int out), rule
        "fa_window_bwd": [_I] + [_P] * 11 + [_I] * 6 + [_F, _P, _R],
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
    """Launch the C entry ``name`` of ``source`` on the device its tensor
    arguments lie on: under that device's guard (the C entries read the
    current device: the shared-memory attribute they set, the SM count) and
    on its current stream, whatever device is current.  A tensor passes as
    its data pointer, None as a null one.  Raises where the tensors lie on
    more than one device or not on a CUDA device, and where the launch
    failed."""
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name} takes tensors on one CUDA device, got tensors on "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = getattr(library(source), name)(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch on {dev}: CUDA error {err}")


def _call(name: str, *args, cp: bool = False) -> None:
    """Launch the C entry ``name`` (``fa_<kernel>``) on its tensors' device
    (``_launch``) and count the launch (under ``<kernel>[cp]`` when
    ``cp``)."""
    kernel = name[3:]
    _launch(KERNEL_SOURCES[kernel], name, *args)
    LAUNCHES[f"{kernel}[cp]" if cp else kernel] += 1


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


class _BodyReport(Mapping):
    """A KV write's ``WALKS`` entry, ``{"body": "vector" or "scalar"}`` of
    its last launch: the launch writes an int at ``ptr``, which is read only
    when the entry is."""

    def __init__(self):
        self._out = ctypes.c_int(-1)
        self.ptr = ctypes.addressof(self._out)

    def __getitem__(self, key):
        if key != "body" or self._out.value < 0:
            raise KeyError(key)
        return "vector" if self._out.value else "scalar"

    def __iter__(self):
        return iter(("body",) if self._out.value >= 0 else ())

    def __len__(self):
        return int(self._out.value >= 0)


WALKS.update((k, _BodyReport()) for k in ("kv_chunk_write", "kv_chunk_write[cp]", "kv_append"))


def kv_write_body(x: torch.Tensor, y: torch.Tensor, cfg) -> str:
    """The body ``kv_chunk_write`` and ``kv_append`` run on K and V ``x``,
    ``y`` (the C rule ``kv_vec``): the vector body at a ``head_dim_store``
    of 128 or 256 (``head_dim_store / 32`` features a lane) when the head
    dim is a multiple of that and every source row starts aligned to a
    lane's load (its features, at most 16 bytes: both bases and every
    stride); else the scalar body."""
    D, size = cfg.head_dim_store, x.element_size()
    vec = D // 32 if D in (128, 256) else 0
    align = min(16, vec * size)
    ok = (vec and x.shape[-1] % vec == 0
          and x.data_ptr() % align == 0 and y.data_ptr() % align == 0
          and all(st * size % align == 0 for st in x.stride()[:-1]))
    return "vector" if ok else "scalar"


def _check_kv(k, v, cfg, dims: int, head_axis: int) -> None:
    if k.dim() != dims or k.shape != v.shape or k.stride() != v.stride() or k.stride(-1) != 1:
        raise ValueError(f"k, v must be {dims}-d views of one shape and strides with unit "
                         f"feature stride, got {tuple(k.shape)} {k.stride()}, "
                         f"{tuple(v.shape)} {v.stride()}")
    if k.shape[head_axis] != cfg.n_kv_heads or k.shape[-1] != cfg.head_dim:
        raise ValueError(f"k/v shape {tuple(k.shape)} for {cfg.n_kv_heads} kv heads of "
                         f"{cfg.head_dim}")


def _check_meta(meta, n: int, like) -> None:
    """A launch's scalars: a contiguous int32 vector of ``n`` on ``like``'s
    device (read by the kernel, never by the host)."""
    if (meta.dtype != torch.int32 or meta.shape != (n,) or not meta.is_contiguous()
            or meta.device != like.device):
        raise ValueError(f"meta must be a contiguous int32 vector of {n} on {like.device}, got "
                         f"{meta.dtype} {tuple(meta.shape)} on {meta.device}")


def kv_chunk_write(cache, cfg, meta, k, v, page_stride=1) -> None:
    """Launch ``kv_chunk_write``: quantize and store the chunk's rows of k, v
    (n_kv, chunk, d; any head and row strides, unit feature stride, the same
    for both) that this shard keeps, and set the slot's length.  ``meta``
    (int32 on the device: slot, start, total, trash_page, page_offset,
    ``kv_cache.chunk_write_meta``) is read by the kernel, which derives the
    kept rows (``kv_cache._owned_rows``) itself; the grid covers the chunk.
    ``kv_write_body`` names the body; the launch's own report is in
    ``WALKS``."""
    _check_kv(k, v, cfg, 3, 0)
    _check_meta(meta, 5, k)
    act, kv = _codes(k.dtype, cache, cfg)
    dims = _cache_dims(cache, cfg)
    cp = page_stride != 1
    head_stride, row_stride, _ = k.stride()
    _call("fa_kv_chunk_write", act, kv, k, v, cache.k_pages, cache.v_pages, cache.k_scales,
          cache.v_scales, cache.page_tables, cache.lengths, meta, k.shape[1], cfg.n_kv_heads,
          head_stride, row_stride, cfg.head_dim, cfg.head_dim_store, *dims, page_stride,
          WALKS["kv_chunk_write[cp]" if cp else "kv_chunk_write"].ptr, cp=cp)


def kv_append(cache, cfg, k_new, v_new, active, glob=None, page_stride=1,
              page_offset=0) -> None:
    """Launch ``kv_append``: the tokens k_new, v_new (S, n_kv, d), or (S, T,
    n_kv, d) for T of them in order (any slot, token and head strides,
    unit feature stride, the same for both), of the active slots whose
    global position ``glob[s] + i`` lies on this shard's pages (every
    position when ``page_stride`` is 1, where ``glob`` may be None), land at
    the slot's length and after; the kernel advances the lengths."""
    if k_new.dim() == 4:
        _check_kv(k_new, v_new, cfg, 4, 2)
        S, T = k_new.shape[:2]
        slot_stride, tok_stride, head_stride, _ = k_new.stride()
    else:
        _check_kv(k_new, v_new, cfg, 3, 1)
        S, T = k_new.shape[0], 1
        slot_stride, head_stride, _ = k_new.stride()
        tok_stride = 0
    act, kv = _codes(k_new.dtype, cache, cfg)
    dims = _cache_dims(cache, cfg)
    if active.dtype != torch.bool or active.shape != (S,) or not active.is_contiguous():
        raise ValueError("active must be a contiguous bool vector of max_seqs entries")
    if page_stride != 1 and (glob is None or glob.dtype != torch.int32 or glob.shape != (S,)
                             or not glob.is_contiguous()):
        raise ValueError("a sharded append needs glob, a contiguous int32 vector of "
                         "max_seqs entries")
    _call("fa_kv_append", act, kv, k_new, v_new, cache.k_pages, cache.v_pages, cache.k_scales,
          cache.v_scales, cache.page_tables, cache.lengths, active, glob, S, T, cfg.n_kv_heads,
          slot_stride, tok_stride, head_stride, cfg.head_dim, cfg.head_dim_store, *dims,
          page_stride, page_offset, WALKS["kv_append"].ptr)


def _lm(q, rows_shape, returning_l_m) -> tuple:
    """float32 (l, m) outputs of ``rows_shape``, or (None, None)."""
    if not returning_l_m:
        return None, None
    return (torch.empty(rows_shape, dtype=torch.float32, device=q.device),
            torch.empty(rows_shape, dtype=torch.float32, device=q.device))


#: the scalar decode body's staging buffers (two of 32 KB) and rows a block
_DEC_STAGE, _DEC_ROWS = 32 * 1024, 16


def _check_smem(what: str, n_bytes: int) -> None:
    """The memory guard of a launch: ``n_bytes`` of shared memory a block."""
    if n_bytes > MAX_SMEM:
        raise ValueError(f"{what} needs {n_bytes} bytes of shared memory a block, more "
                         f"than the {MAX_SMEM} the H100 has")


#: the tensor-core decode body (C ``tc::kDc*``, ``decode_tc.cuh``): keys a
#: stage, ring items, query rows a CTA, Q and widened V row strides (bf16),
#: the largest page merged at once, the rows' scores budget; the H100's SMs
#: and shared memory an SM, whose two waves the split count aims at
DECODE_STAGE_KEYS, _DC_RING, DECODE_CTA_ROWS = 64, 4, 64
_DC_Q_STRIDE, _DC_V_STRIDE, _DC_MAX_MERGE, _DC_SCORE_BUDGET = 132, 136, 512, 72 * 1024
_H100_SMS, _SM_SMEM = 132, 228 * 1024


def decode_body(act_dtype: torch.dtype, cfg) -> str:
    """The body ``paged_decode`` and ``paged_multitoken_decode`` run (the C
    dispatch ``Decode::run``): bf16 activations at ``head_dim_store`` 128 on
    pages of 16, 32 or a multiple of 64 tokens on the tensor cores (every
    payload, any gamma, flat and ``[cp]``); float32 activations (the lossless
    gates'), other stored widths and other page sizes on the scalar body."""
    page = cfg.page_size
    tc = (act_dtype == torch.bfloat16 and cfg.head_dim_store == 128
          and (page % DECODE_STAGE_KEYS == 0 or page in (16, 32)))
    return "tensor-core" if tc else "scalar"


def decode_merge_keys(page: int, rows: int) -> int:
    """Keys the tensor-core decode merges at once for a CTA of ``rows``
    query rows (C ``dc_merge_keys``): a page, as the reference, where the
    rows' float32 scores of a page fit the budget (pages of 64-512); else a
    64-key stage."""
    page_merge = (DECODE_STAGE_KEYS <= page <= _DC_MAX_MERGE
                  and rows * (page + 4) * 4 <= _DC_SCORE_BUDGET)
    return page if page_merge else DECODE_STAGE_KEYS


def _dc_smem(item: int, rows: int, merge: int, cap: int = _DC_MAX_MERGE) -> int:
    """Shared memory of a tensor-core decode CTA of ``rows`` query rows (C
    ``dc_smem``) whose ring items hold ``item`` payload bytes, merging
    ``merge`` keys at once under a cap of ``cap``: a ring of four 64-key
    items (raw payload rows, then 64 K and 64 V scales), Q (rows padded to
    16), two widened bf16 V tiles, the rows' scores of a merge, the V scales
    of the cap, m, l and alpha a padded row, the barriers and the ticket
    flag."""
    padded = -(-rows // 16) * 16
    return (_DC_RING * (item + 2 * DECODE_STAGE_KEYS * 4) + padded * _DC_Q_STRIDE * 2
            + 2 * DECODE_STAGE_KEYS * _DC_V_STRIDE * 2 + rows * (merge + 4) * 4 + cap * 4
            + 3 * padded * 4 + 2 * _DC_RING * 8 + 16)


def decode_tc_smem(cfg, rows: int) -> int:
    """Shared memory of a tensor-core decode CTA of ``rows`` query rows on
    the cache of ``cfg`` (``_dc_smem``)."""
    item = DECODE_STAGE_KEYS // (2 if cfg.is_int4 else 1) * 128 * (
        1 if cfg.quantized else cfg.payload_dtype.itemsize)
    return _dc_smem(item, rows, decode_merge_keys(cfg.page_size, rows))


def _dc_splits(units: int, cells: int, smem: int, two_ctas: bool) -> int:
    """The CTAs a cell's ``units`` merge units are cut into: two waves of
    the H100's SMs at the CTAs an SM holds, by shared memory (1 KB of it the
    system's a CTA) and by registers (``two_ctas``: one row tile of a
    one-byte payload, whose body is capped at 112 registers), at most a unit
    each."""
    per_sm = max(1, min(_SM_SMEM // (smem + 1024), 2 if two_ctas else 1))
    return max(1, min(units, 2 * _H100_SMS * per_sm // max(cells, 1)))


def decode_plan(S: int, n_q: int, gamma: int, cfg, act_dtype=torch.bfloat16) -> dict:
    """The decode launch for ``S`` slots of ``n_q`` heads and ``gamma`` rows,
    from the shapes and the cache's configuration alone (no length is read
    from the device: the kernel finds each slot's pages itself).  ``body``;
    ``splits``, the CTAs a (slot, kv head, row group) cuts its live pages
    into (two waves of the H100's SMs at the CTAs an SM holds, so that
    slots of unequal lengths even out; at most a merge unit each);
    ``ctas``; ``row_groups`` of at most 64 rows; ``smem`` a CTA; the float32
    ``workspace`` of the partials and the ``tickets`` of the in-launch merge
    (tensor-core body)."""
    n_kv, page = cfg.n_kv_heads, cfg.page_size
    rows = n_q // n_kv * gamma
    body = decode_body(act_dtype, cfg)
    if body == "scalar":
        D = cfg.head_dim_store
        groups = -(-rows // _DEC_ROWS)
        block_rows = min(rows, _DEC_ROWS)
        return dict(body=body, splits=1, row_groups=groups, workspace=0, tickets=0,
                    ctas=S * n_kv * groups * -(-D // 1024),
                    smem=2 * _DEC_STAGE + 4 * (block_rows * (D + page) + 2 * page
                                               + 3 * block_rows))
    groups = -(-rows // DECODE_CTA_ROWS)
    units = (cfg.max_pages_per_seq if page >= DECODE_STAGE_KEYS
             else -(-cfg.max_pages_per_seq // (DECODE_STAGE_KEYS // page)))
    cells = S * n_kv * groups
    smem = decode_tc_smem(cfg, min(rows, DECODE_CTA_ROWS))
    splits = _dc_splits(units, cells, smem, rows <= 16 and cfg.quantized)
    return dict(body=body, splits=splits, row_groups=groups, ctas=cells * splits, smem=smem,
                tickets=cells,
                workspace=cells * splits * DECODE_CTA_ROWS * (128 + 2) if splits > 1 else 0)


def _dc_report(kernel: str, walk) -> None:
    """A decode launch's report (C ``walk``: body, splits, CTAs) in ``WALKS``."""
    WALKS[kernel] = dict(body="tensor-core" if walk[0] else "scalar", splits=walk[1],
                         ctas=walk[2])


_SCRATCH = {}


def _decode_scratch(device, workspace: int, tickets: int) -> tuple:
    """The tensor-core decode's float32 workspace and int32 tickets on
    ``device``, kept between launches (the tickets must stay zero there: the
    merging CTA zeroes its own) and grown as a launch needs.  A CUDA graph
    holds the pair it captured (``scratch_in_use``), so growing for another
    launch never frees it; growing during a capture raises, since the
    graph's pool would own the new pair (the capture's eager first run
    sizes it)."""
    key = str(device)
    ws, tk = _SCRATCH.get(key, (None, None))
    grow_ws = ws is None or ws.numel() < max(workspace, 1)
    grow_tk = tk is None or tk.numel() < max(tickets, 1)
    if (grow_ws or grow_tk) and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the decode's scratch grew during a CUDA graph capture: run the "
                           "step once before capturing it")
    if grow_ws:
        ws = torch.empty(max(workspace, 1), dtype=torch.float32, device=device)
    if grow_tk:
        tk = torch.zeros(max(tickets, 1), dtype=torch.int32, device=device)
    _SCRATCH[key] = ws, tk
    return ws, tk


def scratch_in_use() -> list:
    """The decode scratch tensors now kept, which a graph captured now reads."""
    return [t for pair in _SCRATCH.values() for t in pair]


def _decode(entry, q, cache, cfg, S, gamma, scale_log2e, rule, returning_l_m, page_stride,
            page_offset, global_lengths):
    """Checks, outputs, scratch and the launch shared by the two decode
    entries; records the body, splits and CTAs the launch reports in
    ``WALKS``."""
    n_q, d = q.shape[-2], q.shape[-1]
    act, kv = _codes(q.dtype, cache, cfg)
    dims = _cache_dims(cache, cfg)
    D, page = cfg.head_dim_store, cfg.page_size
    if D % LANE or D * (1 if cfg.quantized else cfg.payload_dtype.itemsize) > _DEC_STAGE:
        raise ValueError(f"the decode kernels take a head_dim_store that is a multiple of "
                         f"{LANE} whose stored row fits a {_DEC_STAGE}-byte stage, got {D}")
    plan = decode_plan(S, n_q, gamma, cfg, q.dtype)
    _check_smem(f"decode at head_dim_store {D}, page {page}", plan["smem"])
    if global_lengths is not None and (global_lengths.dtype != torch.int32
                                       or not global_lengths.is_contiguous()):
        raise TypeError("global_lengths must be a contiguous int32 vector")
    o = torch.empty_like(q)
    l, m = _lm(q, q.shape[:-1], returning_l_m)
    ws, tickets = _decode_scratch(q.device, plan["workspace"], plan["tickets"])
    walk = (ctypes.c_int * 3)()
    cp = returning_l_m or page_stride != 1 or global_lengths is not None
    _call(entry, act, kv, q, cache.k_pages, cache.v_pages, cache.k_scales, cache.v_scales,
          cache.page_tables, cache.lengths, global_lengths, o, l, m, S,
          *(() if entry == "fa_paged_decode" else (gamma,)), n_q, cfg.n_kv_heads, d, D, *dims,
          page_stride, page_offset, float(scale_log2e), *_rule_args(rule), ws, tickets,
          plan["splits"], walk, cp=cp)
    _dc_report(entry[3:] + ("[cp]" if cp else ""), walk)
    return (o, l, m) if returning_l_m else o


def paged_decode(q, cache, cfg, scale_log2e, rule, returning_l_m=False, page_stride=1,
                 page_offset=0, global_lengths=None):
    """Launch ``paged_decode``: q (S, n_q, d) -> o of the same shape, or
    (o, l, m) with l, m float32 (S, n_q).  ``decode_body`` names the body;
    the launch's report (body, splits, CTAs) is in ``WALKS``."""
    return _decode("fa_paged_decode", q, cache, cfg, q.shape[0], 1, scale_log2e, rule,
                   returning_l_m, page_stride, page_offset, global_lengths)


def paged_multitoken_decode(q, cache, cfg, scale_log2e, rule, returning_l_m=False,
                            page_stride=1, page_offset=0, global_lengths=None):
    """Launch ``paged_multitoken_decode``: q (S, gamma, n_q, d) -> o of the
    same shape (and l, m (S, gamma, n_q)); draft i of a slot sits at
    position ``length - gamma + i`` (the global length, where given)."""
    return _decode("fa_paged_multitoken_decode", q, cache, cfg, q.shape[0], q.shape[1],
                   scale_log2e, rule, returning_l_m, page_stride, page_offset, global_lengths)


def paged_prefill(qs, cache, cfg, meta, rule, returning_l_m=False, page_stride=1):
    """Launch ``paged_prefill``: prescaled q (chunk, n_q, d) -> o, or (o, l,
    m) with l, m float32 (chunk, n_q).  ``meta`` (int32 on the device: slot,
    local page count, total, start, first live local page, page offset;
    ``prefill.prefill_meta``) is read by the kernel, which finds the slot's
    table row itself; the grid follows the chunk.  ``prefill_body`` names
    the body; the launch's own report is in ``WALKS``."""
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
    _check_meta(meta, 6, qs)
    o = torch.empty_like(qs)
    l, m = _lm(qs, (chunk, n_q), returning_l_m)
    body = ctypes.c_int(0)
    cp = returning_l_m or page_stride != 1
    _call("fa_paged_prefill", act, kv, qs, cache.k_pages, cache.v_pages, cache.k_scales,
          cache.v_scales, cache.page_tables, meta, o, l, m, chunk, n_q, cfg.n_kv_heads, d,
          cfg.head_dim_store, *dims, page_stride, *_rule_args(rule), ctypes.byref(body), cp=cp)
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
#: any other rule: its check through a granule mask (C ``kCustom``)
CUSTOM_KIND = 3
#: the custom mask's granules (C ``kMaskGranule``) and their index codes
MASK_GRANULE, MASK_ALL, MASK_NONE = 64, -1, -2


def custom_mask(pack, rule) -> tuple:
    """A custom rule's visibility on the kernels' terms (C ``custom_visible``):
    ``index`` int32 (q granules, k granules) of 64 x 64 positions, each
    ``MASK_ALL``, ``MASK_NONE`` or the granule's number in ``bits``, and
    ``bits`` uint64 (granules, 64), one word a query row with bit ``k % 64``.
    The rule's ``tile_live`` / ``tile_fully_visible`` class the granules as
    the schedule does (dead: none, fully visible: all); only the partial
    ones call ``check``, with numpy order coordinates and flattened orders as
    ``build_tile_mask`` gives them, so memory grows with the partial
    granules.  Positions past a sequence's length are left to the kernels'
    bounds test."""
    G = MASK_GRANULE
    q_coords, q_flat = sequence_orders(pack.q, pack.reference_shape)
    k_coords, k_flat = sequence_orders(pack.k, pack.reference_shape)
    q_len, k_len = q_flat.size, k_flat.size
    sched = build_schedule(pack, rule, G, G)
    index = np.where(sched.live & ~sched.partial, MASK_ALL, MASK_NONE).astype(np.int32)
    words = []
    for qi in np.flatnonzero(sched.partial.any(axis=1)):
        qs = slice(qi * G, min(qi * G + G, q_len))
        vis = np.broadcast_to(np.asarray(rule.check(
            pack, [c[qs, None] for c in q_coords], [c[None, :] for c in k_coords],
            q_flat[qs, None], k_flat[None, :]), dtype=bool), (qs.stop - qs.start, k_len))
        for ki in np.flatnonzero(sched.partial[qi]):
            tile = vis[:, ki * G:ki * G + G]
            if tile.all():
                index[qi, ki] = MASK_ALL
            elif not tile.any():
                index[qi, ki] = MASK_NONE
            else:
                full = np.zeros((G, G), dtype=bool)
                full[:tile.shape[0], :tile.shape[1]] = tile
                index[qi, ki] = len(words)
                words.append(np.packbits(full, axis=1, bitorder="little").view("<u8")[:, 0])
    bits = np.stack(words) if words else np.zeros((0, G), dtype="<u8")
    return index, bits


def fa_rule(pack, rule, device=None) -> FaRule:
    """The kernels' view of a sync pack and mask rule.  Full, causal and
    local rules are kinds 0-2; any other rule that defines ``check``,
    ``tile_live`` and ``tile_fully_visible`` is kind 3, whose granule mask
    (``custom_mask``) is uploaded to ``device`` once per (pack, rule,
    device) and held by the returned struct's pointers."""
    kind = _RULE_KIND.get(type(rule), CUSTOM_KIND)
    if kind == CUSTOM_KIND and any(getattr(type(rule), name) is getattr(MaskRule, name)
                                   for name in ("check", "tile_live", "tile_fully_visible")):
        raise NotImplementedError(f"{type(rule).__name__} must define check, tile_live and "
                                  f"tile_fully_visible for the kernels' schedule and mask")
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
    if kind == CUSTOM_KIND:
        if device is None:
            raise ValueError("a custom rule's mask needs the device it is uploaded to")
        index, bits = device_tables(
            ("custom_mask", pack, rule),
            lambda: [a.view(np.int32) for a in custom_mask(pack, rule)], device)
        r.mask_cols = index.shape[1]
        r.mask_index, r.mask_bits = index.data_ptr(), bits.data_ptr()
    return r


_TABLES = {}


def device_tables(key, arrays, device) -> tuple:
    """The int32 ``arrays`` (a schedule's tables, band segments or starts, a
    custom rule's mask) as tensors on ``device``, uploaded once per ``key``
    (pack, rule, blocks, route); ``arrays`` may be a function that returns
    them, called on the first use of a key only.  A first use during a CUDA
    graph's capture raises: the eager call before a capture uploads them."""
    key = (key, str(device))
    tabs = _TABLES.get(key)
    if tabs is None:
        if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a kernel's tables were first needed during a CUDA graph "
                               "capture: run the step once before capturing it")
        tabs = tuple(torch.from_numpy(np.ascontiguousarray(t, np.int32)).to(device)
                     for t in (arrays() if callable(arrays) else arrays))
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
    """Shared memory of ``window_fwd``'s scalar body (``band_kernels.cu``):
    the query tile (32 rows), one K or V tile (64, 32 or 16 rows by the
    head-dim class) and the whole band's float32 scores.  The route gates on
    it for every dtype, as the JAX package gates on its VMEM budget; the
    tensor-core body takes ``tc_fwd_smem``, whatever the band."""
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
    """The body ``flash_fwd``, ``banded_fwd``, ``resident_fwd`` and
    ``window_fwd`` run (the C dispatches ``fwd_any`` and ``window_fwd_any``,
    both under ``fwd_on_tc``): bf16 and fp16 at d <= ``TC_MAX_D`` on the
    tensor cores, float32 (TF32 would not hold its limit) and wider heads on
    the scalar body."""
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
    """The body every backward runs: ``flash_bwd_fused``, ``banded_bwd``,
    ``window_bwd``, ``flash_bwd_qouter`` and the split pair ``flash_bwd_dq``
    and ``flash_bwd_dkv`` (the C dispatches ``bwd_fused_any``,
    ``window_bwd_any``, ``bwd_qouter_any``, ``bwd_dq_any`` and
    ``bwd_dkv_any``, all under ``tc_bwd_takes``): bf16 and fp16 with
    max(d, v_d) <= 128 on the tensor cores, everything else, and an empty q
    or k, on the scalar body.  The
    split pair's tensor-core bodies are the q-outer body without dK and dV
    and the kv-outer body without dQ."""
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
#: its dQ-only form, the tensor-core ``flash_bwd_dq``: no T(P) and T(dS)
#: tiles, no partials (C ``kQoDqSmem``)
QOUTER_DQ_TC_SMEM = QOUTER_TC_SMEM - 2 * 128 * 128 - 2 * 64 * 128 * 4


def _check_bwd_smem(name: str, dtype: torch.dtype, d: int, v_d: int, q_len: int = 1,
                    k_len: int = 1) -> None:
    """Every backward, on the body it runs (the kv-outer ``flash_bwd_dkv``
    on ``TC_BWD_SMEM``'s layout; the scalar ``flash_bwd_dq`` keeps one
    score tile)."""
    if bwd_body(dtype, d, v_d, q_len, k_len) == "tensor-core":
        n_bytes = {"flash_bwd_qouter": QOUTER_TC_SMEM,
                   "flash_bwd_dq": QOUTER_DQ_TC_SMEM}.get(name, TC_BWD_SMEM)
    else:
        n_bytes = bwd_smem(d, v_d, 1 if name == "flash_bwd_dq" else 2)
    _check_smem(f"{name} at d {d}, v_d {v_d}", n_bytes)


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
    _launch("attention_kernels.cu", "fa_tc_tile_check", _DTYPE_CODE[a.dtype], a, k, v, s, o)
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
            *(t for t, _ in shapes), *outs)
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
    return [table, counts, needs, table.shape[1],
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
    _call("fa_flash_fwd", code, q_scaled, k, v, o, l, m, *_sched_args(tables, block_q, block_kv),
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
    _call("fa_flash_bwd_fused", code, q_scaled, k, v, do, lse2, delta, dq_acc, dk, dv,
          *_sched_args(tables_t, block_q, block_kv), B, B // k.shape[0], d, v.shape[2],
          float(dk_scale), ctypes.byref(rule_c))
    return dq_acc, dk, dv


def flash_bwd_dq(q_scaled, k, v, do, lse2, delta, rule_c: FaRule, tables, block_q, block_kv,
                 scale):
    """Launch ``flash_bwd_dq`` (q-outer schedule); returns dq (B, q_len, d).
    ``bwd_body`` names the body; the launch's own report is in ``WALKS``."""
    code = _check_attn(q_scaled, k, v, rule_c, do, (lse2, delta))
    B, q_len, d = q_scaled.shape
    _check_bwd_smem("flash_bwd_dq", q_scaled.dtype, d, v.shape[2], q_len, k.shape[1])
    dq = torch.empty_like(q_scaled)
    body = ctypes.c_int(0)
    _call("fa_flash_bwd_dq", code, q_scaled, k, v, do, lse2, delta, dq,
          *_sched_args(tables, block_q, block_kv), B, B // k.shape[0], d, v.shape[2], float(scale),
          ctypes.byref(body), ctypes.byref(rule_c))
    _body("flash_bwd_dq", body)
    return dq


def flash_bwd_dkv(q, k_scaled, v, do, lse2, delta, rule_c: FaRule, tables_t, block_q,
                  block_kv, scale):
    """Launch ``flash_bwd_dkv`` (transposed schedule): unscaled q, prescaled
    k; returns dk (B_kv, k_len, d) and dv.  ``bwd_body`` names the body; the
    launch's own report is in ``WALKS``."""
    code = _check_attn(q, k_scaled, v, rule_c, do, (lse2, delta))
    B, q_len, d = q.shape
    _check_bwd_smem("flash_bwd_dkv", q.dtype, d, v.shape[2], q_len, k_scaled.shape[1])
    dk, dv = torch.empty_like(k_scaled), torch.empty_like(v)
    body = ctypes.c_int(0)
    _call("fa_flash_bwd_dkv", code, q, k_scaled, v, do, lse2, delta, dk, dv,
          *_sched_args(tables_t, block_q, block_kv), B, B // k_scaled.shape[0], d, v.shape[2],
          float(scale), ctypes.byref(body), ctypes.byref(rule_c))
    _body("flash_bwd_dkv", body)
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
    _call("fa_banded_fwd", code, q_scaled, k, v, o, l, m, seg, block_q, block_kv, B,
          B // k.shape[0], d, v_d, ctypes.byref(rule_c))
    return o, l, m


def _check_window(name: str, band: int, sub: int, seg, n_tiles: int) -> None:
    if band % LANE or sub % LANE or band < LANE or sub < LANE:
        raise ValueError(f"{name} takes lane-aligned bands and sub-blocks, got band {band}, "
                         f"sub {sub}")
    if seg.dtype != torch.int32 or not seg.is_contiguous() or tuple(seg.shape) != (n_tiles, 4):
        raise ValueError(f"{name}: seg must be contiguous int32 ({n_tiles}, 4), got "
                         f"{seg.dtype} {tuple(seg.shape)}")


def window_fwd(q_scaled, k, v, rule_c: FaRule, starts, seg, band, sub_q, masked):
    """Launch ``window_fwd``: one key band ``[starts[i], + band)`` per
    ``sub_q`` query rows (``starts`` int32 on the card; the scalar body's
    walk), ``seg`` the bands' live blocks as the banded walk's four ints a
    128-row tile (``ops/forward.py::window_segments``; the tensor-core
    body's);
    ``masked`` false only where every element of every band is visible.
    ``fwd_body`` names the body; the launch's own report is in ``WALKS``."""
    code = _check_attn(q_scaled, k, v, rule_c)
    B, q_len, d = q_scaled.shape
    v_d = v.shape[2]
    _check_window("window_fwd", band, sub_q, seg, -(-q_len // LANE))
    _check_smem(f"window_fwd at band {band}, d {d}, v_d {v_d}",
                tc_fwd_smem(d, v_d) if fwd_body(q_scaled.dtype, d, v_d) == "tensor-core"
                else window_fwd_smem(band, d, v_d))
    o = torch.empty((B, q_len, v_d), dtype=q_scaled.dtype, device=q_scaled.device)
    l = torch.empty((B, q_len), dtype=torch.float32, device=q_scaled.device)
    m = torch.empty_like(l)
    body = ctypes.c_int(0)
    _call("fa_window_fwd", code, q_scaled, k, v, o, l, m, starts, seg, band, sub_q,
          int(bool(masked)), B, B // k.shape[0], d, v_d, ctypes.byref(body), ctypes.byref(rule_c))
    _body("window_fwd", body)
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
    _call("fa_banded_bwd", code, q_scaled, k, v, do, lse2, delta, dq_acc, dk, dv, seg_t, block_q,
          block_kv, B, B // k.shape[0], d, v.shape[2], float(dk_scale), ctypes.byref(rule_c))
    return dq_acc, dk, dv


def window_bwd(q_scaled, k, v, do, lse2, delta, rule_c: FaRule, starts_t, seg_t, band,
               sub_kv, dk_scale):
    """Launch ``window_bwd``: one query band ``[starts_t[i], + band)`` per
    ``sub_kv`` key rows, ``seg_t`` the bands' live blocks as the banded
    walk's four ints a 128-row kv tile; returns the unscaled float32 dQ
    accumulator, dk, dv.  ``bwd_body`` names the body; the launch's own
    report is in ``WALKS``."""
    code = _check_attn(q_scaled, k, v, rule_c, do, (lse2, delta))
    B, q_len, d = q_scaled.shape
    k_len = k.shape[1]
    _check_window("window_bwd", band, sub_kv, seg_t, -(-k_len // LANE))
    _check_bwd_smem("window_bwd", q_scaled.dtype, d, v.shape[2], q_len, k_len)
    dq_acc = torch.zeros((B, q_len, d), dtype=torch.float32, device=q_scaled.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    body = ctypes.c_int(0)
    _call("fa_window_bwd", code, q_scaled, k, v, do, lse2, delta, dq_acc, dk, dv, starts_t, seg_t,
          band, sub_kv, B, B // k.shape[0], d, v.shape[2], float(dk_scale), ctypes.byref(body),
          ctypes.byref(rule_c))
    _body("window_bwd", body)
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
    _call("fa_resident_fwd", code, q_scaled, k, v, o, l, m, seg, next_item, block_q, block_kv, B,
          B // k.shape[0], d, v_d, walk, ctypes.byref(rule_c))
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
    _call("fa_flash_bwd_qouter", code, q_scaled, k, v, do, lse2, delta, dq, dk_acc, dv_acc,
          *_sched_args(tables, block_q, block_kv), B, B // k.shape[0], d, v_d, float(scale),
          ctypes.byref(body), ctypes.byref(rule_c))
    _body("flash_bwd_qouter", body)
    return dq, dk_acc, dv_acc


# ---- the experiment tools' kernels (experiments/) ----

#: the ladder's rungs in the order of exp_vpu_attrib's main (the kernel's codes)
LADDER_RUNGS = ("prod", "nomax", "noexp", "nosum", "bf16exp", "mm")
#: exp_decode's strategies (the kernel's codes), each a compiled policy of
#: the decode's tensor-core body (C ``DcUnpack``): ``current`` dequantizes K
#: and V in bf16 (``kDcDequant``), ``postscale`` is the serving decode's int8
#: instantiation, ``int8mm`` takes integer products (``kDcS8``); a ``_t``
#: suffix names the scale layout only
DECODE_VARIANTS = ("current", "postscale", "int8mm")
#: the pages per step of each exp_int4_unpack kernel: its compiled merge
#: width (npg pages before a softmax update; the C policy's cap is npg x 256
#: keys)
INT4_NPG = {"exp_int4_int8ref": 1, "exp_int4_int8_2pg": 2, "exp_int4_s32": 1,
            "exp_int4_twopage": 2, "exp_int4_fourpage": 4, "exp_int4_bitcast": 1}
#: the six sites on the decode's tensor-core body (``decode_tc.cuh``) and
#: each one's compiled unpack method (C ``DcUnpack``): the int8 sites the
#: serving decode's ``permute``; ``exp_int4_bitcast`` also accumulates even
#: and odd keys apart
INT4_TC_UNPACK = {"exp_int4_int8ref": "permute", "exp_int4_s32": "shift",
                  "exp_int4_twopage": "shift", "exp_int4_fourpage": "shift",
                  "exp_int4_int8_2pg": "permute", "exp_int4_bitcast": "magic"}


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
    _call(f"fa_{name}", *head, q, k, v, o, next_item, B, S, d, *tail, walk)
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
    _call("fa_exp_resident_fwd", q_scaled, k, v, o, next_item, B, S, d, block_q, block_kv, walk)
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


def _tool_pack(kernel: str) -> int:
    """Keys a stored row of an exp_int4_unpack site: 1 (int8), 2 (int4)."""
    return 1 if kernel.startswith("exp_int4_int8") else 2


def exp_int4_plan(kernel: str, B: int, n_kv: int, G: int, pages: int, rows: int) -> dict:
    """The launch of one of exp_int4_unpack's sites (``INT4_TC_UNPACK``) on
    the decode's tensor-core body (C ``decode_tc_tool``) for B rows of G
    query rows a kv head over ``pages`` pages of ``rows`` byte rows (int8:
    ``rows`` keys; int4: 2 ``rows``), from the shapes alone: ``body``;
    ``merge_keys``, npg pages; ``splits``, the CTAs a (row, kv head) cuts
    its merges into (``decode_plan``'s rule); ``ctas``; ``smem`` a CTA (a
    ring item holds 64 keys' payload); the float32 ``workspace`` of the
    partials (both accumulators for bitcast) and the ``tickets`` of the
    in-launch merge."""
    npg, pack = INT4_NPG[kernel], _tool_pack(kernel)
    cells = B * n_kv
    smem = _dc_smem(DECODE_STAGE_KEYS // pack * 128, G, npg * pack * rows, npg * 256)
    splits = _dc_splits(-(-pages // npg), cells, smem, True)
    acc = 2 if kernel == "exp_int4_bitcast" else 1
    return dict(body="tensor-core", merge_keys=npg * pack * rows, splits=splits,
                ctas=cells * splits, smem=smem, tickets=cells,
                workspace=cells * splits * DECODE_CTA_ROWS * (acc * 128 + 2) if splits > 1 else 0)


_IDENTITY = {}


def _identity_table(device, B: int, pages: int, page: int) -> tuple:
    """(tables (B, pages) int32, every row the identity; lengths (B,) int32
    of ``pages * page``) on ``device``, made once for each shape."""
    key = (str(device), B, pages, page)
    if key not in _IDENTITY:
        _IDENTITY[key] = (torch.arange(pages, dtype=torch.int32, device=device)
                          .expand(B, pages).contiguous(),
                          torch.full((B,), pages * page, dtype=torch.int32, device=device))
    return _IDENTITY[key]


def exp_int4_decode(kernel: str, q, k, ks, v, vs, scale_log2e: float):
    """Launch one of exp_int4_unpack's kernels (``INT4_NPG``): q (B, n_kv,
    G, 128) bf16 over the K/V every row shares, k, v (n_kv, pages, rows,
    128) int8 (int4: nibble pairs), scales (n_kv, pages, pack, rows).  Each
    runs the decode's tensor-core body on an identity page table
    (``exp_int4_plan``; G <= 16, pages of a multiple of 64 keys; any other
    shape raises), the launch's report (body, splits, CTAs) in ``WALKS``."""
    _check_exp(q, dtype=torch.bfloat16)
    _check_exp(k, v, dtype=torch.int8)
    _check_exp(ks, vs, dtype=torch.float32)
    B, n_kv, G, d = q.shape
    _, pages, rows, _ = k.shape
    pack = _tool_pack(kernel)
    if (d != 128 or k.shape != (n_kv, pages, rows, d) or v.shape != k.shape
            or ks.shape != (n_kv, pages, pack, rows) or vs.shape != ks.shape
            or pages % INT4_NPG[kernel]):
        raise ValueError(f"{kernel}: inconsistent shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, scales {tuple(ks.shape)} (d 128, pages a "
                         f"multiple of {INT4_NPG[kernel]})")
    if G > 16 or (pack * rows) % DECODE_STAGE_KEYS:
        raise ValueError(f"{kernel} takes G <= 16 query rows a kv head and pages of a multiple "
                         f"of {DECODE_STAGE_KEYS} keys, got G {G}, {pack * rows} keys")
    o = torch.empty_like(q)
    plan = exp_int4_plan(kernel, B, n_kv, G, pages, rows)
    _check_smem(f"{kernel} at G {G}, page {pack * rows}", plan["smem"])
    ws, tickets = _decode_scratch(q.device, plan["workspace"], plan["tickets"])
    tables, lengths = _identity_table(q.device, B, pages, pack * rows)
    walk = (ctypes.c_int * 3)()
    _call(f"fa_{kernel}", q, k, ks, v, vs, o, tables, lengths, ws, tickets, B, n_kv, G, pages,
          rows, plan["splits"], float(scale_log2e), walk)
    _dc_report(kernel, walk)
    return o


def exp_decode_plan(variant: str, S: int, n_q: int, n_kv: int, page: int,
                    max_pages: int) -> dict:
    """The launch of one of exp_decode's strategies (``DECODE_VARIANTS``) on
    the decode's tensor-core body (C ``decode_tc_exp``) for S slots of
    ``n_q`` heads over an int8 cache of ``n_kv`` kv heads, pages of ``page``
    keys, ``max_pages`` a slot, from the shapes alone (no length is read):
    ``body``; ``splits``, the CTAs a (slot, kv head) cuts its live pages into
    (``decode_plan``'s rule; one for ``int8mm``, whose p codes take each
    page's running maximum: its pages in order in one CTA); ``ctas``;
    ``smem`` a CTA; the float32 ``workspace`` and the ``tickets``."""
    cells = S * n_kv
    smem = _dc_smem(DECODE_STAGE_KEYS * 128, n_q // n_kv, page)
    splits = 1 if variant == "int8mm" else _dc_splits(max_pages, cells, smem, True)
    return dict(body="tensor-core", splits=splits, ctas=cells * splits, smem=smem,
                tickets=cells,
                workspace=cells * splits * DECODE_CTA_ROWS * (128 + 2) if splits > 1 else 0)


def exp_paged_decode(variant: str, q, k_pages, v_pages, k_scales, v_scales, tables, lengths,
                     scale_log2e: float, codes: bool = False):
    """Launch ``exp_paged_decode`` (``DECODE_VARIANTS``) on the decode's
    tensor-core body (``exp_decode_plan``): q (S, n_q, 128) bf16 over an
    int8 paged cache, G = n_q / n_kv <= 16, pages of 64-512 keys (a
    multiple of 64; any other shape raises), lengths at most ``max_pages``
    pages, scales (n_kv, n_pages, 1, page) or (n_kv, n_pages, page, 1).
    Returns o, or with ``codes`` (int8mm) (o, q codes (S, n_q, 128) int8,
    integer scores (S, n_q, max_pages * page) int32, p codes (S, n_q,
    max_pages * page) int8), zero past each slot's live pages.  The launch's
    report (body, splits, CTAs) is in ``WALKS``."""
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
    if n_q // n_kv > 16 or page % DECODE_STAGE_KEYS or not DECODE_STAGE_KEYS <= page <= 512:
        raise ValueError(f"exp_paged_decode takes G <= 16 query rows a kv head and pages of "
                         f"64-512 keys, a multiple of {DECODE_STAGE_KEYS}, got G "
                         f"{n_q // n_kv}, {page} keys")
    if codes and variant != "int8mm":
        raise ValueError("only the int8mm variant has codes")
    o = torch.empty_like(q)
    extra = (torch.zeros((S, n_q, d), dtype=torch.int8, device=q.device),
             torch.zeros((S, n_q, max_pages * page), dtype=torch.int32, device=q.device),
             torch.zeros((S, n_q, max_pages * page), dtype=torch.int8, device=q.device)
             ) if codes else (None, None, None)
    plan = exp_decode_plan(variant, S, n_q, n_kv, page, max_pages)
    _check_smem(f"exp_paged_decode at G {n_q // n_kv}, page {page}", plan["smem"])
    ws, tickets = _decode_scratch(q.device, plan["workspace"], plan["tickets"])
    walk = (ctypes.c_int * 3)()
    _call("fa_exp_paged_decode", DECODE_VARIANTS.index(variant), q, k_pages, v_pages, k_scales,
          v_scales, tables, lengths, o, *extra, ws, tickets, S, n_kv, n_q // n_kv, n_pages, page,
          max_pages, plan["splits"], float(scale_log2e), walk)
    _dc_report("exp_paged_decode", walk)
    return (o, *extra) if codes else o
