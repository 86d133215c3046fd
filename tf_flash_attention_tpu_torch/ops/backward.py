"""Flash-attention backward (PyTorch port of ``ops/backward.py``).

``flash_backward`` recomputes ``P`` from the saved ``(l, m)`` and returns
``(dQ, dK, dV)``.  The stats prep is one elementwise torch pass, as it is
one XLA pass in the JAX package (``backward.py:686-703``):
``D = rowsum(dO ∘ O)`` and ``lse2 = m·log2e + log2 l`` (``3e38`` where
``l = 0``, which zeroes every ``P`` entry of a dead row).

Routes (the ``fused`` argument, as in the JAX package):

* ``"kv"`` — a fused kv-outer kernel (5 products per tile, dQ accumulated
  with atomics or TMA reduce-adds into a float32 global buffer, then scaled
  and cast in one elementwise pass; its dQ varies in the last bits from run
  to run; ``native.bwd_body`` names the body it runs).  As
  in the JAX package (``backward.py:809-978``) the schedule picks which:
  ``window_bwd`` (``FA_WINDOW_BWD``) for one lane-aligned query band per
  key sub-block, else ``banded_bwd`` (``FA_BANDED_BWD``) where the
  transposed schedule is banded, else the table kernel
  ``flash_bwd_fused``.  The TPU routes also require q/dO to fit a VMEM
  residency budget, which has no counterpart on the card;
* ``False`` — the split pair ``flash_bwd_dq`` + ``flash_bwd_dkv``
  (deterministic; the dK/dV kernel takes a prescaled **k**);
* ``None`` — auto: ``"kv"``, or ``False`` where ``FA_FUSED_BWD=0`` (the
  JAX package's switch).  The TPU policy leaves the fused route when the
  whole-sequence dQ accumulator outgrows 24 MiB of VMEM, or for grouped
  runs with wide kv blocks (a TPU pipeline measurement).  On the card the
  accumulator is device memory the size of q in float32, beside tensors
  the caller already holds, so no size forces the split pair; and at the
  training slice on an H100 the fused route measured faster than the pair
  (``PERF.md``).  So auto stays fused;
* ``"q"`` (or ``True`` with ``g > 2``) — the q-outer fused kernel
  ``flash_bwd_qouter``: dQ in registers (deterministic), dK and dV added
  with atomics into float32 buffers, then scaled and cast.  As in the JAX
  package, only a direct call with this argument reaches it.

Tensors on the CPU take the plain version ``_flash_backward_plain`` of
the chosen family (fused or split).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from .. import native
from ..block_sizes import LANE, BlockConfig, pad_to
from ..mask_rules import MaskRule
from ..schedule import build_schedule, window_band_table_t
from ..sync_modes import SyncPack
from .forward import Route, dense_mask, env_on, pick_window, prescale
from .kernel_common import INV_LOG2E, LOG2E, NEG_INF_F32

__all__ = ["flash_backward", "backward_route"]


def backward_stats(o, l, m, do):
    """``(lse2, D)``, each (B, q_len) float32."""
    delta = (do.float() * o.float()).sum(dim=-1)
    l32 = l.float()
    lse2 = torch.where(l32 > 0.0,
                       m.float() * LOG2E + torch.log2(torch.clamp(l32, min=1e-37)),
                       torch.full_like(l32, 3e38))
    return lse2.contiguous(), delta.contiguous()


def _flash_backward_plain(q, k, v, do, lse2, delta, pack: SyncPack, rule: MaskRule,
                          scale: float, fused):
    """Plain version of the backward kernels: dense, in float32.  The fused
    kernels and the dQ kernel recompute ``P`` from prescaled q; the dK/dV
    kernel from prescaled k, so for half inputs the split route rounds a
    different operand, and its plain version does the same.  As the JAX
    kernels do (``_fused_kernel``, ``_dq_kernel``, ``_dkv_kernel``), p is
    rounded to the input type before dV, and dS (from the float32 p) before
    dK and dQ; for float32 inputs the rounding is the identity."""
    g = q.shape[0] // k.shape[0]
    mask = dense_mask(pack, rule, q.device)

    def probs(qf, kf):
        s = torch.matmul(qf, kf.repeat_interleave(g, dim=0).transpose(-1, -2))
        if mask is not None:
            s = s.masked_fill(~mask, NEG_INF_F32)
        return torch.exp2(s - lse2[..., None])

    def rounded(x):
        return x.to(q.dtype).float()

    def group_sum(x):
        return x.reshape(k.shape[0], g, *x.shape[1:]).sum(dim=1)

    q_scaled = prescale(q, scale).float()
    vf = v.float().repeat_interleave(g, dim=0)
    dof = do.float()
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    p = probs(q_scaled, k.float())
    ds = rounded(p * (dp - delta[..., None]))
    dq = torch.matmul(ds, k.float().repeat_interleave(g, dim=0)) * scale
    if fused:
        dk = torch.matmul(ds.transpose(-1, -2), q_scaled) * INV_LOG2E
    else:
        p = probs(q.float(), prescale(k, scale).float())
        ds = rounded(p * (dp - delta[..., None]))
        dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(rounded(p).transpose(-1, -2), dof)
    return dq.to(q.dtype), group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


@functools.lru_cache(maxsize=256)
def _backward_route(pack: SyncPack, rule: MaskRule, config: BlockConfig, fused,
                    window_on: bool, banded_on: bool) -> tuple:
    q_len, k_len = math.prod(pack.q.shape), math.prod(pack.k.shape)
    block_qf = min(config.block_q_dkv, pad_to(q_len, LANE))
    block_kvf = min(config.block_kv_dkv, pad_to(k_len, LANE))
    if fused == "q":
        sched = build_schedule(pack, rule, block_qf, block_kvf, use_native=False)
        return (Route("flash_bwd_qouter", block_qf, block_kvf,
                      (sched.kv_table, sched.kv_counts, sched.needs_mask)),)
    if not fused:
        block_q = min(config.block_q_dq, pad_to(q_len, LANE))
        block_kv = min(config.block_kv_dq, pad_to(k_len, LANE))
        sched = build_schedule(pack, rule, block_q, block_kv, use_native=False)
        sched_t = build_schedule(pack, rule, block_qf, block_kvf, use_native=False).transpose()
        return (Route("flash_bwd_dq", block_q, block_kv,
                      (sched.kv_table, sched.kv_counts, sched.needs_mask)),
                Route("flash_bwd_dkv", block_qf, block_kvf,
                      (sched_t.kv_table, sched_t.kv_counts, sched_t.needs_mask)))
    q_pad, k_pad = pad_to(q_len, block_qf), pad_to(k_len, block_kvf)
    if window_on:
        picked = pick_window(
            lambda sk: window_band_table_t(pack, rule, sk, q_len, k_len, q_pad, k_pad),
            (512, 256, 128), block_kvf, k_pad)
        if picked is not None:
            sub_kv, (starts, band, _, _) = picked
            return (Route("window_bwd", block_qf, block_kvf, (starts,), band, sub_kv),)
    sched_t = build_schedule(pack, rule, block_qf, block_kvf, use_native=False).transpose()
    if banded_on:
        seg_t = sched_t.banded_segments()
        if seg_t is not None:
            return (Route("banded_bwd", block_qf, block_kvf, (seg_t,)),)
    return (Route("flash_bwd_fused", block_qf, block_kvf,
                  (sched_t.kv_table, sched_t.kv_counts, sched_t.needs_mask)),)


def backward_route(pack: SyncPack, rule: MaskRule, config: BlockConfig, g: int,
                   fused=None) -> tuple:
    """The backward kernels (one fused, or the split pair) the JAX package's
    ``flash_backward`` runs for this schedule, as the port's routes."""
    if fused is None:
        fused = "kv" if env_on("FA_FUSED_BWD") else False
    if fused == "q" or (fused is True and g > 2):
        fused = "q"
    return _backward_route(pack, rule, config, fused if fused == "q" else bool(fused),
                           env_on("FA_WINDOW_BWD"), env_on("FA_BANDED_BWD"))


def flash_backward(q, k, v, o, l, m, do, *, pack: SyncPack, rule: MaskRule,
                   config: BlockConfig, scale: Optional[float] = None, fused=None):
    """``(dQ, dK, dV)`` on sequence-major tensors from the saved
    ``(q, k, v, o, l, m)`` and the output cotangent ``do``."""
    in_dtype = q.dtype
    if in_dtype.itemsize == 1:
        b16 = lambda x: x.to(torch.bfloat16)
        grads = flash_backward(b16(q), b16(k), b16(v), b16(o), l, m, b16(do), pack=pack,
                               rule=rule, config=config, scale=scale, fused=fused)
        return tuple(x.to(in_dtype) for x in grads)
    B, q_len, d = q.shape
    B_kv, k_len, v_d = v.shape
    if B % B_kv:
        raise ValueError(f"q batch {B} not a multiple of kv batch {B_kv}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    scale = float(scale)
    routes = backward_route(pack, rule, config, B // B_kv, fused)
    lse2, delta = backward_stats(o, l, m, do)
    if q.device.type == "cpu":
        return _flash_backward_plain(q, k, v, do, lse2, delta, pack, rule, scale,
                                     len(routes) == 1)

    q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    rule_c = native.fa_rule(pack, rule)
    if len(routes) == 2:
        r_dq, r_dkv = routes
        dq = native.flash_bwd_dq(prescale(q, scale), k, v, do, lse2, delta, rule_c,
                                 r_dq.tables(pack, rule, q.device), r_dq.block_q,
                                 r_dq.block_kv, scale)
        dk, dv = native.flash_bwd_dkv(q, prescale(k, scale), v, do, lse2, delta, rule_c,
                                      r_dkv.tables(pack, rule, q.device), r_dkv.block_q,
                                      r_dkv.block_kv, scale)
        return dq, dk, dv
    (route,) = routes
    tabs = route.tables(pack, rule, q.device)
    args = (prescale(q, scale), k, v, do, lse2, delta, rule_c)
    if route.kernel == "flash_bwd_qouter":
        dq, dk_acc, dv_acc = native.flash_bwd_qouter(*args, tabs, route.block_q,
                                                     route.block_kv, scale)
        return dq, (dk_acc * INV_LOG2E).to(in_dtype), dv_acc.to(in_dtype)
    if route.kernel == "window_bwd":
        dq_acc, dk, dv = native.window_bwd(*args, tabs[0], route.band, route.sub, INV_LOG2E)
    elif route.kernel == "banded_bwd":
        dq_acc, dk, dv = native.banded_bwd(*args, tabs[0], route.block_q, route.block_kv,
                                           INV_LOG2E)
    else:
        dq_acc, dk, dv = native.flash_bwd_fused(*args, tabs, route.block_q, route.block_kv,
                                                INV_LOG2E)
    return (dq_acc * scale).to(in_dtype), dk, dv
