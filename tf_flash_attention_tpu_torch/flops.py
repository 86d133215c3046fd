"""Analytic, skip-aware FLOPs estimation.

A carried copy of ``tf_flash_attention_tpu/flops.py`` (numpy only), held
equal to the original by ``tests/test_torch_host.py``.

TPU-native replacement for the reference's FLOPs estimator ops and TF
``OpStats("flops")`` registrations (``flash_attention.py:475-562``,
``FlashAttentionForwardFlopsEstimationBase``; cost model at
``flash_attention.cu:2069-2144``).  The per-live-tile cost formula is the
reference's exact model (``flash_attention.cu:2090-2113``)::

    Br*Bc*(2d-1)        # S = Q·Kᵀ
  + 2*Br*(Bc-1)         # row max + exp-sum reductions
  + 2*Br*Bc             # numerator exp/sub
  + 7*Br                # (l, m) online merge
  + Br*(Bc + v_d)       # P and O reweighting
  + Br*v_d*(2Bc-1)      # O += P·V

summed over the *live* tiles of the block-skip schedule (masked-out tiles
contribute zero, honouring the same skip decisions as the kernels) and
multiplied by the flattened batch.  Edge tiles are charged at their
clamped sizes.

Two consumers:

* public ``estimate_*_flops`` parity functions (the reference exposes one
  per op family);
* the benchmark/roofline report, plus ``matmul_flops`` — the MXU work the
  kernel actually schedules (full tiles, both matmuls) — used as the
  roofline numerator and as ``pl.CostEstimate`` input.
"""

from __future__ import annotations

import numpy as np

from .mask_rules import CausalRule, FullRule, LocalRule, MaskRule
from .schedule import build_schedule
from .sync_modes import make_sync_pack

__all__ = [
    "estimate_forward_flops",
    "matmul_flops_forward",
    "matmul_flops_backward",
    "estimate_full_attention_forward1d_flops",
    "estimate_causal_attention_forward1d_flops",
    "estimate_local_attention_forward1d_flops",
    "estimate_full_attention_forward2d_flops",
    "estimate_causal_attention_forward2d_flops",
    "estimate_local_attention_forward2d_flops",
]


def _tile_sizes(length: int, block: int) -> np.ndarray:
    n = -(-length // block)
    sizes = np.full(n, block, dtype=np.int64)
    if length % block:
        sizes[-1] = length % block
    return sizes


def _live_tile_grid(pack, rule: MaskRule, q_len, k_len, block_q, block_kv):
    sched = build_schedule(pack, rule, block_q, block_kv)
    br = _tile_sizes(q_len, block_q)
    bc = _tile_sizes(k_len, block_kv)
    return sched.live, br, bc


def estimate_forward_flops(
    rule: MaskRule,
    sync_mode: str,
    q_seq,
    k_seq,
    d: int,
    v_d: int,
    batch: int,
    block_q: int = 128,
    block_kv: int = 128,
) -> float:
    """Reference cost model summed over live tiles (``flash_attention.cu:2090-2113``)."""
    pack = make_sync_pack(sync_mode, q_seq, k_seq)
    q_len = int(np.prod(q_seq))
    k_len = int(np.prod(k_seq))
    live, br, bc = _live_tile_grid(pack, rule, q_len, k_len, block_q, block_kv)
    Br = br[:, None].astype(np.float64)
    Bc = bc[None, :].astype(np.float64)
    per_tile = (
        Br * Bc * (2 * d - 1)
        + 2 * Br * (Bc - 1)
        + 2 * Br * Bc
        + 7 * Br
        + Br * (Bc + v_d)
        + Br * v_d * (2 * Bc - 1)
    )
    return float((per_tile * live).sum() * batch)


def matmul_flops_forward(
    rule: MaskRule,
    sync_mode: str,
    q_seq,
    k_seq,
    d: int,
    v_d: int,
    batch: int,
    block_q: int = 128,
    block_kv: int = 128,
) -> float:
    """MXU FLOPs the forward kernel actually schedules: ``2·Br·Bc·(d+v_d)``
    per live tile (full tile sizes — padded edges run on the MXU too)."""
    pack = make_sync_pack(sync_mode, q_seq, k_seq)
    q_len = int(np.prod(q_seq))
    k_len = int(np.prod(k_seq))
    live, _, _ = _live_tile_grid(pack, rule, q_len, k_len, block_q, block_kv)
    n_live = int(live.sum())
    return float(2.0 * block_q * block_kv * (d + v_d) * n_live * batch)


def matmul_flops_backward(
    rule: MaskRule,
    sync_mode: str,
    q_seq,
    k_seq,
    d: int,
    v_d: int,
    batch: int,
    block_q: int = 128,
    block_kv: int = 128,
) -> float:
    """Useful gradient MXU FLOPs: the canonical 5-GEMM backward count
    ``2·Br·Bc·(3d + 2·v_d)`` per live tile (QKᵀ recompute, dV += Pᵀ·dO,
    dP = dO·Vᵀ, dQ += dS·K, dK += dSᵀ·Q — the reference's backward GEMM
    set, ``flash_attention.cu:1851-1940``).

    Deliberately does NOT credit the two-kernel split's duplicated QKᵀ and
    dO·Vᵀ recompute (7 GEMMs scheduled): benchmark numbers priced with
    this function measure delivered gradient throughput, not scheduled MXU
    occupancy.  Default 128×128 tiles give a config-independent count.
    """
    pack = make_sync_pack(sync_mode, q_seq, k_seq)
    q_len = int(np.prod(q_seq))
    k_len = int(np.prod(k_seq))
    live, _, _ = _live_tile_grid(pack, rule, q_len, k_len, block_q, block_kv)
    n_live = int(live.sum())
    return float(2.0 * block_q * block_kv * (3 * d + 2 * v_d) * n_live * batch)


def _shapes_from_channel_first(Q_shape, K_shape, V_shape, seq_dims):
    q_seq = tuple(int(s) for s in Q_shape[-seq_dims:])
    k_seq = tuple(int(s) for s in K_shape[-seq_dims:])
    d = int(Q_shape[-seq_dims - 1])
    v_d = int(V_shape[-seq_dims - 1])
    batch = int(np.prod(Q_shape[: -seq_dims - 1])) if len(Q_shape) > seq_dims + 1 else 1
    return q_seq, k_seq, d, v_d, batch


def _make_estimator(rule_factory, seq_dims):
    def estimate(Q_shape, K_shape, V_shape, *, sync_mode="none_front", **rule_kwargs):
        q_seq, k_seq, d, v_d, batch = _shapes_from_channel_first(
            Q_shape, K_shape, V_shape, seq_dims
        )
        rule = rule_factory(**rule_kwargs)
        return estimate_forward_flops(rule, sync_mode, q_seq, k_seq, d, v_d, batch)

    return estimate


# Parity surface with the reference's 6 estimator ops
# (flash_attention_forward.cc:217-245, flash_attention.py:499-562).
estimate_full_attention_forward1d_flops = _make_estimator(FullRule, 1)
estimate_causal_attention_forward1d_flops = _make_estimator(CausalRule, 1)
estimate_local_attention_forward1d_flops = _make_estimator(LocalRule, 1)
estimate_full_attention_forward2d_flops = _make_estimator(FullRule, 2)
estimate_causal_attention_forward2d_flops = _make_estimator(CausalRule, 2)
estimate_local_attention_forward2d_flops = _make_estimator(LocalRule, 2)
