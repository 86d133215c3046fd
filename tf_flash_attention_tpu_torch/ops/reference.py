"""Dense ("vanilla") attention oracle (PyTorch port of ``ops/reference.py``).

The semantic specification of the op: dense attention with an explicit
boolean mask generated from the rule, reproducing the kernels' numeric
contract:

* logits are scaled by ``scale`` (default ``1/sqrt(d)``) after the matmul;
* masked logits take the finite ``neg_inf_approx`` masking value, and
  their numerators are exactly zero;
* a fully-masked query row yields ``O = 0``, ``l = 0``, ``m = neg_inf_approx``;
* ``l`` is float32 for half-precision inputs.

``build_mask`` is numpy, as in the JAX package (whose module imports
``jax.numpy`` and so cannot be shared).  Layouts are the reference's
channel-first ones: ``Q: batch_shape + (d, *q_seq)``, ``K: batch_shape +
(d, *k_seq)``, ``V: batch_shape + (v_d, *k_seq)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..mask_rules import MaskRule
from ..schedule import sequence_orders
from ..sync_modes import SyncPack, make_sync_pack
from ..utils.dtypes import l_dtype, neg_inf_approx

__all__ = ["build_mask", "reference_attention", "reference_attention_flat"]


def build_mask(pack: SyncPack, rule: MaskRule) -> np.ndarray:
    """Dense boolean visibility mask of shape ``q_seq + k_seq``."""
    q_coords, q_flat = sequence_orders(pack.q, pack.reference_shape)
    k_coords, k_flat = sequence_orders(pack.k, pack.reference_shape)
    q_len, k_len = q_flat.shape[0], k_flat.shape[0]
    mask = rule.check(
        pack,
        [c[:, None] for c in q_coords],
        [c[None, :] for c in k_coords],
        q_flat[:, None],
        k_flat[None, :],
    )
    mask = np.broadcast_to(np.asarray(mask, dtype=bool), (q_len, k_len))
    return mask.reshape(tuple(pack.q.shape) + tuple(pack.k.shape))


def reference_attention_flat(q, k, v, mask, *, scale=None):
    """Dense masked attention on sequence-major tensors.

    ``q: (..., q_len, d)``, ``k: (..., k_len, d)``, ``v: (..., k_len, v_d)``;
    ``mask`` (bool) broadcasts to ``(..., q_len, k_len)``, True = visible.
    Returns ``(o, l, m)`` in the input dtype, ``l`` in ``l_dtype``.
    Differentiable through torch's autograd.
    """
    in_dtype = q.dtype
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    compute = torch.float64 if in_dtype == torch.float64 else torch.float32
    mask_value = neg_inf_approx(compute)
    s = torch.einsum("...qd,...kd->...qk", q.to(compute), k.to(compute)) * scale
    s = torch.where(mask, s, torch.full_like(s, mask_value))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("...qk,...kv->...qv", p, v.to(compute)) / l_safe[..., None]
    return o.to(in_dtype), l.to(l_dtype(in_dtype)), m.to(in_dtype)


def reference_attention(Q, K, V, *, rule: MaskRule, sync_mode: str = "none_front",
                        seq_dims: int = 1, returning_l_m: bool = False):
    """Channel-first dense oracle with rule-generated masking."""
    q_seq = tuple(Q.shape[-seq_dims:])
    k_seq = tuple(K.shape[-seq_dims:])
    d = Q.shape[-seq_dims - 1]
    v_d = V.shape[-seq_dims - 1]
    batch_shape = tuple(Q.shape[: -seq_dims - 1])

    pack = make_sync_pack(sync_mode, q_seq, k_seq)
    mask = build_mask(pack, rule)
    q_len = int(np.prod(q_seq))
    k_len = int(np.prod(k_seq))

    qf = Q.reshape(batch_shape + (d, q_len)).transpose(-1, -2)
    kf = K.reshape(batch_shape + (d, k_len)).transpose(-1, -2)
    vf = V.reshape(batch_shape + (v_d, k_len)).transpose(-1, -2)
    o, l, m = reference_attention_flat(
        qf, kf, vf, torch.from_numpy(np.array(mask.reshape(q_len, k_len))).to(Q.device))

    O = o.transpose(-1, -2).reshape(batch_shape + (v_d,) + q_seq)
    l = l.reshape(batch_shape + q_seq)
    m = m.reshape(batch_shape + q_seq)
    return (O, l, m) if returning_l_m else O
