"""Public API: the reference's six entry points (PyTorch port of ``api.py``).

``full_1d``, ``causal_1d``, ``local_1d``, ``full_2d``, ``causal_2d``,
``local_2d`` keep the reference's contract: channel-first tensors
(``Q: batch_shape + (d, *q_seq)``, ``K: batch_shape + (d, *k_seq)``,
``V: batch_shape + (v_d, *k_seq)``), a ``sync_mode`` string, optional
``returning_l_m``, and outputs ``O`` (+ ``l``, ``m``).  Autograd runs
through ``ops.attend`` (a ``torch.autograd.Function``).

Implementations behind the same surface (the JAX package's names):

* ``"pallas"`` (default) — the kernels: hand-written CUDA on the card,
  their plain PyTorch versions on the CPU;
* ``"xla"`` — the dense oracle (``ops.reference``), differentiated by
  torch's autograd;
* ``"xla_flash"`` — the chunked path (``ops.chunked``), the default for
  float64: the kernels' online softmax in plain PyTorch over the live
  tiles, O(block) memory, float64 products on the card by cuBLAS.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .block_sizes import BlockConfig, choose_block_config
from .mask_rules import CausalRule, FullRule, LocalRule, MaskRule
from .ops.attend import AttendParams, attend
from .ops.chunked import flash_attention_xla
from .ops.reference import build_mask, reference_attention_flat
from .sync_modes import make_sync_pack
from .utils.dtypes import l_dtype, neg_inf_approx

__all__ = ["full_1d", "causal_1d", "local_1d", "full_2d", "causal_2d", "local_2d",
           "flash_attention"]


def _public_lm(in_dtype, l32, m32):
    """Cast the float32 kernel stats to the reference's output dtypes: ``l``
    float32 for half inputs, else the input dtype; ``m`` the input dtype,
    with the finite -inf clamped so it survives the narrowing cast."""
    l_pub = l32.to(l_dtype(in_dtype))
    m_pub = torch.clamp(m32, min=neg_inf_approx(in_dtype)).to(in_dtype)
    return l_pub, m_pub


def flash_attention(Q: torch.Tensor, K: torch.Tensor, V: torch.Tensor, *, rule: MaskRule,
                    sync_mode: str = "none_front", seq_dims: int = 1,
                    returning_l_m: bool = False, implementation: Optional[str] = None,
                    block_config: Optional[BlockConfig] = None,
                    scale: Optional[float] = None):
    """Rule-masked flash attention on channel-first tensors; the general
    entry point behind the six wrappers (any ``MaskRule``: the CUDA kernels
    evaluate a custom rule's ``check`` through a mask built on the host,
    ``native.custom_mask``)."""
    if seq_dims not in (1, 2):
        raise ValueError(f"seq_dims must be 1 or 2, got {seq_dims}")
    q_seq = tuple(int(s) for s in Q.shape[-seq_dims:])
    k_seq = tuple(int(s) for s in K.shape[-seq_dims:])
    v_seq = tuple(int(s) for s in V.shape[-seq_dims:])
    if k_seq != v_seq:
        raise ValueError(f"K and V sequence shapes differ: {k_seq} vs {v_seq}")
    d = int(Q.shape[-seq_dims - 1])
    if int(K.shape[-seq_dims - 1]) != d:
        raise ValueError(f"Q and K channel dims differ: {d} vs {K.shape[-seq_dims - 1]}")
    v_d = int(V.shape[-seq_dims - 1])
    batch_shape = tuple(Q.shape[: -seq_dims - 1])
    if (tuple(K.shape[: -seq_dims - 1]) != batch_shape
            or tuple(V.shape[: -seq_dims - 1]) != batch_shape):
        raise ValueError("Q, K, V batch shapes must match")
    if Q.dtype != K.dtype or Q.dtype != V.dtype:
        raise ValueError("Q, K, V dtypes must match")

    pack = make_sync_pack(sync_mode, q_seq, k_seq)
    q_len = int(np.prod(q_seq))
    k_len = int(np.prod(k_seq))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if implementation is None:
        # float64 has no kernel (nor a TPU one in the JAX package): the
        # chunked path keeps flash's O(block) memory at float64 precision
        implementation = "xla_flash" if Q.dtype == torch.float64 else "pallas"

    B = int(np.prod(batch_shape)) if batch_shape else 1
    # channel-first -> (B, seq, channel)
    qf = Q.reshape(B, d, q_len).transpose(-1, -2)
    kf = K.reshape(B, d, k_len).transpose(-1, -2)
    vf = V.reshape(B, v_d, k_len).transpose(-1, -2)

    if implementation == "xla":
        mask = torch.from_numpy(np.array(build_mask(pack, rule).reshape(q_len, k_len)))
        mask = mask.to(Q.device)
        o, l, m = reference_attention_flat(qf, kf, vf, mask, scale=scale)
    elif implementation == "xla_flash":
        blocks = {} if block_config is None else dict(block_q=block_config.block_q,
                                                      block_kv=block_config.block_kv)
        o, lv, mv = flash_attention_xla(qf, kf, vf, pack=pack, rule=rule, scale=scale, **blocks)
        l, m = _public_lm(Q.dtype, lv, mv)
    elif implementation == "pallas":
        if block_config is None:
            block_config = choose_block_config(d, v_d)
        params = AttendParams(pack=pack, rule=rule, config=block_config, scale=float(scale))
        o, l32, m32 = attend(qf, kf, vf, params)
        l, m = _public_lm(Q.dtype, l32, m32)
    else:
        raise ValueError(f"unknown implementation {implementation!r}")

    O = o.transpose(-1, -2).reshape(batch_shape + (v_d,) + q_seq)
    if not returning_l_m:
        return O
    return O, l.reshape(batch_shape + q_seq), m.reshape(batch_shape + q_seq)


def full_1d(Q, K, V, sync_mode="none_front", returning_l_m=False, **kwargs):
    """Full (unmasked) attention on 1d sequences (ref ``flash_attention.py:80``)."""
    return flash_attention(Q, K, V, rule=FullRule(), sync_mode=sync_mode, seq_dims=1,
                           returning_l_m=returning_l_m, **kwargs)


def causal_1d(Q, K, V, sync_mode, returning_l_m=False, **kwargs):
    """Causal attention on 1d sequences (ref ``flash_attention.py:122``)."""
    return flash_attention(Q, K, V, rule=CausalRule(), sync_mode=sync_mode, seq_dims=1,
                           returning_l_m=returning_l_m, **kwargs)


def local_1d(Q, K, V, window_size, log2_stride_size, is_causal, sync_mode,
             returning_l_m=False, **kwargs):
    """Local (windowed/strided) attention on 1d sequences (ref ``flash_attention.py:163``)."""
    rule = LocalRule(window_size=window_size, log2_stride_size=log2_stride_size,
                     is_causal=is_causal)
    return flash_attention(Q, K, V, rule=rule, sync_mode=sync_mode, seq_dims=1,
                           returning_l_m=returning_l_m, **kwargs)


def full_2d(Q, K, V, sync_mode="none_front", returning_l_m=False, **kwargs):
    """Full (unmasked) attention on 2d sequences (ref ``flash_attention.py:219``)."""
    return flash_attention(Q, K, V, rule=FullRule(), sync_mode=sync_mode, seq_dims=2,
                           returning_l_m=returning_l_m, **kwargs)


def causal_2d(Q, K, V, sync_mode, returning_l_m=False, **kwargs):
    """Causal attention on 2d sequences (ref ``flash_attention.py:266``)."""
    return flash_attention(Q, K, V, rule=CausalRule(), sync_mode=sync_mode, seq_dims=2,
                           returning_l_m=returning_l_m, **kwargs)


def local_2d(Q, K, V, window_size, log2_stride_size, is_causal, sync_mode,
             returning_l_m=False, **kwargs):
    """Local (windowed/strided) attention on 2d sequences (ref ``flash_attention.py:312``)."""
    rule = LocalRule(window_size=window_size, log2_stride_size=log2_stride_size,
                     is_causal=is_causal)
    return flash_attention(Q, K, V, rule=rule, sync_mode=sync_mode, seq_dims=2,
                           returning_l_m=returning_l_m, **kwargs)
