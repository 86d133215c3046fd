"""Differentiable sequence-major attention core (port of ``ops/attend.py``).

``attend`` is a ``torch.autograd.Function`` over the forward and backward
kernels, the counterpart of the JAX package's ``jax.custom_vjp``.  It saves
the reference's tensor set ``(q, k, v, o, l, m)`` with the softmax stats in
float32.  Gradients flow to ``q, k, v`` from the ``o`` cotangent only:
``l`` and ``m`` are marked non-differentiable and their cotangents are
ignored, as in the JAX package.  Both the channel-first API (``api.py``)
and the multi-head layer (``parallel/sharded.mha``) go through it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..block_sizes import BlockConfig
from ..mask_rules import MaskRule
from ..sync_modes import SyncPack
from .backward import flash_backward
from .forward import flash_forward

__all__ = ["AttendParams", "attend"]


@dataclasses.dataclass(frozen=True)
class AttendParams:
    """Static configuration of one attention call."""

    pack: SyncPack
    rule: MaskRule
    config: BlockConfig
    scale: float


class _Attend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, params: AttendParams):
        o, l32, m32 = flash_forward(q, k, v, pack=params.pack, rule=params.rule,
                                    config=params.config, scale=params.scale)
        ctx.save_for_backward(q, k, v, o, l32, m32)
        ctx.params = params
        ctx.mark_non_differentiable(l32, m32)
        return o, l32, m32

    @staticmethod
    def backward(ctx, do, _dl, _dm):
        q, k, v, o, l32, m32 = ctx.saved_tensors
        p = ctx.params
        dq, dk, dv = flash_backward(q, k, v, o, l32, m32, do, pack=p.pack, rule=p.rule,
                                    config=p.config, scale=p.scale)
        return dq, dk, dv, None


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, params: AttendParams):
    """Rule-masked flash attention on ``(B, seq, channel)`` tensors; returns
    ``(o, l, m)`` with ``l, m`` float32 (kernel stats)."""
    return _Attend.apply(q, k, v, params)
