"""Helpers shared by the experiment modules, and the plain PyTorch version
of the experiment forward.

``forward_steps`` walks the keys in the kernel's steps and merges each
group into a running (m, l, acc) with the TPU kernels' online softmax
(``merge_step``), so it rounds p at the same maxima as the kernel and the
tools do.  It is the reference the CUDA kernel is held against on the card
and the function the CPU tests hold against the JAX tools; no CUDA path
calls it.
"""

from __future__ import annotations

import sys

import torch

from ..ops.kernel_common import NEG_INF_F32

__all__ = ["forward_steps", "merge_step", "require_cuda", "bf16r", "div"]


def bf16r(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bf16 and back."""
    return x.to(torch.bfloat16).float()


def div(x: torch.Tensor, y: float) -> torch.Tensor:
    """x / y with a tensor divisor: on the card, division by a Python scalar
    multiplies by its reciprocal, which is not the IEEE quotient the
    kernels and the tools take."""
    return x / torch.full_like(x, y)


def require_cuda(tool: str) -> torch.device:
    """The card, or exit non-zero: a tool's ``main()`` measures the card and
    has no CPU fallback."""
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device; this experiment runs only on the GPU", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def merge_step(policy: str, s, v, m, l, acc):
    """One online-softmax merge of float32 scores s (..., rows, keys) and
    their values v (..., keys, d) into (m, l, acc), as the rungs of
    exp_vpu_attrib.py:57-85 (``prod`` is also exp_kv_unroll's merge,
    ``bf16exp`` exp_resident's)."""
    if policy == "mm":
        p, alpha = bf16r(s), 1.0
    else:
        if policy == "nomax":
            m_next = torch.full_like(m, 8.0)
        else:
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        if policy == "bf16exp":
            p = torch.exp2((s - m_next).to(torch.bfloat16)).float()
            add = p.sum(-1, keepdim=True)
        else:
            p32 = s - m_next if policy == "noexp" else torch.exp2(s - m_next)
            p, add = bf16r(p32), p32.sum(-1, keepdim=True)
        if policy != "nosum":
            l = alpha * l + add
        m = m_next
    return m, l, acc * alpha + p @ v


def forward_steps(q, k, v, *, step: int, group: int, block_q: int, causal: bool,
                  elem_mask: bool, policy: str, score_scale: float = 1.0):
    """The experiment forward (``csrc/exp_forward_kernels.cu``) in PyTorch:
    bf16 q, k, v (B, S, d) -> o (B, S, d) bf16.  Query block qi (``block_q``
    rows) walks ``ceil((qi + 1) * block_q / step)`` steps when ``causal``,
    every step otherwise; a step's scores (times ``score_scale``) are
    computed before its ``step // group`` merges; with ``elem_mask`` every
    step crossing the q block's diagonal masks keys past the query."""
    B, S, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.empty_like(q)
    for qi in range(S // block_q):
        r0 = qi * block_q
        m = torch.full((B, block_q, 1), NEG_INF_F32, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, block_q, d), dtype=torch.float32, device=q.device)
        n_steps = -(-(qi + 1) * block_q // step) if causal else S // step
        q_pos = torch.arange(r0, r0 + block_q, device=q.device)[:, None]
        for st in range(n_steps):
            k0 = st * step
            s = (qf[:, r0:r0 + block_q] @ kf[:, k0:k0 + step].transpose(1, 2)) * score_scale
            if elem_mask and k0 + step - 1 > r0:
                k_pos = torch.arange(k0, k0 + step, device=q.device)[None, :]
                s = torch.where(k_pos > q_pos, torch.full_like(s, NEG_INF_F32), s)
            for g0 in range(0, step, group):
                m, l, acc = merge_step(policy, s[..., g0:g0 + group],
                                       vf[:, k0 + g0:k0 + g0 + group], m, l, acc)
        o[:, r0:r0 + block_q] = (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
    return o
