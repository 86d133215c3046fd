"""Plain PyTorch reference of the decoders the configurations describe.

A Llama-style decoder as the configuration files state it: token
embedding, per layer an RMSNorm, q/k/v projections, RoPE (half-split
rotation, ``rope_theta``), attention with grouped KV heads (q head ``h``
reads KV head ``h // (heads / kv_heads)``) under a causal mask or
Mistral's sliding window (``0 <= q - k < sliding_window``), the output
projection, a second RMSNorm and the SwiGLU MLP ``(silu(x W1) * x W3) W2``;
a final RMSNorm and the head, tied to the embedding as the port ties it.

Everything runs in float32 with TF32 off, on the bf16 weight values that
``benchlib.weights`` draws from the seed.  The served path keeps its keys
and values in an int8 cache with one float32 scale a token and head
(symmetric: ``scale = amax / 127``, round half to even); the reference
works that cache out again from its own float32 keys (after RoPE) and
values and attends over the dequantized values.  It reads nothing the
program made and imports nothing of the program.

``fp8=True`` is the control: every matrix product (projections, MLP,
head) takes its operands rounded to float8 e4m3, the activations scaled
per row and the weights per output column, products summed in float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products (restored on exit)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / E4M3_MAX)
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """``x @ w`` in float32: x (n, in) float32, w (in, out) any dtype."""
    wf = w.float()
    if fp8:
        x, wf = fp8_round(x, -1), fp8_round(wf, 0)
    return x @ wf


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Per-row symmetric int8 quantization of ``x`` (..., d), dequantized."""
    amax = x.abs().amax(-1, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (L, heads, d) at positions 0 .. L-1, half-split rotation; the
    angles in float64."""
    L, _, d = x.shape
    half = d // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(L, dtype=torch.float64, device=x.device)[:, None] * inv[None]
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, window: Optional[int], block: int = 256) -> torch.Tensor:
    """Softmax attention of q (L, H, d) over k, v (L, KV, d), causal, and
    within ``window`` positions when it is set; by blocks of query rows,
    each over only the keys it can see."""
    L, H, d = q.shape
    kv = k.shape[1]
    g = H // kv
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(d)
    for s in range(0, L, block):
        e = min(L, s + block)
        lo = max(0, s - window + 1) if window else 0
        qb = q[s:e].reshape(e - s, kv, g, d)
        scores = torch.einsum("qkgd,tkd->kgqt", qb, k[lo:e]) * scale
        qpos = torch.arange(s, e, device=q.device)[:, None]
        kpos = torch.arange(lo, e, device=q.device)[None, :]
        vis = kpos <= qpos
        if window:
            vis = vis & (qpos - kpos < window)
        p = torch.softmax(scores.masked_fill(~vis, float("-inf")), dim=-1)
        out[s:e] = torch.einsum("kgqt,tkd->qkgd", p, v[lo:e]).reshape(e - s, H, d)
    return out


@torch.no_grad()
def logits(cfg: dict, weights: dict, tokens: torch.Tensor, positions: torch.Tensor,
           kv_int8: bool = True, fp8: bool = False) -> torch.Tensor:
    """Float32 logits (len(positions), vocab) of the sequence ``tokens``
    (L,) at ``positions``: position p's logits predict token p + 1."""
    eps = float(cfg["rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    window = cfg.get("sliding_window") or None
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d_head = cfg["hidden_size"] // H if not cfg.get("head_dim") else cfg["head_dim"]
    L = tokens.shape[0]
    with exact_float32():
        x = weights["embed"][tokens].float()
        for layer in weights["layers"]:
            h = rms_norm(x, eps)
            q = rope(linear(h, layer["wq"], fp8).reshape(L, H, d_head), theta)
            k = rope(linear(h, layer["wk"], fp8).reshape(L, KV, d_head), theta)
            v = linear(h, layer["wv"], fp8).reshape(L, KV, d_head)
            if kv_int8:
                k, v = int8_roundtrip(k), int8_roundtrip(v)
            o = attention(q, k, v, window).reshape(L, H * d_head)
            x = x + linear(o, layer["wo"], fp8)
            h = rms_norm(x, eps)
            x = x + linear(F.silu(linear(h, layer["w1"], fp8)) * linear(h, layer["w3"], fp8),
                           layer["w2"], fp8)
        h = rms_norm(x[positions], eps)
        return linear(h, weights["embed"].T, fp8)

