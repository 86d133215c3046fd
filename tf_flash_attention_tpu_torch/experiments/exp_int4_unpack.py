"""INT4 decode unpack-strategy experiment (PyTorch port of
``tools/exp_int4_unpack.py``).

Single-token decode of B rows (8 kv heads, 8 query rows each, d 128) over
one K/V of CTX tokens that every row reads, in pages of PAGE tokens:

  int8ref   int8 payload, scales on s and p
  s32       int4 nibble pairs, each byte widened and shifted apart
  twopage   as s32, 2 pages a step before their softmax
  fourpage  as s32, 4 pages a step
  int8_2pg  as int8ref, 2 pages a step
  bitcast   int4 through a register conversion (the TPU's one s4->bf16
            convert has no Hopper counterpart: a bf16 magic-number
            subtraction turns two nibbles at a time), even and odd tokens
            accumulated apart and summed in bf16 as the tool's runner does

The six kernels run the serving decode's tensor-core body
(``csrc/decode_tc.cuh``), each payload, unpack method, merge width and the
split accumulators a compiled policy (the int8 ones on the serving unpack),
a (row, kv head)'s merges split over CTAs (``native.exp_int4_plan``).
``serving_decode`` runs the serving decode itself on the same K/V laid out
as a cache whose slots share its pages: the yardstick beside them.

    python -m tf_flash_attention_tpu_torch.experiments.exp_int4_unpack
"""

from __future__ import annotations

import math

import torch

from .. import native
from ..ops.kernel_common import LOG2E, NEG_INF_F32
from ..serving.decode import paged_decode_attention
from ..serving.kv_cache import KVCacheConfig, PagedKVCache, _unpack_nibbles
from ._steps import bf16r, div, require_cuda

__all__ = ["KERNELS", "int4_decode", "int4_decode_plain", "quantize_int4", "quantize_int8",
           "shared_cache", "serving_decode", "build", "main"]

B, CTX, PAGE, N_KV, D, G = 16, 8192, 256, 8, 128, 8
#: the tool's runners, in its order, and their kernels
KERNELS = {"int8ref": "exp_int4_int8ref", "s32": "exp_int4_s32", "twopage": "exp_int4_twopage",
           "fourpage": "exp_int4_fourpage", "int8_2pg": "exp_int4_int8_2pg",
           "bitcast": "exp_int4_bitcast"}


def quantize_int4(x, page: int = PAGE):
    """Per-token int4 of float32 x (n_kv, ctx, d), as the tool's ``q4``:
    (packed (n_kv, pages, page/2, d) int8, scales (n_kv, pages, 2, page/2),
    dequantized float32 (n_kv, ctx, d))."""
    n_kv, ctx, d = x.shape
    amax = x.abs().amax(-1, keepdim=True)
    sc = torch.where(amax == 0, torch.ones_like(amax), div(amax, 7.0))
    q = torch.clamp(torch.round(x / sc), -7, 7).to(torch.int32)
    lo, hi = q[:, 0::2] & 0xF, q[:, 1::2] & 0xF
    packed = (lo | (hi << 4)).to(torch.int8)
    scp = torch.stack([sc[:, 0::2, 0], sc[:, 1::2, 0]], dim=1)       # (n_kv, 2, ctx/2)
    pages, rows = ctx // page, page // 2
    return (packed.reshape(n_kv, pages, rows, d),
            scp.reshape(n_kv, 2, pages, rows).transpose(1, 2).contiguous(),
            (q * sc).float())


def quantize_int8(x, page: int = PAGE):
    """Per-token int8 of float32 x (n_kv, ctx, d), as the tool's ``q8``:
    (payload (n_kv, pages, page, d) int8, scales (n_kv, pages, 1, page))."""
    n_kv, ctx, d = x.shape
    amax = x.abs().amax(-1, keepdim=True)
    sc = torch.where(amax == 0, torch.ones_like(amax), div(amax, 127.0))
    q = torch.clamp(torch.round(x / sc), -127, 127).to(torch.int8)
    return (q.reshape(n_kv, ctx // page, page, d),
            sc[..., 0].reshape(n_kv, ctx // page, 1, page).contiguous())


def _tokens(pages, scales, pack):
    """Token values (n_kv, pages, pack * rows, d) float32 and their scales
    (n_kv, pages, pack * rows), in the kernels' order: nibble-major."""
    if pack == 1:
        vals = pages.float()
    else:
        lo, hi = _unpack_nibbles(pages)
        vals = torch.cat([lo, hi], dim=2).float()
    return vals, scales.reshape(*scales.shape[:2], -1)


def int4_decode_plain(kernel: str, q, k, ks, v, vs):
    """The kernel ``KERNELS[name]`` in PyTorch: q (B, n_kv, G, d) bf16 over
    the shared K/V -> o (B, n_kv, G, d) bf16 (scale 1/sqrt(d))."""
    npg, pack = native.INT4_NPG[kernel], native._tool_pack(kernel)
    n_kv, pages, rows, d = k.shape
    c = 1.0 / math.sqrt(d) * LOG2E
    kt, kst = _tokens(k, ks, pack)
    vt, vst = _tokens(v, vs, pack)
    T = npg * pack * rows                                   # tokens a step
    kt, vt = kt.reshape(n_kv, pages // npg, T, d), vt.reshape(n_kv, pages // npg, T, d)
    kst, vst = kst.reshape(n_kv, pages // npg, T), vst.reshape(n_kv, pages // npg, T)
    qf = q.float()
    m = torch.full((*q.shape[:3], 1), NEG_INF_F32, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    acc_odd = torch.zeros_like(acc)
    # bitcast: the odd tokens (high nibbles) accumulate apart
    odd = (torch.arange(T, device=q.device) // rows) % 2 == 1
    for st in range(pages // npg):
        s = torch.einsum("bhgd,htd->bhgt", qf, kt[:, st]) * (kst[:, st] * c)[None, :, None, :]
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        pw = torch.exp2(s - m_next)
        l = alpha * l + pw.sum(-1, keepdim=True)
        p = bf16r(pw * vst[:, st][None, :, None, :])
        if kernel == "exp_int4_bitcast":
            acc = acc * alpha + torch.einsum("bhgt,htd->bhgd", p * ~odd, vt[:, st])
            acc_odd = acc_odd * alpha + torch.einsum("bhgt,htd->bhgd", p * odd, vt[:, st])
        else:
            acc = acc * alpha + torch.einsum("bhgt,htd->bhgd", p, vt[:, st])
        m = m_next
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    if kernel == "exp_int4_bitcast":
        return (bf16r(acc / l_safe) + bf16r(acc_odd / l_safe)).to(torch.bfloat16)
    return (acc / l_safe).to(torch.bfloat16)


def int4_decode(kernel: str, q, k, ks, v, vs):
    """One of the tool's kernels: the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors (scale 1/sqrt(d))."""
    if kernel not in native.INT4_NPG:
        raise ValueError(f"kernel must be one of {tuple(native.INT4_NPG)}, got {kernel!r}")
    if not q.is_cuda:
        return int4_decode_plain(kernel, q, k, ks, v, vs)
    return native.exp_int4_decode(kernel, q, k, ks, v, vs, 1.0 / math.sqrt(q.shape[-1]) * LOG2E)


def shared_cache(k, ks, v, vs, B: int):
    """The tool's K/V (k, v (n_kv, pages, rows, d) int8, scales (n_kv,
    pages, pack, rows); int4 pairs where pack is 2) as the pages of a
    serving cache of B slots that all map pages 0 .. pages - 1 at full
    length: (cache, cfg)."""
    n_kv, pages, rows, d = k.shape
    int4 = ks.shape[2] == 2
    page = rows * ks.shape[2]
    cfg = KVCacheConfig(n_kv_heads=n_kv, head_dim=d, page_size=page, n_pages=pages, max_seqs=B,
                        max_pages_per_seq=pages, quantized=True,
                        quant_dtype="int4" if int4 else torch.int8)
    tables = torch.arange(pages, dtype=torch.int32, device=k.device).expand(B, pages).contiguous()
    lengths = torch.full((B,), pages * page, dtype=torch.int32, device=k.device)
    return PagedKVCache(k, v, ks, vs, tables, lengths), cfg


def serving_decode(q, k, ks, v, vs):
    """The serving decode (``paged_decode_attention``, causal: every key
    visible) on ``shared_cache``: q (B, n_kv, G, d) bf16 -> o of that shape
    (scale 1/sqrt(d)).  On the card, the serving body and its unpack."""
    B, n_kv, G, d = q.shape
    cache, cfg = shared_cache(k, ks, v, vs, B)
    return paged_decode_attention(q.reshape(B, n_kv * G, d), cache, cfg).reshape(q.shape)


def build(gen, device):
    """The tool's inputs from a seeded generator: q (B, N_KV, G, D) bf16 and
    (k4, ks4, v4, vs4, kd, vd, k8, ks8, v8, vs8), kd/vd the dequantized int4
    K/V (N_KV, CTX, D) of the oracle."""
    kv = torch.rand((2, N_KV, CTX, D), generator=gen, device=device) * 2 - 1
    k4, ks4, kd = quantize_int4(kv[0])
    v4, vs4, vd = quantize_int4(kv[1])
    k8, ks8 = quantize_int8(kv[0])
    v8, vs8 = quantize_int8(kv[1])
    q = (torch.rand((B, N_KV, G, D), generator=gen, device=device) * 2 - 1).to(torch.bfloat16)
    return q, (k4, ks4, v4, vs4, kd, vd, k8, ks8, v8, vs8)


def main():
    from ..utils.profiling import device_time

    dev = require_cuda("exp_int4_unpack")
    q, (k4, ks4, v4, vs4, kd, vd, k8, ks8, v8, vs8) = build(
        torch.Generator(device=dev).manual_seed(0), dev)
    # dense int4 oracle on row 0
    s = torch.einsum("hgd,htd->hgt", q[0].float(), kd) / math.sqrt(D)
    ref = torch.einsum("hgt,htd->hgd", torch.softmax(s, -1), vd)
    print(f"device={torch.cuda.get_device_name(0)}", flush=True)
    for name, kernel in KERNELS.items():
        int8 = kernel.startswith("exp_int4_int8")
        args = (q, k8, ks8, v8, vs8) if int8 else (q, k4, ks4, v4, vs4)
        o = int4_decode(kernel, *args)
        err = float((o[0].float() - ref).abs().max())
        err_plain = float((o.float() - int4_decode_plain(kernel, *args).float()).abs().max())
        t = device_time(int4_decode, (kernel,) + args, n=20, reps=4)
        # the tool's count: the K/V once per row (every row reads all of it)
        kvb = B * CTX * N_KV * D * (2.0 if int8 else 1.0) / 2 + B * CTX * N_KV * 4 * 2
        print(f"{name:8s}: {t * 1e3:.3f} ms, {B / t:,.0f} tok/s, {kvb / t / 1e9:.0f} GB/s, "
              f"err={err:.2e} (vs plain {err_plain:.2e})", flush=True)


if __name__ == "__main__":
    main()
