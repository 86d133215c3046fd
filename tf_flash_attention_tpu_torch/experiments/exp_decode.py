"""Paged-decode dequantization-strategy experiment (PyTorch port of
``tools/exp_decode.py``).

Single-token paged decode over the serving path's int8 cache (16 slots of
8192 tokens, 8 q / 8 kv heads, d 128, page 512), three ways:

  current    dequantize K/V tiles: bf16(bf16(x) * bf16(per-token scale))
  postscale  K/V cast only; the per-token scales go on the scores and on p
  int8mm     q and p quantized per row in the kernel (IEEE division, round
             half to even), int8 products with int32 sums

each in two scale layouts: ``_t`` reads the cache's own rows (n_kv,
n_pages, 1, page); without it, a page-major (n_kv, n_pages, page, 1) copy
that ``main`` builds.  The tool as committed reads the cache's scales
through page-major block shapes and returns NaN; the port computes the
function the tool was written for.  The kernel is ``exp_paged_decode``: the
decode's tensor-core body (``csrc/decode_tc.cuh``), each strategy a
compiled policy (``native.DECODE_VARIANTS``): ``postscale`` the serving
decode's int8 instantiation, ``current`` with K and V scaled in bf16,
``int8mm`` on integer products; a slot's live pages (p < ceil(length /
page), tokens below the length) split over CTAs as the serving decode's
(``native.exp_decode_plan``), except int8mm's, whose p codes take each
page's running maximum: one CTA walks a (slot, kv head)'s pages in order.
It takes G <= 16 query rows a kv head and pages of 64-512 keys, a multiple
of 64.

    python -m tf_flash_attention_tpu_torch.experiments.exp_decode
"""

from __future__ import annotations

import math

import torch

from .. import native
from ..ops.kernel_common import LOG2E, NEG_INF_F32
from ._steps import bf16r, div, require_cuda

__all__ = ["VARIANTS", "paged_decode", "paged_decode_plain", "decode_walk", "page_major",
           "main"]

VARIANTS = ("current", "postscale", "postscale_t", "int8mm", "int8mm_t")


def page_major(scales):
    """The cache's scales (n_kv, n_pages, 1, page) as the page-major
    (n_kv, n_pages, page, 1) copy the variants without ``_t`` read."""
    return scales.transpose(2, 3).contiguous()


def _check_layout(variant, k_scales):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    axis = 2 if variant.endswith("_t") else 3
    if k_scales.dim() != 4 or k_scales.shape[axis] != 1:
        layout = "(n_kv, n_pages, 1, page)" if axis == 2 else "(n_kv, n_pages, page, 1)"
        raise ValueError(f"{variant} reads scales {layout}, got {tuple(k_scales.shape)}")


def paged_decode_plain(variant, q, k_pages, v_pages, k_scales, v_scales, tables, lengths,
                       codes: bool = False):
    """The kernel's function in PyTorch: q (S, n_q, d) bf16 -> o, or with
    ``codes`` (int8mm) (o, q codes, integer scores, p codes) as
    ``native.exp_paged_decode`` returns them."""
    _check_layout(variant, k_scales)
    m, l, acc, qc, s_all, p_all = decode_walk(variant.removesuffix("_t"), q, k_pages, v_pages,
                                              k_scales, v_scales, tables, lengths)
    S, n_q, d = q.shape
    o = (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype).reshape(S, n_q, d)
    if not codes:
        return o
    return (o, qc.to(torch.int8).reshape(S, n_q, d), s_all.reshape(S, n_q, -1),
            p_all.reshape(S, n_q, -1))


def decode_walk(strategy, q, k_pages, v_pages, k_scales, v_scales, tables, lengths):
    """The plain version's walk over each slot's live pages, a page a merge:
    float32 (m, l, acc) (S, n_kv, G, 1 | d), and int8mm's q codes (S, n_kv,
    G, d), integer scores and p codes (S, n_kv, G, max_pages * page), zero
    past the live pages (else None, and zeros)."""
    S, n_q, d = q.shape
    n_kv, n_pages, page, _ = k_pages.shape
    G, max_pages = n_q // n_kv, tables.shape[1]
    c = 1.0 / math.sqrt(d) * LOG2E
    ks, vs = k_scales.reshape(n_kv, n_pages, page), v_scales.reshape(n_kv, n_pages, page)
    counts = torch.clamp(-(-lengths.long() // page), max=max_pages)
    qf = q.float().reshape(S, n_kv, G, d)
    qc = None
    if strategy == "int8mm":
        qs = div(qf.abs().amax(-1, keepdim=True), 127.0)
        qs = torch.where(qs == 0, torch.ones_like(qs), qs)
        qc = torch.round(qf / qs)
    m = torch.full((S, n_kv, G, 1), NEG_INF_F32, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((S, n_kv, G, d), dtype=torch.float32, device=q.device)
    s_all = torch.zeros((S, n_kv, G, max_pages * page), dtype=torch.int32, device=q.device)
    p_all = torch.zeros_like(s_all, dtype=torch.int8)
    for p in range(int(counts.max().item()) if S else 0):
        live = (p < counts)[:, None, None, None]
        phys = torch.where(p < counts, tables[:, p].long(), 0)
        kk = k_pages[:, phys].transpose(0, 1).float()               # (S, n_kv, page, d)
        vv = v_pages[:, phys].transpose(0, 1).float()
        kss, vss = ks[:, phys].transpose(0, 1), vs[:, phys].transpose(0, 1)   # (S, n_kv, page)
        valid = (p * page + torch.arange(page, device=q.device))[None, :] < lengths[:, None]
        if strategy == "current":
            kd = bf16r(kk * bf16r(kss)[..., None])
            s = torch.einsum("shgd,shtd->shgt", qf, kd) * c
        elif strategy == "postscale":
            s = torch.einsum("shgd,shtd->shgt", qf, kk) * (kss * c)[:, :, None, :]
        else:   # integer products: exact in float32 (|sum| < 2**24)
            si = torch.einsum("shgd,shtd->shgt", qc, kk)
            s = si * ((qs * kss[:, :, None, :]) * c)
            s_all[..., p * page:(p + 1) * page] = torch.where(live, si, 0).to(torch.int32)
        s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF_F32))
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        pw = torch.exp2(s - m_next)
        l_next = alpha * l + pw.sum(-1, keepdim=True)
        if strategy == "current":
            pv = torch.einsum("shgt,shtd->shgd", bf16r(pw), bf16r(vv * bf16r(vss)[..., None]))
        elif strategy == "postscale":
            pv = torch.einsum("shgt,shtd->shgd", bf16r(pw * vss[:, :, None, :]), vv)
        else:
            y = pw * vss[:, :, None, :]
            ps = div(y.amax(-1, keepdim=True), 127.0)
            ps = torch.where(ps == 0, torch.ones_like(ps), ps)
            pc = torch.round(y / ps)
            p_all[..., p * page:(p + 1) * page] = torch.where(live, pc, 0).to(torch.int8)
            pv = torch.einsum("shgt,shtd->shgd", pc, vv) * ps
        m = torch.where(live, m_next, m)
        l = torch.where(live, l_next, l)
        acc = torch.where(live, acc * alpha + pv, acc)
    return m, l, acc, qc, s_all, p_all


def paged_decode(variant, q, k_pages, v_pages, k_scales, v_scales, tables, lengths,
                 codes: bool = False):
    """One variant: the ``exp_paged_decode`` kernel for CUDA tensors, its plain
    version for CPU tensors.  Scales in the variant's layout (``_t``: the
    cache's (n_kv, n_pages, 1, page); else ``page_major``'s)."""
    _check_layout(variant, k_scales)
    if not q.is_cuda:
        return paged_decode_plain(variant, q, k_pages, v_pages, k_scales, v_scales, tables,
                                  lengths, codes)
    return native.exp_paged_decode(variant.removesuffix("_t"), q, k_pages, v_pages, k_scales,
                                   v_scales, tables, lengths, 1.0 / math.sqrt(q.shape[-1]) * LOG2E,
                                   codes)


def main():
    from ..serving.kv_cache import KVCacheConfig, PageAllocator, PagedKVCache, write_prompt
    from ..utils.profiling import H100_SXM, device_time

    dev = require_cuda("exp_decode")
    max_seqs, seq_len = 16, 8192
    n_kv, n_q, d, page = 8, 8, 128, 512
    pps = seq_len // page
    cfg = KVCacheConfig(n_kv_heads=n_kv, head_dim=d, page_size=page,
                        n_pages=max_seqs * pps + 1, max_seqs=max_seqs,
                        max_pages_per_seq=pps, quantized=True)
    cache = PagedKVCache.create(cfg, dev)
    alloc = PageAllocator(cfg.n_pages - 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    uni = lambda shape: torch.rand(shape, generator=gen, device=dev) * 2 - 1
    kfull = torch.empty((max_seqs, n_kv, seq_len, d), device=dev)
    vfull = torch.empty_like(kfull)
    for slot in range(max_seqs):
        kfull[slot], vfull[slot] = uni((n_kv, seq_len, d)), uni((n_kv, seq_len, d))
        write_prompt(cache, cfg, slot, alloc.alloc(slot, pps), kfull[slot].to(torch.bfloat16),
                     vfull[slot].to(torch.bfloat16))
    q = uni((max_seqs, n_q, d)).to(torch.bfloat16)
    scales = {True: (cache.k_scales, cache.v_scales),
              False: (page_major(cache.k_scales), page_major(cache.v_scales))}

    # dense oracle on the bf16 inputs before quantization
    qf = q.float().reshape(max_seqs, n_kv, 1, d)
    s = torch.einsum("bhqd,bhtd->bhqt", qf, kfull) / math.sqrt(d)
    oref = torch.einsum("bhqt,bhtd->bhd", torch.softmax(s, -1), vfull)

    bytes_step = max_seqs * seq_len * n_kv * (2 * d + 2 * 4)
    t_hbm = bytes_step / H100_SXM.hbm_bytes
    print(f"device={torch.cuda.get_device_name(0)}", flush=True)
    for variant in VARIANTS:
        args = (variant, q, cache.k_pages, cache.v_pages, *scales[variant.endswith("_t")],
                cache.page_tables, cache.lengths)
        out = paged_decode(*args)
        err = float((out.float().reshape(oref.shape) - oref).abs().max())
        err_plain = float((out.float() - paged_decode_plain(*args).float()).abs().max())
        dt = device_time(paged_decode, args, n=10, reps=3)
        finite = bool(torch.isfinite(out).all())
        print(f"{variant:10s}: {dt * 1e3:.3f} ms/step, {max_seqs / dt:,.0f} tok/s, "
              f"{t_hbm / dt:.0%} of bw bound, max|err|={err:.4f} (vs plain {err_plain:.2e}, "
              f"finite {finite})", flush=True)


if __name__ == "__main__":
    main()
