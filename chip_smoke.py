#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before the final line):
  0. device: requires CUDA (no CPU fallback); prints the card's name and
     power limit as nvidia-smi reports them;
  1. build: compiles every kernel source in csrc/ with nvcc, one process
     per source, all at once; prints each source's seconds and ptxas's
     registers, spills and serialized wgmma of the experiment forwards, the
     tensor-core q-outer backward and prefill, and any kernel that spills;
  2. kernels: each of the four serving kernels against its plain PyTorch
     version on the card, at the serving slice's shapes (int8 cache, 8 kv
     heads, d 128, page 256, chunk 512, 16 slots), plus a GQA (8 q / 2 kv)
     case and an unquantized bf16 case; the KV writes must match bit for
     bit outside the trash page, the attention kernels within 2 bf16 ulps
     at the output's scale, no floor; prints errors, median times (CUDA
     events) and bounds, and the body each paged_prefill launch ran (it
     must be the one native.prefill_body names: the tensor cores for bf16
     activations at head_dim_store 128 on pages of a multiple of 64); on the
     tensor-core body, the int8 case also times one
     scaled_dot_product_attention on the chunk's K/V gathered and widened to
     bf16 beforehand, with the causal offset mask (row 13's library
     yardstick);
  2b. the same for fp8 e4m3, fp8 e5m2 and int4 caches (int4 also at page
     512), and paged_multitoken_decode at gamma 4 on int8, bf16, fp8 e4m3
     and int4 caches, at 8/8 heads and GQA 8 q / 2 kv; then shapes the JAX
     package takes that the kernels once refused: GQA 16/2 at gamma 4 (32 query
     rows a kv head), head_dim 384 (all four kernels; and the bf16 gamma 4
     decode), page 16;
  3. engine: the 168M decoder (vocab 32768, d_model 1024, 8 layers, 8/8
     heads, d_head 128, d_ff 4096, bf16) with random weights from the seed
     serves 18 requests (prompts of 300-1900 tokens, two sharing a
     page-aligned prefix, 32 greedy tokens each) on 16 slots; checks the
     outputs, the prefix-cache hit and that its four kernels launched; every
     engine run (3-3e) names its prefill's body and prints its prefill
     tokens/s beside the rate on the scalar prefill;
  3b. the same engine with speculative_tokens=3 serves those 18 requests,
     2 whose prompts repeat a 64-token pattern and 2 sampled ones
     (temperature 0.8, top-k 50); paged_multitoken_decode and kv_append
     must launch; prints spec_stats, tokens per step and the share of
     greedy requests equal to phase 3's;
  3c. the same model on an fp8 e4m3 cache (page 256) and on an int4 cache
     (page 512, 81 pages, 8 a sequence) with and without speculation, 8
     requests each; every run must launch its kernels on its payload;
  3d. a lossless gate: 2 layers at the 168M width in float32, unquantized
     cache, with and without speculation, with every draft right and with
     every draft wrong: the greedy tokens must agree up to each request's
     first top-2 logit tie (gap under 1e-3);
  3e. context-parallel serving, 4 shards on the card (a mesh of cuda:0
     repeated): (a) the sequence-sharded variants (paged_decode causal and
     in a window of 1024, paged_multitoken_decode at gamma 4, paged_prefill
     on a 512-token chunk at 12,288, each with its (l, m) outputs, page
     stride and offset; kv_chunk_write on int8 and int4) on every shard
     against their plain versions, at 16 slots, int8, page 256, global
     lengths 1,000-16,000, 8/8 heads and GQA 8 q / 2 kv; the merge of the
     4 shards against the flat kernel on the same tokens; (b) the 168M
     engine with cp = 4 (int8, page 256, 8 slots, 16 local pages a
     sequence, 129 pages a shard) on 8 requests of 4,000-15,000 prompt
     tokens, and with speculation on 4 pattern prompts, against the flat
     engine on the same requests (the last prompt token's logits within
     the bf16 tolerance of phase 4); it must launch every variant; (c) a
     float32 gate: all 8 layers, unquantized cache, 4 prompts of
     4,000-15,000 tokens, cp = 4 with and without speculation against the
     flat engine: the last prompt token's logits within half the tie gap,
     equal greedy tokens up to each request's first top-2 logit tie;
  4. the same weights on the CPU (plain versions) and on the card: the
     logits of a 512-token prompt's last token must agree;
  5. the op path's ten kernels (the table-driven forward, kv-outer and
     q-outer fused backward and split dQ / dK-dV pair; the banded and
     resident forward and the banded fused backward; the single-window
     forward and fused backward) driven through the public functions on
     the routes the JAX package takes, each case's outputs and gradients
     held against the plain path on the card, each case's launches counted
     on its own: (a) the training slice (B*H, S, d) = (64, 2048, 128) bf16
     causal (banded); (b) the same with FA_FUSED_BWD=0 (the split pair);
     (c) GQA 8 q / 2 kv heads through mha; (d) fp32 local_1d (window 5,
     stride 2, causal, scale_front) with q != k lengths (window); (e) fp16
     local_2d (scale_end) with d != v_d; (f) the slice with the band routes
     switched off (the table kernels); (g) the slice with FA_RESIDENT=1;
     (i) d = v_d = 384, (16, 1024) bf16 causal (the tensor-core forward's
     widest class below 512, the backward's third tile class); (j), (k)
     fp16 causal at (16, 1024, 128), banded and table; (l) bf16 causal at
     d = 576, v_d = 64, (8, 1024), banded and resident (d past the
     tensor-core classes: the scalar forward); (m) the resident route on
     fp16 at (16, 1024, 128); (h) the
     q-outer backward, which only a direct call with fused="q" reaches, as
     in the JAX package (bf16 at d 128: the tensor-core q-outer body, as
     its launch reports it), timed at (h)'s shape beside flash_bwd_fused and
     scaled_dot_product_attention(enable_gqa=True) forward + backward; then
     each kernel's median CUDA-event time against
     its plain version, with useful TFLOP/s priced from flops.py's
     schedule by the products each kernel computes (flash_fwd, banded_fwd
     and resident_fwd on bf16 run the tensor-core forward, resident_fwd as
     persistent CTAs walking the rows in order by groups: its row prints
     the grid, the work items and the rows a group its launch reports and
     is set beside banded_fwd;
     flash_bwd_fused, banded_bwd and flash_bwd_qouter the tensor-core
     backwards: each row names its body), banded_bwd once more without dQ
     (what dQ's product
     and its reduction into the float32 accumulator cost), and the
     accumulator's zero fill and scale-and-cast passes;
  6. training at full width: the same 168M decoder (fp32 parameters, bf16
     compute) takes 5 AdamW steps on one seeded batch of 8 x 2048 tokens;
     the first step's loss and gradient norm must match the plain path on
     the card, the loss must fall, and the five steps must launch the
     banded kernels; prints step ms and tokens/s;
  7. one step of the same model at 1 x 512 tokens on the CPU (plain
     versions) and on the card (kernels): the losses must agree;
  8. the experiment tools' kernels (experiments/), every instantiation the
     tools run at the tools' own shapes, driven once through the modules'
     wrappers with the launch counts reset just before: exp_resident's
     seven (block_q, block_kv) pairs, exp_vpu_attrib's six rungs,
     exp_kv_unroll's four variants ((8, 4096, 128) bf16), exp_int4_unpack's
     six kernels (16 rows x 8 kv heads x 8 queries over 8192 shared tokens)
     and exp_decode's five variants (16 slots x 8192 tokens, int8, page
     512); each held against its plain version (2 bf16 ulps at the output's
     scale, bitcast 3; int8mm's codes and integer scores bit for bit) and
     timed beside its plain version, its bound and, for the forwards, one
     scaled_dot_product_attention call; the forwards name their body
     (exp_resident on the resident tensor-core forward: each pair timed
     through the tool's entry, its prescale included, and its kernel alone
     on the prescaled q, with the items and CTAs its launch reports, and
     held against the dense causal oracle within 1e-2 as well); then, at
     the tool's shape, resident_fwd and exp_resident_fwd at 128-row items
     and 128-key merges, each timed in windows of 2 and of 20 calls.

The kernels' JSON line gives each kernel's launches from the run of the
path that takes it by default ("path": the engine, the speculative engine,
the training steps or the op path's public calls), its error, its times,
its bound (the larger of its bytes over 3.35 TB/s and its products over
the peak of their type) and the time of one PyTorch call computing the same
function (null where there is none); the serving kernels add the payloads
held against their plain versions, each payload's time, and their launches
in phase 3c.  The four sequence-sharded variants follow as kernels of their
own ("paged_decode[cp]", ...; launches from the cp engine of phase 3e, times
from 3e(a) on shard 0), then the ten experiment kernels (phase 8; the
numbers of each tool's first variant, every variant's under "variants").
The last lines are that JSON object, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# bf16 activations: a logit differs by a few bf16 ulps between two matmul
# orders; 8 layers of bf16 residual rounding bound the CPU-vs-card drift
LOGIT_ATOL = 0.1
# serving attention (phases 2-3e): kernel and plain version round q and p
# to bf16 at the same points and sum in other orders, so an output element
# parts by a rounding flip, one bf16 ulp of its own magnitude (at most 2**-7
# of the largest): allow 2 ulps at the output's magnitude, with no floor
# (the random caches give outputs well below 1)
def attn_tol(ref):
    return 2 * 2.0 ** -8 * float(ref.abs().max())


# op kernels (phase 5): float32 differs from its plain version by summation
# order only, 1e-5 at the output's scale (the reference model allows
# 1e-6 * k_len, 2e-3 at k_len 2000); half outputs are rounded once by both
# sides from float32: 2 ulps of the output type at the tensor's scale (the
# reference model allows 1e-3 * k_len)
def op_tol(dtype, ref):
    ulp = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}[dtype]
    return 2 * ulp * max(1.0, float(ref.float().abs().max()))


# lossless gate (phase 3d): a top-2 logit gap under this is a tie, where
# two float32 runs that sum in other orders may pick either token
GAP_TIE = 1e-3
# sequence-sharded variants (phase 3e): l sums the same float32 p, and m is
# the maximum of the same float32 logits, as their plain versions; they part
# by summation order only: l within this relative error, m within it times
# max(1, |m|)
LM_RTOL = 1e-5
# context-parallel float32 gate (phase 3e(c)): cp and flat compute the same
# float32 attention and part by the merge's summation order only (~1e-6 of
# a logit through 8 layers); a logit error under half the tie gap cannot
# flip a greedy token that is not a tie, while a lost or mis-weighted shard
# moves the logits by far more
CP_F32_LOGIT_ATOL = GAP_TIE / 2

# training (phase 6): kernels and plain path both compute attention in
# float32 and round o to bf16, so they part only where a rounding flips (one
# bf16 ulp); through 8 bf16 layers that moves the mean loss (~10.4) by far
# less than 2e-3, and the gradient norm by less than 1%
TRAIN_LOSS_ATOL = 2e-3
TRAIN_GNORM_RTOL = 1e-2
# the step's median before the experiment forwards moved to the tensor
# cores (H100 80GB HBM3 at 700 W; PERF.md section 5), which the step should
# not move: printed beside this run's
STEP_MS_BEFORE = 88.142
# the engines' prefill rates before paged_prefill moved to the tensor cores
# (tokens/s, wall clock, which moves by tens of percent from run to run; H100
# 80GB HBM3 at 700 W; PERF.md section 5): printed beside this run's
PREFILL_TOKS_BEFORE = {"engine": 43432.9, "speculative": 43340.6, "e4m3": 44052.6,
                       "int4 speculative": 47078.3, "int4": 40867.0, "cp engine": 18781.4,
                       "cp engine speculative": 17767.2, "flat engine": 22850.6,
                       "flat engine speculative": 21290.3}
# CPU vs card (phase 7): bf16 matmuls accumulate in other orders on the two
# devices; the mean of 512 token losses agrees to well under 1e-2
CPU_LOSS_ATOL = 1e-2


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, n=20):
    """Median device time of ``fn()`` in ms: CUDA events around 5 windows of
    ``n // 5`` back-to-back calls after a warm-up (the port's
    ``utils/profiling.device_time``)."""
    from tf_flash_attention_tpu_torch.utils.profiling import device_time
    return device_time(fn, (), n=max(1, n // 5), reps=5) * 1e3


def bound(n_bytes, n_ops, ops_type):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the peak of their type, at the H100 SXM's published
    rates (``utils/profiling.H100_SXM``)."""
    from tf_flash_attention_tpu_torch.utils.profiling import H100_SXM
    peak = {"bf16": H100_SXM.mxu_bf16_flops, "f32": H100_SXM.mxu_fp32_flops,
            "int8": H100_SXM.mxu_int8_ops}[ops_type]
    t_bytes = n_bytes / H100_SXM.hbm_bytes * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# cache payloads by name: the quant_dtype, or None for an unquantized bf16 cache
PAYLOADS = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2,
            "int4": "int4", "bf16": None}


def payload_cfg(payload, **kw):
    from tf_flash_attention_tpu_torch.serving.kv_cache import KVCacheConfig
    qd = PAYLOADS[payload]
    return KVCacheConfig(quantized=qd is not None, quant_dtype=torch.int8 if qd is None else qd,
                         dtype=torch.bfloat16, **kw)


def token_bytes(cfg):
    """Stored bytes of one token of one kv head: payload and scale."""
    if not cfg.quantized:
        return cfg.head_dim_store * cfg.payload_dtype.itemsize
    return cfg.head_dim_store / cfg.tok_pack + 4


def make_cache(cfg, dev, gen, lengths, mapped=8):
    """A cache with random contents: ``mapped`` pages per slot, given lengths."""
    from tf_flash_attention_tpu_torch.serving.kv_cache import PagedKVCache
    cache = PagedKVCache.create(cfg, dev)
    fill_random(cache, cfg, dev, gen)
    S = cfg.max_seqs
    perm = torch.randperm(cfg.n_pages - 1, generator=gen, device=dev)[:S * mapped]
    cache.page_tables[:, :mapped] = perm.reshape(S, mapped).to(torch.int32)
    cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32, device=dev))
    return cache


def fill_random(cache, cfg, dev, gen):
    """Random pages and scales: quantized payloads span their type's range;
    scales bring every payload to values of the same size as int8's."""
    from tf_flash_attention_tpu_torch.serving.kv_cache import _quant_max
    for pages in (cache.k_pages, cache.v_pages):
        if cfg.is_int4:
            pages.copy_(torch.randint(-128, 128, pages.shape, generator=gen, device=dev))
        elif cfg.quantized and cfg.quant_dtype == torch.int8:
            pages.copy_(torch.randint(-127, 128, pages.shape, generator=gen, device=dev))
        elif cfg.quantized:
            qmax = _quant_max(cfg.quant_dtype)
            x = torch.randn(pages.shape, generator=gen, device=dev) * (qmax / 8)
            pages.copy_(x.clamp(-qmax, qmax))
        else:
            pages.copy_(torch.randn(pages.shape, generator=gen, device=dev))
    if cfg.quantized:
        unit = 127.0 / _quant_max(cfg.quant_dtype)
        for sc in (cache.k_scales, cache.v_scales):
            sc.copy_((0.005 + 0.02 * torch.rand(sc.shape, generator=gen, device=dev)) * unit)


def clone_cache(c):
    return dataclasses.replace(c, **{f.name: (None if getattr(c, f.name) is None
                                              else getattr(c, f.name).clone())
                                     for f in dataclasses.fields(c)})


def _raw(x):
    """One-byte payloads as their bytes: fp8 compares bit for bit."""
    return x.view(torch.uint8) if x.element_size() == 1 else x


def diff_outside_trash(a, b, trash):
    """Names and mismatch counts of the cache tensors that differ."""
    diffs = []
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        x, y = getattr(a, name), getattr(b, name)
        if x is not None and not torch.equal(_raw(x[:, :trash]), _raw(y[:, :trash])):
            diffs.append(f"{name}: {int((_raw(x[:, :trash]) != _raw(y[:, :trash])).sum())} "
                         f"elements")
    return diffs


def kernel_case(name, n_q, n_kv, payload, dev, gen, page_size=256, gamma=None, d=128):
    """Phase 2 for one configuration, at the serving slice's shapes (d 128, 16
    slots of up to 2048 tokens, chunk 512): the four kernels, or with
    ``gamma`` only paged_multitoken_decode.  Returns {kernel: {err, ms,
    plain_ms, bound_ms, bound_by}}; bounds count this case's data (live
    tokens, visible pairs)."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule
    from tf_flash_attention_tpu_torch.ops.kernel_common import LOG2E
    from tf_flash_attention_tpu_torch.serving import decode, kv_cache, prefill

    S, chunk, mapped = 16, 512, 2048 // page_size
    cfg = payload_cfg(payload, n_kv_heads=n_kv, head_dim=d, page_size=page_size,
                      n_pages=S * mapped + S + 1, max_seqs=S, max_pages_per_seq=2 * mapped)
    trash = cfg.n_pages - 1
    lengths = torch.randint(1, 2048, (S,), generator=gen, device=dev).tolist()
    lengths[3] = 0          # an empty slot: decode gives exact zeros
    lengths[5] = 512        # a length on a page boundary
    cache = make_cache(cfg, dev, gen, lengths, mapped)
    bf = torch.bfloat16
    tok = token_bytes(cfg)
    act = 2                 # bf16 activations
    scale = 1.0 / d ** 0.5
    rule = CausalRule()
    out = {}

    def record(kernel, err, kern, plain, n_bytes, n_ops):
        b_ms, b_by = bound(n_bytes, n_ops, "bf16")
        out[kernel] = dict(err=err, ms=time_ms(kern), plain_ms=time_ms(plain), bound_ms=b_ms,
                           bound_by=b_by)

    def check_attn(kernel, o, ref):
        torch.cuda.synchronize()
        err = float((o.float() - ref.float()).abs().max())
        if not torch.isfinite(o).all() or err > attn_tol(ref):
            fail(f"{name}: {kernel} max error {err} > {attn_tol(ref)}")
        return err

    if gamma is not None:
        # K5 paged_multitoken_decode: every live slot's lengths count gamma drafts
        q = torch.randn((S, gamma, n_q, d), generator=gen, device=dev).to(bf)
        o = decode.paged_multitoken_decode(q, cache, cfg)
        ref = decode._paged_multitoken_decode_plain(q, cache, cfg, scale, rule)
        err = check_attn("paged_multitoken_decode", o, ref)
        if not torch.equal(o[3], torch.zeros_like(o[3])):
            fail(f"{name}: paged_multitoken_decode empty slot is not zero")
        live = sum(lengths)
        pairs = sum(n - gamma + i + 1 for n in lengths if n for i in range(gamma))
        record("paged_multitoken_decode", err,
               lambda: native.paged_multitoken_decode(q, cache, cfg, scale * LOG2E, rule),
               lambda: decode._paged_multitoken_decode_plain(q, cache, cfg, scale, rule),
               2 * n_kv * live * tok + 2 * q.numel() * act, 4 * n_q * d * pairs)
    else:
        # K3 kv_chunk_write: a chunk crossing pages, with padding rows (an odd
        # true_len: an int4 byte row half padding)
        start, true_len = 1100, 451
        k = torch.randn((n_kv, chunk, d), generator=gen, device=dev).to(bf)
        v = torch.randn((n_kv, chunk, d), generator=gen, device=dev).to(bf)
        ck, cp = clone_cache(cache), clone_cache(cache)
        kv_cache.write_tokens_at(ck, cfg, 0, start, k, v, true_len, trash)
        kv_cache._write_tokens_plain(cp, cfg, 0, start, k, v, true_len, trash)
        torch.cuda.synchronize()
        diffs = diff_outside_trash(ck, cp, trash)
        if diffs:
            fail(f"{name}: kv_chunk_write differs from its plain version: {diffs}")
        record("kv_chunk_write", 0.0,
               lambda: native.kv_chunk_write(ck, cfg, 0, start, k, v, true_len, trash),
               lambda: kv_cache._write_tokens_plain(cp, cfg, 0, start, k, v, true_len, trash),
               2 * n_kv * true_len * (d * act + tok), 0)

        # K4 kv_append: two inactive slots; int4 lengths land on both nibbles
        kn = torch.randn((S, n_kv, d), generator=gen, device=dev).to(bf)
        vn = torch.randn((S, n_kv, d), generator=gen, device=dev).to(bf)
        active = torch.ones(S, dtype=torch.bool, device=dev)
        active[3] = active[7] = False
        ck, cp = clone_cache(cache), clone_cache(cache)
        for _ in range(2):
            kv_cache.append_tokens_batched(ck, cfg, kn, vn, active, trash)
            kv_cache._append_plain(cp, cfg, kn, vn, active, trash)
            cp.lengths += active.to(torch.int32)
        torch.cuda.synchronize()
        diffs = diff_outside_trash(ck, cp, trash)
        if diffs or not torch.equal(ck.lengths, cp.lengths):
            fail(f"{name}: kv_append differs from its plain version: {diffs}")
        record("kv_append", 0.0, lambda: native.kv_append(ck, cfg, kn, vn, active, trash),
               lambda: kv_cache._append_plain(cp, cfg, kn, vn, active, trash),
               2 * kn.numel() * act + 2 * int(active.sum()) * n_kv * tok, 0)

        # K1 paged_decode
        q = torch.randn((S, n_q, d), generator=gen, device=dev).to(bf)
        o = decode.paged_decode_attention(q, cache, cfg)
        ref = decode._paged_decode_plain(q, cache, cfg, scale, rule)
        err = check_attn("paged_decode", o, ref)
        if not torch.equal(o[3], torch.zeros_like(o[3])):
            fail(f"{name}: paged_decode empty slot is not zero")
        live = sum(lengths)
        record("paged_decode", err,
               lambda: native.paged_decode(q, cache, cfg, scale * LOG2E, rule),
               lambda: decode._paged_decode_plain(q, cache, cfg, scale, rule),
               2 * n_kv * live * tok + 2 * q.numel() * act, 4 * n_q * d * live)

        # K2 paged_prefill: a chunk at position 1024 of slot 0 (a cached prefix)
        start, true_len = 1024, 512
        qp = torch.randn((chunk, n_q, d), generator=gen, device=dev).to(bf)
        o = prefill.paged_prefill_attention(qp, cache, cfg, 0, start, true_len)
        ran = prefill_ran("paged_prefill", cfg, name)
        qs = (qp.float() * torch.tensor(scale * LOG2E, dtype=torch.float32)).to(bf)
        ref = prefill._paged_prefill_plain(qs, cache, cfg, 0, start, true_len, rule)
        err = check_attn("paged_prefill", o[:true_len], ref[:true_len])
        total = start + true_len
        pairs = sum(start + i + 1 for i in range(true_len))
        count = -(-total // page_size)
        record("paged_prefill", err,
               lambda: native.paged_prefill(qs, cache, cfg, 0, start, total, 0, count, rule),
               lambda: prefill._paged_prefill_plain(qs, cache, cfg, 0, start, true_len, rule),
               2 * n_kv * total * tok + 2 * qp.numel() * act, 4 * n_q * d * pairs)
        out["paged_prefill"].update(ran)
        if ran["body"] == "tensor-core":
            # the library yardstick: one scaled_dot_product_attention on the
            # chunk's K/V gathered and widened to bf16 beforehand, with the
            # causal offset mask (the lowest time a library route could reach)
            k_all, v_all = gathered_kv(cache, cfg, 0, total)
            q4 = qp.permute(1, 0, 2).unsqueeze(0)
            mask = (torch.arange(total, device=dev)[None, :]
                    <= start + torch.arange(chunk, device=dev)[:, None])
            gqa = dict(enable_gqa=True) if n_q != n_kv else {}
            lib = lambda: F.scaled_dot_product_attention(q4, k_all[None], v_all[None],
                                                         attn_mask=mask, **gqa)
            lib_o = lib()[0].permute(1, 0, 2)
            out["paged_prefill"].update(library_ms=time_ms(lib),
                                        library_err=float((lib_o.float() - ref.float())
                                                          .abs().max()))
    for kname, r in out.items():
        extra = "".join(f" {x}={json.dumps(r[x])}" for x in ("body", "library_ms") if x in r)
        print(f"kernel {name} {kname}: max_abs_err={r['err']} ms={r['ms']} "
              f"plain_ms={r['plain_ms']} bound_ms={r['bound_ms']} ({r['bound_by']}){extra}",
              flush=True)
    return out


def prefill_ran(kernel, cfg, label, act=torch.bfloat16):
    """The body the last launch of ``kernel`` (paged_prefill or its [cp]
    variant) ran, as the launch reports it; fails unless it is the one
    ``native.prefill_body`` names for these activations and cache."""
    from tf_flash_attention_tpu_torch import native
    ran = dict(native.WALKS[kernel])
    if ran["body"] != native.prefill_body(act, cfg):
        fail(f"{label}: {kernel} ran the {ran['body']} body, prefill_body names "
             f"{native.prefill_body(act, cfg)}")
    return ran


def gathered_kv(cache, cfg, slot, total):
    """K and V of a slot's first ``total`` tokens on the card, dequantized and
    widened to bf16, (n_kv, total, head_dim): the library yardstick's input."""
    from tf_flash_attention_tpu_torch.serving.kv_cache import _page_tokens
    phys = cache.page_tables[slot, :-(-total // cfg.page_size)].long()
    out = []
    for pages, scales in ((cache.k_pages, cache.k_scales), (cache.v_pages, cache.v_scales)):
        x, sc = _page_tokens(pages[:, phys], None if scales is None else scales[:, phys], cfg)
        if sc is not None:
            x = x * sc[..., None]
        out.append(x.reshape(cfg.n_kv_heads, -1, x.shape[-1])[:, :total, :cfg.head_dim]
                   .to(torch.bfloat16).contiguous())
    return out


def build_report(native):
    """Each source's nvcc seconds and ptxas's report: every kernel of the
    experiment forwards, the tensor-core q-outer backward and prefill, and
    any other that spills or whose wgmma ptxas serializes."""
    for src, log in sorted(native.BUILD_LOG.items(), key=lambda kv: -kv[1]["seconds"]):
        kernels = native.ptxas_summary(src)
        print(f"build {src}: {log['seconds']:.3f} s, {len(kernels)} kernels, at most "
              f"{max((k['registers'] for k in kernels), default=0)} registers", flush=True)
        for k in kernels:
            if (src == "exp_forward_kernels.cu" or k["spill_stores"] or k["warnings"]
                    or any(b in k["name"] for b in ("qouter_tc", "prefill_tc"))):
                print(f"  ptxas {k['name']}: {k['registers']} registers, spill stores "
                      f"{k['spill_stores']} B, loads {k['spill_loads']} B; "
                      f"{'; '.join(k['warnings']) or 'no warnings'}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # ---- 0: device ----
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"device: {smi.stdout.strip().splitlines()[0]}", flush=True)
    dev = torch.device("cuda", 0)

    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.models.transformer import ModelConfig, init_params
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig
    from tf_flash_attention_tpu_torch.serving.sampling import SamplingParams

    # ---- 1: build (one nvcc per source, all at once) ----
    t0 = time.perf_counter()
    libs = native.build()
    for src in libs:
        native.library(src)
    print(f"build: {sorted(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    build_report(native)

    # ---- 2: kernels against their plain versions ----
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    cases = {"int8": kernel_case("int8_8q8kv", 8, 8, "int8", dev, gen)}
    kernel_case("int8_gqa_8q2kv", 8, 2, "int8", dev, gen)
    cases["bf16"] = kernel_case("bf16_8q8kv", 8, 8, "bf16", dev, gen)
    # ---- 2b: the fp8 and int4 payloads, and the gamma 4 multi-token decode ----
    for payload in ("e4m3", "e5m2", "int4"):
        cases[payload] = kernel_case(f"{payload}_8q8kv", 8, 8, payload, dev, gen)
    cases["int4_page512"] = kernel_case("int4_8q8kv_page512", 8, 8, "int4", dev, gen,
                                        page_size=512)
    for payload in ("int8", "bf16", "e4m3", "int4"):
        mt = kernel_case(f"{payload}_8q8kv_gamma4", 8, 8, payload, dev, gen, gamma=4)
        cases[payload].update(mt)
    # 16 query rows a block; int4 at page 512 is the largest shared memory
    kernel_case("int8_gqa_8q2kv_gamma4", 8, 2, "int8", dev, gen, gamma=4)
    kernel_case("int4_gqa_8q2kv_gamma4_page512", 8, 2, "int4", dev, gen, page_size=512,
                gamma=4)
    # shapes the JAX package takes that the kernels refused before: GQA 8 at
    # gamma 4 (32 query rows a kv head: two row groups), head_dim_store 384,
    # and pages of 16 tokens (below the prefill's 32-key sub-tile)
    kernel_case("int8_gqa_16q2kv_gamma4", 16, 2, "int8", dev, gen, gamma=4)
    kernel_case("int8_8q8kv_d384", 8, 8, "int8", dev, gen, d=384)
    kernel_case("bf16_8q8kv_d384_gamma4", 8, 8, "bf16", dev, gen, gamma=4, d=384)
    kernel_case("int8_8q8kv_page16", 8, 8, "int8", dev, gen, page_size=16)

    # ---- 3: the engine at the 168M configuration ----
    mcfg = ModelConfig(vocab=32768, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8,
                       d_head=128, d_ff=4096, dtype=torch.bfloat16)
    ecfg = EngineConfig(max_seqs=16, page_size=256, n_pages=16 * 8 + 16 + 1,
                        max_pages_per_seq=16, quantized_kv=True, prefill_chunk=512)
    cpu_gen = torch.Generator().manual_seed(args.seed)
    t0 = time.perf_counter()
    cpu_model = init_params(mcfg, cpu_gen, device="cpu")
    n_params = sum(p.numel() for p in cpu_model.parameters())
    print(f"model: {n_params} params, init {time.perf_counter() - t0:.3f} s", flush=True)
    prompt_gen = torch.Generator().manual_seed(args.seed + 1)

    def prompt(n):
        return torch.randint(1, mcfg.vocab, (n,), generator=prompt_gen).tolist()

    lens = torch.randint(300, 1901, (18,), generator=prompt_gen).tolist()
    prompts = [prompt(n) for n in lens]
    shared = prompt(512)                      # two full pages
    prompts[4] = shared + prompt(300)
    prompts[5] = shared + prompt(700)
    n_new = 32

    eng = DecodeEngine(mcfg, cpu_model, ecfg, device=dev)   # casts its own copy
    results, launches = serve("engine", eng, [(p, None) for p in prompts], n_new, mcfg.vocab)
    if eng.prefix_cache.hits < 1:
        fail("the prefix cache never hit")
    kernels_3 = ("paged_decode", "paged_prefill", "kv_chunk_write", "kv_append")
    if min(launches[k] for k in kernels_3) < 1:
        fail(f"a kernel of the path never launched: {launches}")
    greedy_3 = [results[r] for r in range(len(prompts))]
    del eng
    torch.cuda.empty_cache()

    # ---- 3b: speculative serving at full width ----
    pattern = prompt(64)
    reqs = [(p, None) for p in prompts] + [(pattern * 8, None), (pattern * 12, None)]
    sampled = SamplingParams(temperature=0.8, top_k=50)
    reqs += [(prompt(700), sampled), (prompt(1200), sampled)]
    eng = DecodeEngine(mcfg, cpu_model, dataclasses.replace(ecfg, speculative_tokens=3),
                       device=dev)
    results, spec_launches = serve("speculative", eng, reqs, n_new, mcfg.vocab)
    if spec_launches["paged_multitoken_decode"] < 1 or spec_launches["kv_append"] < 1:
        fail(f"speculative serving did not run its kernels: {spec_launches}")
    same = sum(results[r] == greedy_3[r] for r in range(len(prompts)))
    print(f"speculative: spec_stats {json.dumps(eng.spec_stats)}; "
          f"{eng.stats['decode_tokens'] / eng.stats['steps']:.3f} tokens per step; greedy "
          f"requests equal to phase 3's: {same} of {len(prompts)} = {same / len(prompts)}",
          flush=True)
    launches["paged_multitoken_decode"] = spec_launches["paged_multitoken_decode"]
    del eng
    torch.cuda.empty_cache()

    # ---- 3c: fp8 and int4 caches at full width ----
    payload_launches = quantized_engines(mcfg, cpu_model, ecfg, prompts[:8], n_new, dev)

    # ---- 3d: the speculative engine is lossless on the card ----
    lossless_gate(mcfg, args.seed, prompts[:8] + [pattern * 8], n_new, dev)

    # ---- 3e: context-parallel serving, 4 shards on the card ----
    cp_measured, cp_launches = cp_phase(mcfg, cpu_model, args.seed, n_new, dev)

    # ---- 4: logits on the CPU (plain versions) against the card ----
    small = EngineConfig(max_seqs=1, page_size=256, n_pages=18, max_pages_per_seq=16,
                         quantized_kv=True, prefill_chunk=512)
    p = prompt(512)
    n_follow = 16
    outs = {}
    for where in ("cpu", "cuda"):
        e = DecodeEngine(mcfg, cpu_model, small, device=where)
        rid = e.submit(p, max_new_tokens=n_follow)
        e.step()
        logits = e.last_prefill_logits.float().cpu()
        outs[where] = (logits, e.run(max_steps=100)[rid][len(p):])
    err = float((outs["cpu"][0] - outs["cuda"][0]).abs().max())
    if not torch.isfinite(outs["cuda"][0]).all() or err > LOGIT_ATOL:
        fail(f"CPU-vs-card logits differ by {err} > {LOGIT_ATOL}")
    agree = sum(a == b for a, b in zip(outs["cpu"][1], outs["cuda"][1])) / n_follow
    print(f"logits: CPU vs card max_abs_err={err} (tol {LOGIT_ATOL}), "
          f"max |logit| {float(outs['cpu'][0].abs().max())}; "
          f"greedy tokens agreeing {agree}", flush=True)

    # ---- 5: the op path's kernels against the plain path ----
    torch.manual_seed(args.seed)
    op, op_launches = op_phase(dev)

    # ---- 6: training at full width ----
    train_launches = train_phase(mcfg, cpu_model, dev, args.seed)
    # each kernel's count from the run of the path that takes it by default:
    # the training step's (banded) kernels from phase 6, the others from the
    # op path's public calls in phase 5
    path_of = {k: "engine (phase 3)" for k in native.SERVING_KERNELS}
    for k in native.ATTENTION_KERNELS:
        if train_launches.get(k):
            path_of[k], launches[k] = "train step (phase 6)", train_launches[k]
        else:
            path_of[k], launches[k] = "op path (phase 5)", op_launches[k]
    path_of["flash_bwd_qouter"] = "direct call with fused='q' (phase 5h; no public route)"

    # ---- 7: one training step on the CPU (plain versions) and on the card ----
    cpu_card_phase(mcfg, cpu_model, dev, args.seed)

    # ---- 8: the experiment tools' kernels at the tools' shapes ----
    exp_entries, exp_launches = experiment_phase(dev, args.seed)

    csrc = "tf_flash_attention_tpu_torch/csrc/"
    replaces = {
        "paged_decode": "tf_flash_attention_tpu/serving/decode.py:113",
        "paged_multitoken_decode": "tf_flash_attention_tpu/serving/decode.py:113 "
                                   "(gamma > 1, call :477)",
        "paged_prefill": "tf_flash_attention_tpu/serving/prefill.py:49",
        "kv_chunk_write": "tf_flash_attention_tpu/serving/kv_cache.py:286",
        "kv_append": "tf_flash_attention_tpu/serving/kv_cache.py:548",
        "flash_fwd": "tf_flash_attention_tpu/ops/forward.py:57",
        "flash_bwd_fused": "tf_flash_attention_tpu/ops/backward.py:255",
        "flash_bwd_dq": "tf_flash_attention_tpu/ops/backward.py:104",
        "flash_bwd_dkv": "tf_flash_attention_tpu/ops/backward.py:174",
        "banded_fwd": "tf_flash_attention_tpu/ops/forward_banded.py:65",
        "banded_bwd": "tf_flash_attention_tpu/ops/backward.py:457",
        "window_fwd": "tf_flash_attention_tpu/ops/forward_banded.py:165",
        "window_bwd": "tf_flash_attention_tpu/ops/backward.py:377",
        "resident_fwd": "tf_flash_attention_tpu/ops/forward_banded.py:326",
        "flash_bwd_qouter": "tf_flash_attention_tpu/ops/backward.py:541",
    }
    path_of["paged_multitoken_decode"] = "speculative engine (phase 3b)"
    # serving kernels: time and bound of the int8 slice case (phase 2), each
    # payload's beside it; of them only paged_prefill has a single PyTorch
    # call of the same function (phase 2's scaled_dot_product_attention on the
    # gathered K/V)
    measured = {k: {"library_ms": None, **cases["int8"][k]} for k in native.SERVING_KERNELS}
    measured.update(op)
    lines = []
    for k in replaces:
        m = measured[k]
        entry = {"name": k, "route": "cuda", "source": csrc + native.KERNEL_SOURCES[k],
                 "replaces": replaces[k], "launches": launches[k], "path": path_of[k],
                 "max_abs_err": m["err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
                 "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                 "library_ms": m["library_ms"],
                 **{x: m[x] for x in ("body", "library_err", "ms_without_dq", "grid", "items",
                                      "group_rows", "kernel_ms", "gqa") if x in m}}
        if k in native.SERVING_KERNELS:
            entry["payloads_held"] = [pl for pl, c in cases.items() if k in c]
            entry["ms_by_payload"] = {pl: c[k]["ms"] for pl, c in cases.items() if k in c}
            entry["launches_by_payload"] = {pl: n[k] for pl, n in payload_launches.items()}
        lines.append(entry)
    # the sequence-sharded variants: times and bounds of phase 3e(a) on shard
    # 0 (8 q / 8 kv heads), launches of the cp engine (phase 3e(b))
    cp_replaces = {
        "paged_decode[cp]": replaces["paged_decode"] + " (returning_l_m, page_stride, "
                                                       "global_lengths; call :341)",
        "paged_multitoken_decode[cp]": replaces["paged_multitoken_decode"]
        + " (returning_l_m, page_stride, global_lengths)",
        "paged_prefill[cp]": replaces["paged_prefill"] + " (returning_l_m, page_stride; "
                                                         "call :304)",
        "kv_chunk_write[cp]": replaces["kv_chunk_write"] + " (page_stride, _phys :356-365; "
                                                           "call :395)",
    }
    for k in native.CP_VARIANTS:
        m = cp_measured[k]
        lines.append({"name": k, "route": "cuda", "source": csrc + native.KERNEL_SOURCES[k],
                      "replaces": cp_replaces[k], "launches": cp_launches[k],
                      "path": "cp engine (phase 3e)", "max_abs_err": m["err"], "ms": m["ms"],
                      "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                      "bound_by": m["bound_by"], "library_ms": None,
                      **{x: m[x] for x in ("body", "l_err", "m_err", "merge_err", "cp_step_ms",
                                           "flat_ms") if x in m}})
    # the experiment tools' kernels: the numbers of each tool's first
    # variant, every variant's under "variants" (phase 8)
    for k in native.EXPERIMENT_KERNELS:
        m = exp_entries[k]
        lines.append({"name": k, "route": "cuda", "source": csrc + native.KERNEL_SOURCES[k],
                      "replaces": EXP_REPLACES[k], "launches": exp_launches[k],
                      "path": "experiment tools (phase 8)", "max_abs_err": m["err"],
                      "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                      "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                      "variants": m["variants"]})
    print(json.dumps({"kernels": lines}))
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def serve(label, eng, reqs, n_new, vocab):
    """Run ``reqs`` [(prompt, SamplingParams or None)] through ``eng`` with the
    launch counts reset just before; checks every request returns its prompt
    and ``n_new`` tokens of the vocabulary, prints the stats and the rates
    (wall clock; prefill timed around each admission's chunks).  Returns
    ({rid: tokens}, {kernel: launches in this run})."""
    from tf_flash_attention_tpu_torch import native

    prefill_s = [0.0]
    inner = eng._prefill_chunked

    def timed_prefill(p, slot):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = inner(p, slot)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t
        return r

    eng._prefill_chunked = timed_prefill
    rids = [eng.submit(p, max_new_tokens=n_new, **({} if sp is None else {"sampling": sp}))
            for p, sp in reqs]
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: native.LAUNCHES[k] for k in native.SERVING_KERNELS + native.CP_VARIANTS}
    for rid, (p, _) in zip(rids, reqs):
        got = results.get(rid, [])
        if len(got) != len(p) + n_new or got[:len(p)] != p:
            fail(f"{label}: request {rid} returned {len(got)} tokens, expected "
                 f"{len(p) + n_new}")
        if not all(0 <= t < vocab for t in got[len(p):]):
            fail(f"{label}: request {rid} produced a token outside the vocabulary")
    decode_s = wall - prefill_s[0]
    st = eng.stats
    # the body of the run's prefill launches (one shape rule for them all:
    # the last launch's report stands for the run's)
    bodies = {k: prefill_ran(k, eng.ccfg, label, eng.mcfg.dtype)
              for k in ("paged_prefill", "paged_prefill[cp]") if launches[k]}
    print(f"{label}: {len(rids)} requests, stats {json.dumps(st)}, prefix hits "
          f"{eng.prefix_cache.hits if eng.prefix_cache else None}, launches "
          f"{json.dumps(launches)}, prefill bodies {json.dumps(bodies)}", flush=True)
    rate = st['prefill_tokens'] / prefill_s[0]
    before = PREFILL_TOKS_BEFORE.get(label)
    beside = "" if before is None else f" (on the scalar prefill: {before}, {rate / before:.3f}x)"
    print(f"{label}: wall {wall:.3f} s; prefill {st['prefill_tokens']} tokens in "
          f"{prefill_s[0]:.3f} s = {rate:.1f} tokens/s{beside}; "
          f"decode {st['decode_tokens']} tokens in {decode_s:.3f} s over {st['steps']} steps "
          f"= {st['decode_tokens'] / decode_s:.1f} tokens/s", flush=True)
    return results, launches


def quantized_engines(mcfg, cpu_model, ecfg, prompts, n_new, dev):
    """Phase 3c: the 168M engine on an fp8 e4m3 cache (page 256) and on an
    int4 cache (page 512, 81 pages, 8 a sequence) with speculation, each
    serving 8 requests; an int4 run without speculation adds paged_decode.
    Each run must launch its kernels on its payload.  Returns {payload:
    {kernel: launches}}."""
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine

    int4 = dataclasses.replace(ecfg, kv_quant_dtype="int4", page_size=512, n_pages=81,
                               max_pages_per_seq=8)
    runs = [("e4m3", dataclasses.replace(ecfg, kv_quant_dtype=torch.float8_e4m3fn),
             ("paged_decode", "paged_prefill", "kv_chunk_write", "kv_append")),
            ("int4 speculative", dataclasses.replace(int4, speculative_tokens=3),
             ("paged_multitoken_decode", "paged_prefill", "kv_chunk_write", "kv_append")),
            ("int4", int4, ("paged_decode", "paged_prefill", "kv_chunk_write", "kv_append"))]
    counts, outs = {}, {}
    reqs = [(p, None) for p in prompts]
    for label, cfg, kernels in runs:
        eng = DecodeEngine(mcfg, cpu_model, cfg, device=dev)
        results, launches = serve(label, eng, reqs, n_new, mcfg.vocab)
        if min(launches[k] for k in kernels) < 1:
            fail(f"{label}: a kernel of the path never launched: {launches}")
        counts[label] = launches
        outs[label] = [results[r] for r in range(len(prompts))]
        if label == "int4 speculative":
            print(f"int4 speculative: spec_stats {json.dumps(eng.spec_stats)}", flush=True)
        del eng
        torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(outs["int4 speculative"], outs["int4"]))
    print(f"int4: requests equal with and without speculation: {same} of {len(prompts)}",
          flush=True)
    return counts


def top2_gaps(cfg, model, prompts, outs, dev):
    """The top-2 gap of each generated token's logits: a teacher-forced
    forward of the model over each output sequence, on the card."""
    from tf_flash_attention_tpu_torch.models import transformer as tf

    card_model = copy.deepcopy(model).to(dev)
    gaps = []
    with torch.no_grad():
        for p, full in zip(prompts, outs):
            logits = tf.forward(cfg, card_model, torch.tensor([full[:-1]], device=dev))[0]
            top2 = logits[len(p) - 1:].topk(2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).cpu().tolist())
    del card_model
    torch.cuda.empty_cache()
    return gaps


def check_to_tie(label, prompts, want, got, gaps):
    """Fail unless each request's generated tokens equal ``want``'s up to its
    first top-2 logit gap under GAP_TIE (a tie, not a fault)."""
    for i, (p, w, g, gap) in enumerate(zip(prompts, want, got, gaps)):
        tie = next((j for j, x in enumerate(gap) if x < GAP_TIE), len(gap))
        if g[len(p):][:tie] != w[len(p):][:tie]:
            fail(f"{label}: request {i} differs before its first tie (position {tie}, gap "
                 f"{min(gap)}): {g[len(p):]} vs {w[len(p):]}")


def lossless_gate(mcfg, seed, prompts, n_new, dev):
    """Phase 3d: 2 layers at the 168M width in float32 (TF32 off), unquantized
    cache.  Speculative greedy tokens must equal the non-speculative ones up
    to the first position where the non-speculative continuation's top-2
    logit gap is under GAP_TIE (a tie, not a fault), with the n-gram
    proposer, with drafts that are the continuation itself (all accepted),
    and with drafts that are all wrong (none accepted)."""
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    cfg = dataclasses.replace(mcfg, n_layers=2, dtype=torch.float32)
    model = tf.init_params(cfg, torch.Generator().manual_seed(seed + 4), device="cpu")
    ecfg = EngineConfig(max_seqs=16, page_size=256, n_pages=16 * 8 + 16 + 1,
                        max_pages_per_seq=16, quantized_kv=False, prefill_chunk=512)

    def run(spec, propose=None):
        eng = DecodeEngine(cfg, model, dataclasses.replace(ecfg, speculative_tokens=spec),
                           device=dev)
        if propose is not None:
            eng._propose = propose
        rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        res = eng.run(max_steps=10_000)
        return [res[r] for r in rids], eng.stats, eng.spec_stats

    base, _, _ = run(0)
    torch.cuda.empty_cache()
    gaps = top2_gaps(cfg, model, prompts, base, dev)

    def oracle(shift):
        def propose(hist, n_draft):
            for full in base:
                if hist == full[:len(hist)] and len(full) > len(hist):
                    cont = [(t + shift) % cfg.vocab for t in full[len(hist):len(hist) + n_draft]]
                    return cont + [cont[-1]] * (n_draft - len(cont))
            return [(hist[-1] + shift) % cfg.vocab] * n_draft
        return propose

    for label, propose in (("n-gram drafts", None), ("every draft right", oracle(0)),
                           ("every draft wrong", oracle(1))):
        out, stats, spec = run(3, propose)
        check_to_tie(f"lossless gate ({label})", prompts, base, out, gaps)
        ties = [(i, j, x) for i, gap in enumerate(gaps) for j, x in enumerate(gap) if x < GAP_TIE]
        same = sum(a == b for a, b in zip(out, base))
        print(f"lossless gate ({label}): {same} of {len(prompts)} requests equal in full; "
              f"spec_stats {json.dumps(spec)}; {stats['decode_tokens'] / stats['steps']:.3f} "
              f"tokens per step; ties (request, position, gap) {ties}; smallest gap "
              f"{min(min(g) for g in gaps)}", flush=True)
        if propose is not None and label.endswith("right") and spec["accepted"] < 1:
            fail(f"lossless gate: no right draft was accepted: {spec}")
        if label.endswith("wrong") and spec["accepted"] > spec["proposed"] // 20:
            fail(f"lossless gate: wrong drafts were accepted: {spec}")


N_SHARDS = 4


def lm_errors(got, want):
    """(max relative error of l, max error of m over max(1, |m|)) of the
    sharded variants' statistics against their plain versions."""
    (_, gl, gm), (_, wl, wm) = got, want
    l_err = float(((gl - wl).abs() / wl.abs().clamp_min(1e-30)).max())
    if bool(((wl == 0) & (gl != 0)).any()):
        l_err = math.inf
    m_err = float(((gm - wm).abs() / wm.abs().clamp_min(1.0)).max())
    return l_err, m_err


def cp_kernel_case(label, n_q, n_kv, dev, gen, timed):
    """Phase 3e(a) for one head layout: 4 shards on the card, 16 slots, int8
    cache, page 256, global lengths 1,000-16,000 (slot 0 16,000).  Every
    shard's variant against its plain version, and the merge of the 4
    shards against the flat kernel on the same tokens in one flat cache.
    Returns {variant: {err, l_err, m_err, and with ``timed`` ms, plain_ms,
    bound_ms, bound_by}} (times on shard 0)."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule, LocalRule
    from tf_flash_attention_tpu_torch.ops.kernel_common import LOG2E
    from tf_flash_attention_tpu_torch.serving import decode, kv_cache, prefill
    from tf_flash_attention_tpu_torch.serving.seq_sharded_decode import (
        _merge_partials, decode_merged)

    n, S, d, ps = N_SHARDS, 16, 128, 256
    owned = lambda total, r: kv_cache._owned_token_count(total, ps, n, r)
    flat_cfg = payload_cfg("int8", n_kv_heads=n_kv, head_dim=d, page_size=ps,
                           n_pages=S * 64 + 1, max_seqs=S, max_pages_per_seq=64)
    cfg = dataclasses.replace(flat_cfg, n_pages=S * 16 + 1, max_pages_per_seq=16)
    lengths = torch.randint(1000, 16001, (S,), generator=gen, device=dev).tolist()
    lengths[0] = 16000
    glob = torch.tensor(lengths, dtype=torch.int32, device=dev)
    flat = kv_cache.PagedKVCache.create(flat_cfg, dev)
    fill_random(flat, flat_cfg, dev, gen)
    perm = torch.randperm(S * 64, generator=gen, device=dev).reshape(S, 64).to(torch.int32)
    flat.page_tables.copy_(perm)
    flat.lengths.copy_(glob)
    # shard r holds global pages r, r + 4, ... of every slot: the flat pages
    # copied to its pages 16 s .. 16 s + 15
    shards = []
    for r in range(n):
        sc = kv_cache.PagedKVCache.create(cfg, dev)
        idx = perm[:, r::n].reshape(-1).long()
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            getattr(sc, name)[:, :S * 16] = getattr(flat, name)[:, idx]
        sc.page_tables.copy_(torch.arange(S * 16, device=dev, dtype=torch.int32).reshape(S, 16))
        sc.lengths.copy_(torch.tensor([owned(x, r) for x in lengths], dtype=torch.int32,
                                      device=dev))
        shards.append(sc)
    bf, scale, tok, act = torch.bfloat16, d ** -0.5, token_bytes(cfg), 2
    shard = lambda r: dict(returning_l_m=True, page_stride=n, page_offset=r)
    out = {}

    def check(variant, got, want, ref_o):
        torch.cuda.synchronize()
        err = float((got[0].float() - want[0].float()).abs().max())
        l_err, m_err = lm_errors(got, want)
        if (not torch.isfinite(got[0]).all() or err > attn_tol(ref_o) or l_err > LM_RTOL
                or m_err > LM_RTOL):
            fail(f"{label}: {variant} o error {err} (tol {attn_tol(ref_o)}), l relative "
                 f"error {l_err}, m error {m_err} (tol {LM_RTOL})")
        r = out.setdefault(variant, dict(err=0.0, l_err=0.0, m_err=0.0))
        r.update(err=max(r["err"], err), l_err=max(r["l_err"], l_err),
                 m_err=max(r["m_err"], m_err))

    def check_merge(variant, parts, flat_o):
        merged = _merge_partials(parts, dev).to(flat_o.dtype)
        torch.cuda.synchronize()
        err = float((merged.float() - flat_o.float()).abs().max())
        if not torch.isfinite(merged).all() or err > attn_tol(flat_o):
            fail(f"{label}: merged {variant} differs from the flat kernel by {err} > "
                 f"{attn_tol(flat_o)}")
        out[variant]["merge_err"] = max(out[variant].get("merge_err", 0.0), err)

    # paged_decode[cp], causal and in a window of 1024; paged_multitoken_decode[cp]
    q = torch.randn((S, n_q, d), generator=gen, device=dev).to(bf)
    qm = torch.randn((S, 4, n_q, d), generator=gen, device=dev).to(bf)
    for variant, qq, rules in (("paged_decode[cp]", q, (CausalRule(), LocalRule(1024, 0, True))),
                               ("paged_multitoken_decode[cp]", qm, (CausalRule(),))):
        fn = decode.paged_decode_attention if qq.dim() == 3 else decode.paged_multitoken_decode
        plain = (decode._paged_decode_plain if qq.dim() == 3
                 else decode._paged_multitoken_decode_plain)
        for rule in rules:
            parts = []
            for r, sc in enumerate(shards):
                got = fn(qq, sc, cfg, rule=rule, global_lengths=glob, **shard(r))
                want = plain(qq, sc, cfg, scale, rule, True, n, r, glob)
                check(variant, got, want, want[0])
                parts.append(got)
            check_merge(variant, parts, fn(qq, flat, flat_cfg, rule=rule))
    # paged_prefill[cp]: a 512-token chunk at 12,288 of slot 0
    start, chunk = 12288, 512
    qp = torch.randn((chunk, n_q, d), generator=gen, device=dev).to(bf)
    qs = (qp.float() * torch.tensor(scale * LOG2E, dtype=torch.float32)).to(bf)
    parts = []
    for r, sc in enumerate(shards):
        got = prefill.paged_prefill_attention(qp, sc, cfg, 0, start, chunk, **shard(r))
        ran = prefill_ran("paged_prefill[cp]", cfg, label)
        want = prefill._paged_prefill_plain(qs, sc, cfg, 0, start, chunk, CausalRule(), True, n,
                                            r)
        check("paged_prefill[cp]", got, want, want[0])
        out["paged_prefill[cp]"].update(ran)
        parts.append(got)
    check_merge("paged_prefill[cp]", parts,
                prefill.paged_prefill_attention(qp, flat, flat_cfg, 0, start, chunk))
    # kv_chunk_write[cp] on int8 and int4: a chunk crossing pages 4-6 (shards
    # 0-2), an odd true_len (an int4 byte row half padding)
    w_start, w_len = 1100, 451
    k = torch.randn((n_kv, chunk, d), generator=gen, device=dev).to(bf)
    v = torch.randn((n_kv, chunk, d), generator=gen, device=dev).to(bf)
    cfg4 = payload_cfg("int4", n_kv_heads=n_kv, head_dim=d, page_size=ps, n_pages=S * 16 + 1,
                       max_seqs=S, max_pages_per_seq=16)
    int4 = kv_cache.PagedKVCache.create(cfg4, dev)
    fill_random(int4, cfg4, dev, gen)
    int4.page_tables.copy_(shards[0].page_tables)
    for c, ccfg in ((shards, cfg), ([int4] * n, cfg4)):
        for r in range(n):
            ck, cpl = clone_cache(c[r]), clone_cache(c[r])
            kv_cache.write_tokens_at(ck, ccfg, 1, w_start, k, v, w_len, ccfg.n_pages - 1,
                                     n, r)
            kv_cache._write_tokens_plain(cpl, ccfg, 1, w_start, k, v, w_len, ccfg.n_pages - 1,
                                         n, r)
            cpl.lengths[1] = owned(w_start + w_len, r)
            torch.cuda.synchronize()
            diffs = diff_outside_trash(ck, cpl, ccfg.n_pages - 1)
            if diffs or not torch.equal(ck.lengths, cpl.lengths):
                fail(f"{label}: kv_chunk_write[cp] ({ccfg.quant_dtype}, shard {r}) differs "
                     f"from its plain version: {diffs}")
            del ck, cpl
    out["kv_chunk_write[cp]"] = dict(err=0.0)
    if not timed:
        return out

    # times on shard 0 (the other shards' launches are alike), bounds from
    # shard 0's data: its live tokens, and the (query, key) pairs it holds
    sc = shards[0]
    live = sum(owned(x, 0) for x in lengths)
    lm = lambda rows: 2 * rows * 4                     # l and m, float32
    pairs0 = sum(owned(start + i + 1, 0) for i in range(chunk))
    own_rows = sum(1 for t in range(w_len) if ((w_start + t) // ps) % n == 0)   # 180
    runs = {
        "paged_decode[cp]": (
            lambda: native.paged_decode(q, sc, cfg, scale * LOG2E, CausalRule(), True, n, 0,
                                        glob),
            lambda: decode._paged_decode_plain(q, sc, cfg, scale, CausalRule(), True, n, 0, glob),
            2 * n_kv * live * tok + 2 * q.numel() * act + lm(S * n_q), 4 * n_q * d * live),
        "paged_multitoken_decode[cp]": (
            lambda: native.paged_multitoken_decode(qm, sc, cfg, scale * LOG2E, CausalRule(), True,
                                                   n, 0, glob),
            lambda: decode._paged_multitoken_decode_plain(qm, sc, cfg, scale, CausalRule(), True,
                                                          n, 0, glob),
            2 * n_kv * live * tok + 2 * qm.numel() * act + lm(S * 4 * n_q),
            4 * n_q * d * 4 * live),
        "paged_prefill[cp]": (
            lambda: native.paged_prefill(qs, sc, cfg, 0, start, start + chunk,
                                         *prefill._page_range(cfg, start, chunk, CausalRule(), n,
                                                              0), CausalRule(), True, n, 0),
            lambda: prefill._paged_prefill_plain(qs, sc, cfg, 0, start, chunk, CausalRule(), True,
                                                 n, 0),
            2 * n_kv * owned(start + chunk, 0) * tok + 2 * qp.numel() * act + lm(chunk * n_q),
            4 * n_q * d * pairs0),
        "kv_chunk_write[cp]": (
            lambda: native.kv_chunk_write(sc, cfg, 1, w_start, k, v, w_len, cfg.n_pages - 1, n, 0),
            lambda: kv_cache._write_tokens_plain(sc, cfg, 1, w_start, k, v, w_len,
                                                 cfg.n_pages - 1, n, 0),
            2 * n_kv * own_rows * (d * act + tok), 0),
    }
    for variant, (kern, plain, n_bytes, n_ops) in runs.items():
        b_ms, b_by = bound(n_bytes, n_ops, "bf16")
        out[variant].update(ms=time_ms(kern), plain_ms=time_ms(plain, n=5), bound_ms=b_ms,
                            bound_by=b_by)
    # the whole context-parallel decode (4 launches and the merge) against
    # the flat kernel over the same tokens
    out["paged_decode[cp]"]["cp_step_ms"] = time_ms(
        lambda: decode_merged(q, shards, cfg, glob))
    out["paged_decode[cp]"]["flat_ms"] = time_ms(
        lambda: native.paged_decode(q, flat, flat_cfg, scale * LOG2E, CausalRule()))
    for variant, r in out.items():
        print(f"kernel cp {label} {variant}: {json.dumps(r)}", flush=True)
    return out


def cp_phase(mcfg, cpu_model, seed, n_new, dev):
    """Phase 3e: context-parallel serving on the card.  (a) the four
    sequence-sharded variants against their plain versions and the merge
    against the flat kernels; (b) the 168M engine with cp = 4 on the card
    (the shards share it) against the flat engine; (c) a float32 gate.
    Returns ({variant: measurements}, {variant: launches in (b)})."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    measured = cp_kernel_case("int8_8q8kv", 8, 8, dev, gen, timed=True)
    for variant, r in cp_kernel_case("int8_gqa_8q2kv", 8, 2, dev, gen, timed=False).items():
        measured[variant]["err"] = max(measured[variant]["err"], r["err"])
    torch.cuda.empty_cache()

    # (b) the engine at full width: 8 requests of 4,000-15,000 prompt tokens,
    # then speculation on 4 requests whose prompts repeat a 64-token pattern
    mesh = make_mesh((N_SHARDS,), ("seq",), [dev] * N_SHARDS)
    # no prefix caching (the cp engine has none): both engines prefill alike
    cp_cfg = EngineConfig(max_seqs=8, page_size=256, n_pages=129, max_pages_per_seq=16,
                          quantized_kv=True, prefill_chunk=512, prefix_caching=False)
    flat_cfg = dataclasses.replace(cp_cfg, n_pages=513, max_pages_per_seq=64)
    pgen = torch.Generator().manual_seed(seed + 5)
    lens = torch.randint(4000, 15001, (8,), generator=pgen).tolist()
    prompts = [torch.randint(1, mcfg.vocab, (n,), generator=pgen).tolist() for n in lens]
    pattern = torch.randint(1, mcfg.vocab, (64,), generator=pgen).tolist()
    spec_prompts = [pattern * (n // 64) for n in lens[:4]]
    runs, logits = {}, {}
    for label, cfg, kw in (("cp engine", cp_cfg, dict(mesh=mesh)),
                           ("flat engine", flat_cfg, dict(device=dev))):
        for spec, reqs in ((0, prompts), (3, spec_prompts)):
            eng = DecodeEngine(mcfg, cpu_model,
                               dataclasses.replace(cfg, speculative_tokens=spec), **kw)
            name = label + (" speculative" if spec else "")
            logits[name] = record_prompt_logits(eng)
            results, launches = serve(name, eng, [(p, None) for p in reqs], n_new, mcfg.vocab)
            runs[name] = ([results[r] for r in range(len(reqs))], launches)
            del eng
            torch.cuda.empty_cache()
    cp_launches = {v: runs["cp engine"][1][v] + runs["cp engine speculative"][1][v]
                   for v in native.CP_VARIANTS}
    if min(cp_launches.values()) < 1:
        fail(f"the cp engine did not launch every sequence-sharded variant: {cp_launches}")
    for name in ("", " speculative"):
        cp_out, flat_out = runs["cp engine" + name][0], runs["flat engine" + name][0]
        same = sum(a == b for a, b in zip(cp_out, flat_out))
        err = logits_err(f"cp engine{name}", logits["cp engine" + name],
                         logits["flat engine" + name], LOGIT_ATOL)
        print(f"cp engine{name}: requests equal to the flat engine's: {same} of {len(cp_out)}; "
              f"last prompt token's logits against the flat engine's: max_abs_err {err} (tol "
              f"{LOGIT_ATOL})", flush=True)
    # where a decode step's time goes, cp against flat
    for label, cfg, kw in (("cp engine", cp_cfg, dict(mesh=mesh)),
                           ("flat engine", flat_cfg, dict(device=dev))):
        step_profile(label, DecodeEngine(mcfg, cpu_model, cfg, **kw), prompts)
        torch.cuda.empty_cache()

    # (c) float32 gate: 8 layers, unquantized cache, cp = 4 against flat
    cp_gate(mcfg, seed, mesh, dev)
    print(f"phase 3e: {time.perf_counter() - t0:.3f} s", flush=True)
    return measured, cp_launches


def step_profile(label, eng, prompts, n_steps=3):
    """Decode steps of ``eng`` with ``prompts`` admitted: the wall time of
    ``n_steps`` steps, then the device time of ``n_steps`` more by kernel
    class from torch.profiler, and the device's busy share of the step's
    wall time (and of the profiled wall, which the profiler stretches)."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(p, max_new_tokens=2 * n_steps + 2)
    eng.step()                                   # prefill, and one token each
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / n_steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t) / n_steps * 1e3
    classes = {}
    for e in prof.events():             # the kernels themselves, each once
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k in ("paged_decode", "kv_append") if f"{k}_kernel" in e.name),
                    "matmul" if any(s in e.name.lower() for s in ("gemm", "nvjet", "cutlass"))
                    else "other")
        classes[name] = classes.get(name, 0.0) + e.device_time_total / 1e3 / n_steps
    busy = sum(classes.values())
    if busy == 0:
        print(f"step profile {label}: step {wall:.3f} ms; device time not measured (the "
              f"profiler saw no device events)", flush=True)
        return
    print(f"step profile {label}: step {wall:.3f} ms wall ({prof_wall:.3f} ms profiled); "
          f"device busy {busy:.3f} ms a step ({busy / wall:.3f} of the step's wall, "
          f"{busy / prof_wall:.3f} of the profiled wall); "
          f"device ms a step by class {json.dumps({k: round(v, 4) for k, v in classes.items()})}",
          flush=True)


def record_prompt_logits(eng):
    """{prompt as a tuple: float32 logits of its last token}, filled as
    ``eng`` admits its requests."""
    out, inner = {}, eng._prefill_chunked

    def prefill(p, slot):
        r = inner(p, slot)
        out[tuple(p)] = r.float()
        return r

    eng._prefill_chunked = prefill
    return out


def logits_err(label, got, want, tol):
    """Max abs difference of two engines' last-prompt-token logits over the
    same requests; fails past ``tol``."""
    if got.keys() != want.keys():
        fail(f"{label}: the engines admitted different prompts")
    err = max(float((got[p] - want[p]).abs().max()) for p in want)
    if not all(torch.isfinite(x).all() for x in got.values()) or err > tol:
        fail(f"{label}: last prompt token's logits differ from the flat engine's by {err} > "
             f"{tol}")
    return err


def cp_gate(mcfg, seed, mesh, dev):
    """Phase 3e(c): the 168M decoder (all 8 layers) in float32, unquantized
    cache, on 4 prompts of 4,000-15,000 tokens, as many local pages a shard
    as (b): cp = 4 with and without speculation against the flat engine.
    The last prompt token's logits must agree within CP_F32_LOGIT_ATOL, and
    the greedy tokens up to each request's first top-2 logit tie
    (GAP_TIE)."""
    from tf_flash_attention_tpu_torch.models import transformer as tf
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    cfg = dataclasses.replace(mcfg, dtype=torch.float32)
    model = tf.init_params(cfg, torch.Generator().manual_seed(seed + 6), device="cpu")
    pgen = torch.Generator().manual_seed(seed + 7)
    prompts = [torch.randint(1, cfg.vocab, (n,), generator=pgen).tolist()
               for n in torch.randint(4000, 15001, (4,), generator=pgen).tolist()]
    n_new = 16
    cp_cfg = EngineConfig(max_seqs=4, page_size=256, n_pages=4 * 16 + 1, max_pages_per_seq=16,
                          quantized_kv=False, prefill_chunk=512, prefix_caching=False)
    flat_cfg = dataclasses.replace(cp_cfg, n_pages=4 * 64 + 1, max_pages_per_seq=64)

    def run(ecfg, spec, **kw):
        eng = DecodeEngine(cfg, model, dataclasses.replace(ecfg, speculative_tokens=spec), **kw)
        logits = record_prompt_logits(eng)
        rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        res = eng.run(max_steps=10_000)
        del eng
        torch.cuda.empty_cache()
        return [res[r] for r in rids], logits

    base, base_logits = run(flat_cfg, 0, device=dev)
    gaps = top2_gaps(cfg, model, prompts, base, dev)
    for spec in (0, 3):
        out, out_logits = run(cp_cfg, spec, mesh=mesh)
        label = f"cp gate (speculative_tokens={spec}, against the flat engine)"
        err = logits_err(label, out_logits, base_logits, CP_F32_LOGIT_ATOL)
        check_to_tie(label, prompts, base, out, gaps)
        same = sum(a == b for a, b in zip(out, base))
        print(f"cp gate (float32, speculative_tokens={spec}): {same} of {len(prompts)} "
              f"requests equal to the flat engine's in full; last prompt token's logits "
              f"max_abs_err {err} (tol {CP_F32_LOGIT_ATOL}); prompt lengths "
              f"{[len(p) for p in prompts]}; smallest top-2 gap {min(min(g) for g in gaps)}",
              flush=True)


@contextlib.contextmanager
def plain_attention(fused="kv"):
    """The attention core on its plain versions, on any device: the plain
    path the kernels are held against (``fused=False``: the split pair's)."""
    from tf_flash_attention_tpu_torch.ops import attend, backward, forward

    def fwd(q, k, v, *, pack, rule, config, scale):
        return forward._flash_forward_plain(forward.prescale(q, scale), k, v, pack, rule)

    def bwd(q, k, v, o, l, m, do, *, pack, rule, config, scale):
        lse2, delta = backward.backward_stats(o, l, m, do)
        return backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, rule, scale,
                                              fused)

    saved = attend.flash_forward, attend.flash_backward
    attend.flash_forward, attend.flash_backward = fwd, bwd
    try:
        yield
    finally:
        attend.flash_forward, attend.flash_backward = saved


# the JAX package's route switches, read by the port as by the package
TABLE_ONLY = {v: "0" for v in ("FA_BANDED", "FA_WINDOW", "FA_BANDED_BWD", "FA_WINDOW_BWD")}
SPLIT = {"FA_FUSED_BWD": "0"}
RESIDENT = {"FA_RESIDENT": "1"}


@contextlib.contextmanager
def switches(env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def compare(label, names, got, want, dtypes):
    """Max abs error of each output; fails past op_tol.  Returns the max."""
    worst = 0.0
    for name, a, b, dt in zip(names, got, want, dtypes):
        err = float((a.float() - b.float()).abs().max())
        tol = op_tol(dt, b)
        if not torch.isfinite(a.float()).all() or err > tol:
            fail(f"{label}: {name} max error {err} > {tol}")
        worst = max(worst, err)
    return worst


def drive(fn, inputs, cotangent, env=None):
    """Outputs and input gradients of a public function under the route
    switches ``env``: kernels, then the plain path.  Returns (kernel_outs,
    plain_outs, launches), each outs list outputs + grads; launches counts
    the kernels' run only."""
    from tf_flash_attention_tpu_torch import native
    env = env or {}
    res = []
    for kernels in (True, False):
        ctx = contextlib.nullcontext() if kernels else plain_attention(
            False if env == SPLIT else "kv")
        with ctx, switches(env):
            if kernels:
                native.reset_launch_counts()
            xs = [x.detach().requires_grad_(True) for x in inputs]
            outs = fn(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            grads = torch.autograd.grad(outs[0], xs, cotangent)
            res.append([o.detach() for o in outs] + list(grads))
            if kernels:
                torch.cuda.synchronize()
                launches = {k: v for k, v in native.LAUNCHES.items() if v}
    torch.cuda.synchronize()
    return res[0], res[1], launches


def op_phase(dev):
    """Phase 5.  Returns ({kernel: {err, ms, plain_ms, library_ms, bound_ms,
    bound_by}}, {kernel: launches in the op path's run})."""
    from tf_flash_attention_tpu_torch import api, native
    from tf_flash_attention_tpu_torch.block_sizes import choose_block_config
    from tf_flash_attention_tpu_torch.flops import matmul_flops_forward
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule, LocalRule
    from tf_flash_attention_tpu_torch.ops import backward, forward
    from tf_flash_attention_tpu_torch.parallel.sharded import mha
    from tf_flash_attention_tpu_torch.sync_modes import make_sync_pack

    bf, f32, h = torch.bfloat16, torch.float32, torch.float16
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cf = lambda x: x.transpose(1, 2)          # sequence-major -> channel-first
    BH, S, d = 64, 2048, 128
    q, k, v, do = (randn((BH, S, d), bf) for _ in range(4))
    causal = lambda Q, K, V: api.causal_1d(Q, K, V, sync_mode="none_front", returning_l_m=True)
    err, per_case = {}, {}

    def case(label, fn, inputs, cotangent, types, env=None):
        got, want, launches = drive(fn, inputs, cotangent, env)
        per_case[label] = launches
        n_out = len(got) - 3
        names = ("o", "l", "m")[:n_out] + ("dq", "dk", "dv")
        fwd_err = compare(label, names[:n_out], got[:n_out], want[:n_out], types[:n_out])
        bwd_err = compare(label, names[n_out:], got[n_out:], want[n_out:], types[n_out:])
        fwd_k = [k for k in launches if k.endswith("_fwd")]
        bwd_k = [k for k in launches if not k.endswith("_fwd")]
        for kn in fwd_k:
            err[kn] = max(err.get(kn, 0.0), fwd_err)
        for kn in bwd_k:
            err[kn] = max(err.get(kn, 0.0), bwd_err)
        print(f"op {label}: launches {json.dumps(launches)}; max_abs_err fwd {fwd_err} "
              f"bwd {bwd_err}", flush=True)

    # (a) the training slice through causal_1d: the JAX routes, banded
    # forward and banded fused backward
    slice_types = (bf, f32, bf, bf, bf, bf)
    native.reset_launch_counts()
    case("(a) causal bf16", causal, (cf(q), cf(k), cf(v)), cf(do), slice_types)
    # (b) the same with the deterministic split pair (FA_FUSED_BWD=0)
    case("(b) causal bf16 split", causal, (cf(q), cf(k), cf(v)), cf(do), slice_types, SPLIT)
    # (c) GQA 8 q / 2 kv heads through mha, at the slice's width
    qg = randn((8, 8, S, d), bf)
    kg, vg = randn((8, 2, S, d), bf), randn((8, 2, S, d), bf)
    rule = CausalRule()

    case("(c) gqa 8/2 bf16", lambda Q, K, V: mha(Q, K, V, rule=rule), (qg, kg, vg),
         randn((8, 8, S, d), bf), (bf,) * 4)
    # (d) fp32 local_1d, q != k lengths: the window kernels
    Qd, Kd, Vd = (randn((4, 64, n), f32) for n in (1500, 2000, 2000))
    local = lambda Q, K, V: api.local_1d(Q, K, V, 5, 1, True, "scale_front", returning_l_m=True)
    dOd = randn((4, 64, 1500), f32)
    case("(d) local_1d f32", local, (Qd, Kd, Vd), dOd, (f32,) * 6)
    # (e) fp16 local_2d (scale_end), d 64 != v_d 96: window forward, banded
    # backward
    Q, K, V = randn((2, 4, 64, 32, 48), h), randn((2, 4, 64, 48, 32), h), \
        randn((2, 4, 96, 48, 32), h)
    case("(e) local_2d f16", lambda Q, K, V: api.local_2d(Q, K, V, 7, 0, False, "scale_end",
                                                          returning_l_m=True),
         (Q, K, V), randn((2, 4, 96, 32, 48), h), (h, f32, h, h, h, h))
    # (f) the slice with the band routes switched off: the table kernels
    case("(f) causal bf16 table", causal, (cf(q), cf(k), cf(v)), cf(do), slice_types,
         TABLE_ONLY)
    # (g) the slice with the opt-in resident forward (FA_RESIDENT=1)
    case("(g) causal bf16 resident", causal, (cf(q), cf(k), cf(v)), cf(do), slice_types,
         RESIDENT)
    # (i) wide heads, d = v_d = 384 (the tensor-core forward's 32-key
    # stages, the backward's third tile class), bf16 causal, 16 rows of 1024
    qw, kw, vw, dow = (randn((16, 1024, 384), bf) for _ in range(4))
    case("(i) causal bf16 d 384", causal, (cf(qw), cf(kw), cf(vw)), cf(dow), slice_types)
    # (j), (k) fp16 on the tensor-core forward's two routes: banded, and the
    # table with the band routes off (16 rows of 1024, d 128)
    q16, k16, v16, do16 = (randn((16, 1024, 128), h) for _ in range(4))
    f16_types = (h, f32, h, h, h, h)
    case("(j) causal f16", causal, (cf(q16), cf(k16), cf(v16)), cf(do16), f16_types)
    case("(k) causal f16 table", causal, (cf(q16), cf(k16), cf(v16)), cf(do16), f16_types,
         TABLE_ONLY)
    # (l) d = 576, v_d = 64 (an MLA head width) bf16 causal, 8 rows of 1024:
    # past the tensor-core forward's classes, the scalar forward on the
    # banded and the resident route
    q5, k5 = randn((8, 1024, 576), bf), randn((8, 1024, 576), bf)
    v5, do5 = randn((8, 1024, 64), bf), randn((8, 1024, 64), bf)
    for label, env, want_fwd in (("(l) causal bf16 d 576", None, "banded_fwd"),
                                 ("(l) causal bf16 d 576 resident", RESIDENT, "resident_fwd")):
        case(label, causal, (cf(q5), cf(k5), cf(v5)), cf(do5), slice_types, env)
        if not per_case[label].get(want_fwd):
            fail(f"{label}: {want_fwd} did not launch: {per_case[label]}")
    # (m) the resident route on fp16 (the tensor-core body's fp16 walk)
    case("(m) causal f16 resident", causal, (cf(q16), cf(k16), cf(v16)), cf(do16), f16_types,
         RESIDENT)
    op_launches = {}
    for launches in per_case.values():
        for kn, n in launches.items():
            op_launches[kn] = op_launches.get(kn, 0) + n
    # (h) the q-outer fused backward: as in the JAX package, only a direct
    # call with fused="q" reaches it (here the GQA 8/2 case, sequence-major)
    pack, cfg = make_sync_pack("none_front", (S,), (S,)), choose_block_config(d, d)
    qh, kh, vh = qg.reshape(64, S, d), kg.reshape(16, S, d), vg.reshape(16, S, d)
    doh = randn((64, S, d), bf)
    oh, lh, mh = forward.flash_forward(qh, kh, vh, pack=pack, rule=rule, config=cfg)
    native.reset_launch_counts()
    got = backward.flash_backward(qh, kh, vh, oh, lh, mh, doh, pack=pack, rule=rule, config=cfg,
                                  fused="q")
    torch.cuda.synchronize()
    qouter_launches = {k: v for k, v in native.LAUNCHES.items() if v}
    lse2h, deltah = backward.backward_stats(oh, lh, mh, doh)
    want = backward._flash_backward_plain(qh, kh, vh, doh, lse2h, deltah, pack, rule, d ** -0.5,
                                          True)
    err["flash_bwd_qouter"] = compare("(h) gqa 8/2 bf16 q-outer", ("dq", "dk", "dv"), got, want,
                                      (bf,) * 3)
    qouter_body = native.WALKS["flash_bwd_qouter"]["body"]
    if qouter_body != native.bwd_body(bf, d, d):
        fail(f"(h): flash_bwd_qouter ran the {qouter_body} body, bwd_body names "
             f"{native.bwd_body(bf, d, d)}")
    print(f"op (h) gqa 8/2 bf16 q-outer (direct call): launches {json.dumps(qouter_launches)}; "
          f"body {qouter_body}; max_abs_err bwd {err['flash_bwd_qouter']}", flush=True)
    op_launches["flash_bwd_qouter"] = qouter_launches.get("flash_bwd_qouter", 0)
    missing = [kn for kn in native.ATTENTION_KERNELS if not op_launches.get(kn)]
    if missing:
        fail(f"op path: kernels never launched: {missing} ({op_launches})")

    # kernel, plain and library times (these launches are not counted in any
    # path), and each kernel's bound: the bytes of its inputs and outputs, and
    # its products over the visible (query, key) pairs of the rule
    from tf_flash_attention_tpu_torch.ops.reference import build_mask
    times = {}

    def sdpa(q4, k4, v4, do4=None, **kw):
        """One scaled_dot_product_attention call (forward, or with ``do4``
        forward and backward) on (1, B, S, d) views."""
        if do4 is None:
            return lambda: F.scaled_dot_product_attention(q4, k4, v4, **kw)

        def fwd_bwd():
            xs = [x.detach().requires_grad_() for x in (q4, k4, v4)]
            torch.autograd.grad(F.scaled_dot_product_attention(*xs, **kw), xs, do4)
        return fwd_bwd

    def slice_routes(env):
        with switches(env):
            return (forward.forward_route(pack, rule, cfg, d, d),
                    backward.backward_route(pack, rule, cfg, 1, "kv")[0],
                    backward.backward_route(pack, rule, cfg, 1, False))

    scale = d ** -0.5
    q_s, k_s = forward.prescale(q, scale), forward.prescale(k, scale)
    fb, bb, _ = slice_routes({})
    ft, bt, (rdq, rdkv) = slice_routes(TABLE_ONLY)
    fr = slice_routes(RESIDENT)[0]
    (bq,) = backward.backward_route(pack, rule, cfg, 1, "q")
    if (fb.kernel, bb.kernel, ft.kernel, bt.kernel, fr.kernel) != (
            "banded_fwd", "banded_bwd", "flash_fwd", "flash_bwd_fused", "resident_fwd"):
        fail(f"unexpected slice routes {fb.kernel} {bb.kernel} {ft.kernel} {bt.kernel} "
             f"{fr.kernel}")
    o, l, m = forward.flash_forward(q, k, v, pack=pack, rule=rule, config=cfg)
    lse2, delta = backward.backward_stats(o, l, m, do)
    tabs = lambda r: r.tables(pack, rule, dev)
    rule_c = native.fa_rule(pack, rule)
    plain_fwd = lambda: forward._flash_forward_plain(q_s, k, v, pack, rule)
    plain_fused = lambda: backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, rule,
                                                         scale, "kv")
    plain_split = lambda: backward._flash_backward_plain(q, k, v, do, lse2, delta, pack, rule,
                                                         scale, False)
    area2 = matmul_flops_forward(rule, "none_front", (S,), (S,), d, d, BH) / (2 * d)
    pairs = BH * int(build_mask(pack, rule).sum())
    q4, k4, v4, do4 = (x.unsqueeze(0) for x in (q, k, v, do))
    lib_fwd = sdpa(q4, k4, v4, is_causal=True)
    lib_bwd = sdpa(q4, k4, v4, do4, is_causal=True)
    tensor = q.numel() * q.element_size()             # q, k, v, do, o, dq, dk, dv alike
    stats = BH * S * 4                                 # l, m, lse2, delta (float32)
    # forward: q, k, v in, o, l, m out; backward: q, k, v, do, lse2, delta in
    fwd_bytes = bwd_bytes = 4 * tensor + 2 * stats
    # products per kernel (each 2 * area * width): forward S, PV; fused
    # backward S, dP, dV, dK, dQ; split dQ S, dP, dQ; split dK/dV S, dP, dV, dK;
    # and the bytes each reads and writes
    launch = {
        "flash_fwd": (lambda: native.flash_fwd(q_s, k, v, rule_c, tabs(ft), 128, 128),
                      plain_fwd, 2, fwd_bytes, lib_fwd),
        "banded_fwd": (lambda: native.banded_fwd(q_s, k, v, rule_c, tabs(fb)[0], 128, 128),
                       plain_fwd, 2, fwd_bytes, lib_fwd),
        "resident_fwd": (lambda: native.resident_fwd(q_s, k, v, rule_c, tabs(fr)[0], 128, 128),
                         plain_fwd, 2, fwd_bytes, lib_fwd),
        "flash_bwd_fused": (
            lambda: native.flash_bwd_fused(q_s, k, v, do, lse2, delta, rule_c, tabs(bt), 128,
                                           128, 1.0 / math.log2(math.e)), plain_fused, 5,
            bwd_bytes + 3 * tensor, lib_bwd),
        "banded_bwd": (
            lambda: native.banded_bwd(q_s, k, v, do, lse2, delta, rule_c, tabs(bb)[0], 128,
                                      128, 1.0 / math.log2(math.e)), plain_fused, 5,
            bwd_bytes + 3 * tensor, lib_bwd),
        "flash_bwd_qouter": (
            lambda: native.flash_bwd_qouter(q_s, k, v, do, lse2, delta, rule_c, tabs(bq), 128,
                                            128, scale), plain_fused, 5,
            bwd_bytes + 3 * tensor, lib_bwd),
        "flash_bwd_dq": (
            lambda: native.flash_bwd_dq(q_s, k, v, do, lse2, delta, rule_c, tabs(rdq), 128, 128,
                                        scale), plain_split, 3, bwd_bytes + tensor, None),
        "flash_bwd_dkv": (
            lambda: native.flash_bwd_dkv(q, k_s, v, do, lse2, delta, rule_c, tabs(rdkv), 128,
                                         128, scale), plain_split, 4,
            bwd_bytes + 2 * tensor, None),
    }
    for kn, (kern, plain, products, n_bytes, lib) in launch.items():
        ms, plain_ms = time_ms(kern, n=10), time_ms(plain, n=5)
        lib_ms = None if lib is None else time_ms(lib, n=10)
        b_ms, b_by = bound(n_bytes, products * 2 * pairs * d, "bf16")
        times[kn] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by)
        # the split pair has the scalar body only
        times[kn]["body"] = (native.fwd_body(bf, d, d) if kn.endswith("_fwd") else
                             "scalar" if kn in ("flash_bwd_dq", "flash_bwd_dkv")
                             else native.bwd_body(bf, d, d))
        extra = ""
        if kn == "resident_fwd":   # the persistent walk, as its last launch reports it
            walk = native.WALKS[kn]
            if walk["body"] != times[kn]["body"]:
                fail(f"phase 5: resident_fwd ran the {walk['body']} body, fwd_body names "
                     f"{times[kn]['body']}")
            times[kn].update({x: walk[x] for x in ("grid", "items", "group_rows")})
            extra = (f" grid={walk['grid']} items={walk['items']} rows in flight: one or two "
                     f"groups of {walk['group_rows']}")
        print(f"kernel {kn} (slice): body={times[kn]['body']}{extra} ms={ms} plain_ms={plain_ms} "
              f"library_ms={lib_ms} bound_ms={b_ms} ({b_by}) useful TFLOP/s="
              f"{products * area2 * d / ms / 1e9:.3f}", flush=True)
    res, band = times["resident_fwd"], times["banded_fwd"]
    print(f"resident_fwd beside banded_fwd (slice): {res['ms']} vs {band['ms']} ms = "
          f"{res['ms'] / band['ms']:.3f}x; library {res['library_ms']} ms = "
          f"{res['ms'] / res['library_ms']:.3f}x; bound share {res['bound_ms'] / res['ms']:.4f}",
          flush=True)
    # the q-outer backward at (h)'s GQA 8/2 shape beside the kv-outer table
    # kernel and the library's GQA forward + backward, each kernel alone
    # (its wrapper's accumulator zero fills included, the casts not)
    qh_s = forward.prescale(qh, scale)
    g_pairs = 64 * int(build_mask(pack, rule).sum())
    g_bytes = 3 * qh.numel() * 2 + 4 * kh.numel() * 2 + 2 * 64 * S * 4
    gqa = dict(ms=time_ms(lambda: native.flash_bwd_qouter(qh_s, kh, vh, doh, lse2h, deltah,
                                                           rule_c, tabs(bq), 128, 128, scale),
                          n=10),
               flash_bwd_fused_ms=time_ms(lambda: native.flash_bwd_fused(
                   qh_s, kh, vh, doh, lse2h, deltah, rule_c, tabs(bt), 128, 128,
                   1.0 / math.log2(math.e)), n=10),
               library_ms=time_ms(sdpa(qg, kg, vg, doh.reshape(qg.shape), is_causal=True,
                                       enable_gqa=True), n=10))
    gqa["bound_ms"], gqa["bound_by"] = bound(g_bytes, 5 * 2 * g_pairs * d, "bf16")
    times["flash_bwd_qouter"]["gqa"] = gqa
    print(f"kernel flash_bwd_qouter ((h) gqa 8/2, 64 q / 16 kv heads): body={qouter_body} "
          f"ms={gqa['ms']} flash_bwd_fused ms={gqa['flash_bwd_fused_ms']} "
          f"({gqa['ms'] / gqa['flash_bwd_fused_ms']:.3f}x) library_ms={gqa['library_ms']} "
          f"bound_ms={gqa['bound_ms']} ({gqa['bound_by']})", flush=True)
    # what dQ costs the tensor-core backward: banded_bwd without the dS^T
    # tile, the dQ product and its reduction (not counted in any path)
    no_dq_ms = time_ms(lambda: native.banded_bwd(q_s, k, v, do, lse2, delta, rule_c, tabs(bb)[0],
                                                 128, 128, 1.0 / math.log2(math.e),
                                                 with_dq=False), n=10)
    times["banded_bwd"]["ms_without_dq"] = no_dq_ms
    print(f"kernel banded_bwd without dQ (slice): ms={no_dq_ms}; dQ's product and reduction "
          f"{times['banded_bwd']['ms'] - no_dq_ms:.4f} ms of {times['banded_bwd']['ms']}",
          flush=True)
    # the two torch passes around a fused backward's launch (ops/backward.py,
    # native.py): the zero fill of the float32 dQ accumulator and dQ's
    # scale-and-cast
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    zero_ms = time_ms(lambda: torch.zeros(q.shape, dtype=torch.float32, device=dev), n=10)
    cast_ms = time_ms(lambda: (dq_acc * scale).to(bf), n=10)
    print(f"dq_acc passes (slice): zero fill ms={zero_ms} scale-and-cast ms={cast_ms}",
          flush=True)
    split_ms = times["flash_bwd_dq"]["ms"] + times["flash_bwd_dkv"]["ms"]
    print(f"kernel split pair (slice): {split_ms} ms for one backward = "
          f"{5 * area2 * d / split_ms / 1e9:.3f} useful TFLOP/s; the plain_ms of each of the "
          f"pair is the whole plain split backward", flush=True)

    # the window kernels at case (d)'s shape (fp32, d = v_d = 64)
    local_rule = LocalRule(5, 1, True)
    pack_d = make_sync_pack("scale_front", (1500,), (2000,))
    qd, kd, vd, dod = cf(Qd).contiguous(), cf(Kd).contiguous(), cf(Vd).contiguous(), \
        cf(dOd).contiguous()
    scale_d = 64 ** -0.5
    cfg_d = choose_block_config(64, 64)
    fw = forward.forward_route(pack_d, local_rule, cfg_d, 64, 64)
    (bw,) = backward.backward_route(pack_d, local_rule, cfg_d, 1, "kv")
    if (fw.kernel, bw.kernel) != ("window_fwd", "window_bwd"):
        fail(f"case (d) routes to {fw.kernel}, {bw.kernel}, not the window kernels")
    qd_s = forward.prescale(qd, scale_d)
    rc_d = native.fa_rule(pack_d, local_rule)
    od, ld, md = forward.flash_forward(qd, kd, vd, pack=pack_d, rule=local_rule, config=cfg_d)
    lse2_d, delta_d = backward.backward_stats(od, ld, md, dod)
    area2_d = matmul_flops_forward(local_rule, "scale_front", (1500,), (2000,), 64, 64, 4) / 128
    (starts_q,), (starts_k,) = fw.tables(pack_d, local_rule, dev), bw.tables(pack_d, local_rule,
                                                                            dev)
    mask_d = torch.from_numpy(build_mask(pack_d, local_rule).reshape(1500, 2000).copy()).to(dev)
    pairs_d = 4 * int(mask_d.sum())
    qd4, kd4, vd4, dod4 = (x.unsqueeze(0) for x in (qd, kd, vd, dod))
    q_bytes, k_bytes, stats_d = qd.numel() * 4, kd.numel() * 4, 4 * 1500 * 4
    window = {
        "window_fwd": (lambda: native.window_fwd(qd_s, kd, vd, rc_d, starts_q, fw.band, fw.sub,
                                                 fw.masked),
                       lambda: forward._flash_forward_plain(qd_s, kd, vd, pack_d, local_rule),
                       2, 2 * q_bytes + 2 * k_bytes + 2 * stats_d,
                       sdpa(qd4, kd4, vd4, attn_mask=mask_d)),
        "window_bwd": (lambda: native.window_bwd(qd_s, kd, vd, dod, lse2_d, delta_d, rc_d,
                                                 starts_k, bw.band, bw.sub,
                                                 1.0 / math.log2(math.e)),
                       lambda: backward._flash_backward_plain(qd, kd, vd, dod, lse2_d, delta_d,
                                                              pack_d, local_rule, scale_d, "kv"),
                       5, 3 * q_bytes + 4 * k_bytes + 2 * stats_d,
                       sdpa(qd4, kd4, vd4, dod4, attn_mask=mask_d)),
    }
    for kn, (kern, plain, products, n_bytes, lib) in window.items():
        ms, plain_ms, lib_ms = time_ms(kern, n=10), time_ms(plain, n=5), time_ms(lib, n=10)
        b_ms, b_by = bound(n_bytes, products * 2 * pairs_d * 64, "f32")
        times[kn] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by)
        print(f"kernel {kn} (case d, band {fw.band if kn == 'window_fwd' else bw.band}): "
              f"ms={ms} plain_ms={plain_ms} library_ms={lib_ms} bound_ms={b_ms} ({b_by}) "
              f"useful TFLOP/s (128-tile schedule)={products * area2_d * 64 / ms / 1e9:.3f}",
              flush=True)
    return {kn: dict(times[kn], err=err[kn]) for kn in native.ATTENTION_KERNELS}, op_launches


def train_phase(mcfg, cpu_model, dev, seed):
    """Phase 6: 5 AdamW steps of the 168M decoder at 8 x 2048 tokens."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.models import transformer as tf

    gen = torch.Generator().manual_seed(seed + 2)
    tokens = torch.randint(0, mcfg.vocab, (8, 2049), generator=gen).to(dev)

    def grad_norm(model):
        return math.sqrt(sum(float((p.grad.float() ** 2).sum()) for p in model.parameters()))

    model = copy.deepcopy(cpu_model).to(dev)
    with plain_attention():
        loss = tf.loss_fn(mcfg, model, tokens)
        loss.backward()
        loss_plain, gnorm_plain = float(loss.detach()), grad_norm(model)
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)   # optax.adamw's defaults
    losses, step_s = [], []
    native.reset_launch_counts()
    for step in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tf.train_step(mcfg, model, tokens, optimizer=opt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if step == 0:
            gnorm = grad_norm(model)
    launches = {k: v for k, v in native.LAUNCHES.items() if v}
    if not launches.get("banded_fwd") or not launches.get("banded_bwd"):
        fail(f"the training step did not run the banded kernels: {launches}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"training losses {losses} are not finite and falling")
    if abs(losses[0] - loss_plain) > TRAIN_LOSS_ATOL:
        fail(f"first-step loss {losses[0]} vs plain path {loss_plain}: > {TRAIN_LOSS_ATOL}")
    if abs(gnorm - gnorm_plain) > TRAIN_GNORM_RTOL * gnorm_plain:
        fail(f"first-step grad norm {gnorm} vs plain path {gnorm_plain}: "
             f"> {TRAIN_GNORM_RTOL} relative")
    ms = statistics.median(step_s[1:]) * 1e3
    print(f"train: losses {losses}; first step loss {losses[0]} vs plain {loss_plain} "
          f"(tol {TRAIN_LOSS_ATOL}), grad norm {gnorm} vs plain {gnorm_plain} (rtol "
          f"{TRAIN_GNORM_RTOL}); step ms {[round(s * 1e3, 3) for s in step_s]}, median of "
          f"steps 2-5 {ms:.3f} ms = {8 * 2048 / ms * 1e3:.1f} tokens/s ({ms / STEP_MS_BEFORE:.4f}"
          f"x the {STEP_MS_BEFORE} ms before); launches in the 5 steps {json.dumps(launches)}",
          flush=True)
    del model, opt
    torch.cuda.empty_cache()
    return launches


def cpu_card_phase(mcfg, cpu_model, dev, seed):
    """Phase 7: one step at 1 x 512 tokens, plain versions on the CPU and
    kernels on the card; the losses must agree."""
    from tf_flash_attention_tpu_torch.models import transformer as tf

    tokens = torch.randint(0, mcfg.vocab, (1, 513), generator=torch.Generator().manual_seed(seed + 3))
    losses = {}
    for where in ("cpu", dev):
        model = copy.deepcopy(cpu_model).to(where)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
        losses[str(where)] = float(tf.train_step(mcfg, model, tokens.to(where), optimizer=opt))
        del model, opt
    a, b = losses["cpu"], losses[str(dev)]
    if not math.isfinite(b) or abs(a - b) > CPU_LOSS_ATOL:
        fail(f"CPU-vs-card training loss differs: {a} vs {b} (tol {CPU_LOSS_ATOL})")
    print(f"train CPU vs card: loss {a} vs {b}, diff {abs(a - b)} (tol {CPU_LOSS_ATOL})",
          flush=True)


# experiment kernels (phase 8): kernel and plain version round p and o at
# the same points and sum in other orders, so an output element parts by a
# rounding flip, one bf16 ulp of its own magnitude.  A bf16 ulp of x is at
# most 2**-7 |x|, so 2 * 2**-8 of the largest output magnitude is at least
# one ulp of any element (``ulps`` = 2).  No floor: the decode sites'
# outputs are ~0.005 (at most ~0.03), and a floor of 1 would let a limit
# exceed the values it compares.  bitcast rounds each half of o to bf16 and
# sums the halves in bf16, three roundings against the others' one: 3
def exp_tol(ref, ulps=2):
    return ulps * 2.0 ** -8 * float(ref.float().abs().max())


def bitcast_tol(ref):
    return exp_tol(ref, 3)


EXP_REPLACES = {
    "exp_resident_fwd": "tools/exp_resident.py:96",
    "exp_int4_int8ref": "tools/exp_int4_unpack.py:254",
    "exp_int4_s32": "tools/exp_int4_unpack.py:264",
    "exp_int4_twopage": "tools/exp_int4_unpack.py:274",
    "exp_int4_fourpage": "tools/exp_int4_unpack.py:284",
    "exp_int4_int8_2pg": "tools/exp_int4_unpack.py:294",
    "exp_int4_bitcast": "tools/exp_int4_unpack.py:314",
    "exp_vpu_ladder": "tools/exp_vpu_attrib.py:96",
    "exp_paged_decode": "tools/exp_decode.py:159",
    "exp_kv_unroll": "tools/exp_kv_unroll.py:115",
}


def experiment_phase(dev, seed):
    """Phase 8: the experiment tools' kernels at the tools' own shapes.  Every
    instantiation the tools run is driven once through its module's wrapper
    with the launch counts reset just before (the counts are read just
    after), then held against its plain version on the card and timed with
    its plain version, its bound and, for the forwards, one
    scaled_dot_product_attention call.  Returns ({kernel: entry}, {kernel:
    launches}); an entry's numbers are those of the tool's first variant,
    every variant's beside them under "variants"."""

    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.experiments import (exp_decode, exp_int4_unpack,
                                                          exp_kv_unroll, exp_resident,
                                                          exp_vpu_attrib)
    from tf_flash_attention_tpu_torch.serving.kv_cache import (KVCacheConfig, PageAllocator,
                                                               PagedKVCache, write_prompt)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    uni = lambda shape: torch.rand(shape, generator=gen, device=dev) * 2 - 1
    bf = torch.bfloat16
    # (kernel, variant, fn, plain, n_bytes, n_ops, ops_type, library call or
    # None, tolerance, the int8mm arguments whose codes must match or None)
    runs = []

    # sites 1, 8, 10: the forwards, (8, 4096, 128) bf16
    B, S, D = 8, 4096, 128
    q, k, v = uni((B, S, D)).to(bf), uni((B, S, D)).to(bf), uni((B, S, D)).to(bf)
    q4, k4, v4 = q.unsqueeze(0), k.unsqueeze(0), v.unsqueeze(0)
    fwd_bytes = 4 * q.numel() * 2                                     # q, k, v in, o out
    # exp_resident is timed through the tool's entry (its prescale pass
    # included: the span of earlier runs) and, beside it, its kernel alone on
    # the prescaled q
    q_res = exp_resident._prescale(q, None)
    kernel_only = {}
    for bq, bkv in exp_resident.PAIRS:
        kernel_only["exp_resident_fwd", f"{bq}x{bkv}"] = (
            lambda bq=bq, bkv=bkv: native.exp_resident_fwd(q_res, k, v, bq, bkv))
        runs.append(("exp_resident_fwd", f"{bq}x{bkv}",
                     lambda bq=bq, bkv=bkv: exp_resident.resident_forward(
                         q, k, v, block_q=bq, block_kv=bkv),
                     lambda bq=bq, bkv=bkv: exp_resident.resident_forward_plain(
                         q, k, v, block_q=bq, block_kv=bkv),
                     fwd_bytes, 4 * B * D * S * (S + 1) // 2, "bf16",
                     lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
                     exp_tol, None))
    qv = uni((B, S, D)).to(bf) * torch.tensor(1.0 / math.sqrt(D) * 1.4426950408889634,
                                             dtype=bf, device=dev)
    kv_, vv = uni((B, S, D)).to(bf), uni((B, S, D)).to(bf)
    blk = exp_vpu_attrib.BQ
    block_causal = (torch.arange(S, device=dev)[None, :] // blk
                    <= torch.arange(S, device=dev)[:, None] // blk)
    for rung in exp_vpu_attrib.RUNGS:
        runs.append(("exp_vpu_ladder", rung,
                     lambda rung=rung: exp_vpu_attrib.ladder(rung, qv, kv_, vv),
                     lambda rung=rung: exp_vpu_attrib.ladder_plain(rung, qv, kv_, vv),
                     fwd_bytes, 4 * B * blk * blk * D * exp_vpu_attrib.live_tiles(), "bf16",
                     (lambda: F.scaled_dot_product_attention(
                         qv.unsqueeze(0), kv_.unsqueeze(0), vv.unsqueeze(0),
                         attn_mask=block_causal, scale=1.0)) if rung == "prod" else None,
                     exp_tol, None))
    qu, kkv = uni((B, S, D)).to(bf), uni((B, S, D)).to(bf)
    for name, nkv, fused in exp_kv_unroll.VARIANTS:
        runs.append(("exp_kv_unroll", name,
                     lambda nkv=nkv, fused=fused: exp_kv_unroll.kv_unroll(
                         qu, kkv, kkv, nkv=nkv, fused=fused),
                     lambda nkv=nkv, fused=fused: exp_kv_unroll.kv_unroll_plain(
                         qu, kkv, kkv, nkv=nkv, fused=fused),
                     3 * qu.numel() * 2, 4 * B * S * S * D, "bf16",
                     lambda: F.scaled_dot_product_attention(qu.unsqueeze(0), kkv.unsqueeze(0),
                                                            kkv.unsqueeze(0)),
                     exp_tol, None))

    # sites 2-7: exp_int4_unpack at its shapes (the shared K/V read once)
    iq, (k4_, ks4, v4_, vs4, _, _, k8, ks8, v8, vs8) = exp_int4_unpack.build(gen, dev)
    rows = iq.numel() // D                                           # 1024 query rows
    ib, ctx = exp_int4_unpack.B, exp_int4_unpack.CTX
    for name, kernel in exp_int4_unpack.KERNELS.items():
        args = ((iq, k8, ks8, v8, vs8) if kernel.startswith("exp_int4_int8")
                else (iq, k4_, ks4, v4_, vs4))
        n_bytes = sum(t.numel() * t.element_size() for t in args) + iq.numel() * 2
        runs.append((kernel, name,
                     lambda kernel=kernel, args=args: exp_int4_unpack.int4_decode(kernel, *args),
                     lambda kernel=kernel, args=args: exp_int4_unpack.int4_decode_plain(
                         kernel, *args),
                     n_bytes, 4 * rows * ctx * D, "bf16", None,
                     bitcast_tol if name == "bitcast" else exp_tol, None))

    # site 9: exp_decode's paged int8 cache, written by the port's cache code
    max_seqs, seq_len, n_kv, page = 16, 8192, 8, 512
    pps = seq_len // page
    cfg = KVCacheConfig(n_kv_heads=n_kv, head_dim=D, page_size=page,
                        n_pages=max_seqs * pps + 1, max_seqs=max_seqs, max_pages_per_seq=pps,
                        quantized=True)
    cache = PagedKVCache.create(cfg, dev)
    alloc = PageAllocator(cfg.n_pages - 1)
    for slot in range(max_seqs):
        write_prompt(cache, cfg, slot, alloc.alloc(slot, pps), uni((n_kv, seq_len, D)).to(bf),
                     uni((n_kv, seq_len, D)).to(bf))
    dq = uni((max_seqs, n_kv, D)).to(bf)
    live = int(cache.lengths.sum())
    page_major = (exp_decode.page_major(cache.k_scales), exp_decode.page_major(cache.v_scales))
    for variant in ("postscale_t", "int8mm_t", "current", "postscale", "int8mm"):
        scales = (cache.k_scales, cache.v_scales) if variant.endswith("_t") else page_major
        args = (variant, dq, cache.k_pages, cache.v_pages, *scales, cache.page_tables,
                cache.lengths)
        runs.append(("exp_paged_decode", variant,
                     lambda args=args: exp_decode.paged_decode(*args),
                     lambda args=args: exp_decode.paged_decode_plain(*args),
                     live * n_kv * (2 * D + 2 * 4) + 2 * dq.numel() * 2,
                     4 * dq.shape[1] * D * live, "int8" if "int8mm" in variant else "bf16", None,
                     exp_tol, args if variant.startswith("int8mm") else None))

    # the tools' entry points, each instantiation once, counted
    native.reset_launch_counts()
    torch.cuda.synchronize()
    outs = [fn() for _, _, fn, *_ in runs]
    torch.cuda.synchronize()
    launches = {kn: native.LAUNCHES[kn] for kn in native.EXPERIMENT_KERNELS}
    if min(launches.values()) < 1:
        fail(f"phase 8: an experiment kernel never launched: {launches}")

    entries, oracle = {}, None
    for (kernel, variant, fn, plain, n_bytes, n_ops, ops_type, lib, tol, codes), o in zip(runs,
                                                                                      outs):
        ref = plain()
        torch.cuda.synchronize()
        err, limit = float((o.float() - ref.float()).abs().max()), tol(ref)
        if not torch.isfinite(o).all() or o.shape != ref.shape or err > limit:
            fail(f"phase 8: {kernel} {variant} max error {err} > {limit}")
        extra = {"body": native.EXP_FWD_BODY[kernel]} if kernel in native.EXP_FWD_BODY else {}
        if kernel == "exp_resident_fwd":   # exact causal attention (the tool's own check)
            if oracle is None:
                oracle = exp_resident.causal_oracle(q, k, v).float()
            oracle_err = float((o.float() - oracle).abs().max())
            if oracle_err >= 1e-2:
                fail(f"phase 8: {kernel} {variant} differs from the dense causal oracle by "
                     f"{oracle_err}")
            extra["oracle_err"] = oracle_err
        if codes is not None:   # int8mm: q codes, integer scores and p codes bit for bit
            got = exp_decode.paged_decode(*codes, codes=True)
            want = exp_decode.paged_decode_plain(*codes, codes=True)
            for cname, a, b in zip(("q_codes", "scores", "p_codes"), got[1:], want[1:]):
                if not torch.equal(a, b):
                    fail(f"phase 8: {kernel} {variant} {cname} differ in {int((a != b).sum())} "
                         f"places")
            extra["codes_equal"] = True
        ms = time_ms(fn, n=10)
        if kernel in native.EXP_FWD_BODY:   # the variant's walk, as its launches report it
            walk = native.WALKS[kernel]
            if walk["body"] != extra["body"]:
                fail(f"phase 8: {kernel} {variant} ran the {walk['body']} body")
            extra.update(items=walk["items"], grid=walk["grid"])
        if (kernel, variant) in kernel_only:
            extra["kernel_ms"] = time_ms(kernel_only[kernel, variant], n=10)
        plain_ms = time_ms(plain, n=5)
        lib_ms = None if lib is None else time_ms(lib, n=10)
        b_ms, b_by = bound(n_bytes, n_ops, ops_type)
        r = dict(err=err, tol=limit, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=lib_ms, **extra)
        if kernel in ("exp_resident_fwd", "exp_vpu_ladder", "exp_kv_unroll"):
            rate = f"{n_ops / ms / 1e9:.3f} useful TFLOP/s"
        elif kernel == "exp_paged_decode":
            rate = f"{max_seqs / ms * 1e3:,.0f} tok/s"
        else:   # exp_int4_unpack.py:335 counts the shared K/V once per row
            kvb = ib * ctx * exp_int4_unpack.N_KV * (D * (2.0 if "int8" in variant else 1.0) / 2
                                                      + 8)
            rate = (f"{kvb / ms / 1e6:.0f} GB/s as the tool counts (the shared K/V once per "
                    f"row: {ib}x the bytes of the bound)")
        body = (f" body={extra['body']} items={extra['items']} grid={extra['grid']}"
                if "body" in extra else "")
        if "kernel_ms" in extra:
            body += f" kernel_ms (prescaled q)={extra['kernel_ms']}"
        print(f"kernel {kernel} {variant}:{body} max_abs_err={err} (tol {limit}) ms={ms} "
              f"plain_ms={plain_ms} bound_ms={b_ms} ({b_by}) library_ms={lib_ms}; {rate}",
              flush=True)
        entry = entries.setdefault(kernel, dict(r, variants={}))
        entry["err"] = max(entry["err"], err)
        entry["variants"][variant] = r
    rungs = entries["exp_vpu_ladder"]["variants"]
    print(f"exp_vpu_ladder: prod - nomax (the first pass for each group's maximum) = "
          f"{rungs['prod']['ms'] - rungs['nomax']['ms']} ms", flush=True)
    resident_timer_check(q_res, k, v)
    print(f"phase 8: {time.perf_counter() - t0:.3f} s", flush=True)
    return entries, launches


def resident_timer_check(q_res, k, v):
    """One body, two merges and two timer windows at the tool's shape: the
    op path's resident_fwd and exp_resident_fwd at 128-row items and
    128-key merges (not a pair of the tool) on the same prescaled q, each
    timed in windows of 2 calls (phase 8's) and of 20 (uncounted)."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.block_sizes import choose_block_config
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule
    from tf_flash_attention_tpu_torch.ops import forward
    from tf_flash_attention_tpu_torch.sync_modes import make_sync_pack

    S, d = q_res.shape[1], q_res.shape[2]
    pack, rule = make_sync_pack("none_front", (S,), (S,)), CausalRule()
    with switches(RESIDENT):
        route = forward.forward_route(pack, rule, choose_block_config(d, d), d, d)
    if route.kernel != "resident_fwd":
        fail(f"phase 8: the resident route at the tool's shape is {route.kernel}")
    (seg,) = route.tables(pack, rule, q_res.device)
    rule_c = native.fa_rule(pack, rule)
    fns = {"resident_fwd": lambda: native.resident_fwd(q_res, k, v, rule_c, seg, 128, 128),
           "exp_resident_fwd 128x128": lambda: native.exp_resident_fwd(q_res, k, v, 128, 128)}
    out = {name: {f"ms_{n // 5}_call_windows": time_ms(fn, n=n) for n in (10, 100)}
           for name, fn in fns.items()}
    print(f"resident timer check (8, {S}, {d}) bf16 causal: {json.dumps(out)}", flush=True)


if __name__ == "__main__":
    main()
