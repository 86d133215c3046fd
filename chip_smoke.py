#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before the final line):
  0. device: requires CUDA (no CPU fallback); prints the card's name and
     power limit as nvidia-smi reports them;
  1. build: compiles every kernel source in csrc/ with nvcc, one process
     per source, all at once;
  2. kernels: each of the four kernels against its plain PyTorch version
     on the card, at the serving slice's shapes (int8 cache, 8 kv heads,
     d 128, page 256, chunk 512, 16 slots), plus a GQA (8 q / 2 kv) case
     and an unquantized bf16 case; the KV writes must match bit for bit
     outside the trash page, the attention kernels within a stated
     tolerance; prints errors and median times (CUDA events);
  3. engine: the 168M decoder (vocab 32768, d_model 1024, 8 layers, 8/8
     heads, d_head 128, d_ff 4096, bf16) with random weights from the seed
     serves 18 requests (prompts of 300-1900 tokens, two sharing a
     page-aligned prefix, 32 greedy tokens each) on 16 slots; checks the
     outputs, the prefix-cache hit and that all four kernels launched;
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
     (h) the q-outer backward, which only a direct call with fused="q"
     reaches, as in the JAX package; then each kernel's median CUDA-event
     time against its plain version, with useful TFLOP/s priced from
     flops.py's schedule by the products each kernel computes;
  6. training at full width: the same 168M decoder (fp32 parameters, bf16
     compute) takes 5 AdamW steps on one seeded batch of 8 x 2048 tokens;
     the first step's loss and gradient norm must match the plain path on
     the card, the loss must fall, and the five steps must launch the
     banded kernels; prints step ms and tokens/s;
  7. one step of the same model at 1 x 512 tokens on the CPU (plain
     versions) and on the card (kernels): the losses must agree.

The kernels' JSON line gives each kernel's launches from the run of the
path that takes it by default ("path": the engine, the training steps or
the op path's public calls), its error and its times.  The last lines are
that JSON object, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# bf16 activations: a logit differs by a few bf16 ulps between two matmul
# orders; 8 layers of bf16 residual rounding bound the CPU-vs-card drift
LOGIT_ATOL = 0.1
# attention outputs are rounded to bf16 once by kernel and plain version
# alike: allow 2 ulps at the output's magnitude
def attn_tol(ref):
    return 2 * 2.0 ** -8 * max(1.0, float(ref.abs().max()))


# op kernels (phase 5): float32 differs from its plain version by summation
# order only, 1e-5 at the output's scale (the reference model allows
# 1e-6 * k_len, 2e-3 at k_len 2000); half outputs are rounded once by both
# sides from float32: 2 ulps of the output type at the tensor's scale (the
# reference model allows 1e-3 * k_len)
def op_tol(dtype, ref):
    ulp = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}[dtype]
    return 2 * ulp * max(1.0, float(ref.float().abs().max()))


# training (phase 6): kernels and plain path both compute attention in
# float32 and round o to bf16, so they part only where a rounding flips (one
# bf16 ulp); through 8 bf16 layers that moves the mean loss (~10.4) by far
# less than 2e-3, and the gradient norm by less than 1%
TRAIN_LOSS_ATOL = 2e-3
TRAIN_GNORM_RTOL = 1e-2
# CPU vs card (phase 7): bf16 matmuls accumulate in other orders on the two
# devices; the mean of 512 token losses agrees to well under 1e-2
CPU_LOSS_ATOL = 1e-2


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, n=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def make_cache(cfg, dev, gen, lengths):
    """A cache with random contents: 8 mapped pages per slot, given lengths."""
    from tf_flash_attention_tpu_torch.serving.kv_cache import PagedKVCache
    cache = PagedKVCache.create(cfg, dev)
    for pages in (cache.k_pages, cache.v_pages):
        if cfg.quantized:
            pages.copy_(torch.randint(-127, 128, pages.shape, generator=gen, device=dev))
        else:
            pages.copy_(torch.randn(pages.shape, generator=gen, device=dev))
    if cfg.quantized:
        for sc in (cache.k_scales, cache.v_scales):
            sc.copy_(0.005 + 0.02 * torch.rand(sc.shape, generator=gen, device=dev))
    S = cfg.max_seqs
    perm = torch.randperm(cfg.n_pages - 1, generator=gen, device=dev)[:S * 8]
    cache.page_tables[:, :8] = perm.reshape(S, 8).to(torch.int32)
    cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32, device=dev))
    return cache


def clone_cache(c):
    import dataclasses
    return dataclasses.replace(c, **{f.name: (None if getattr(c, f.name) is None
                                              else getattr(c, f.name).clone())
                                     for f in dataclasses.fields(c)})


def diff_outside_trash(a, b, trash):
    """Names and mismatch counts of the cache tensors that differ."""
    diffs = []
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        x, y = getattr(a, name), getattr(b, name)
        if x is not None and not torch.equal(x[:, :trash], y[:, :trash]):
            diffs.append(f"{name}: {int((x[:, :trash] != y[:, :trash]).sum())} elements")
    return diffs


def kernel_case(name, n_q, n_kv, quantized, dev, gen):
    """Phase 2 for one configuration; returns {kernel: (err, ms, plain_ms)}."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule
    from tf_flash_attention_tpu_torch.ops.kernel_common import LOG2E
    from tf_flash_attention_tpu_torch.serving import decode, kv_cache, prefill

    d, S, chunk = 128, 16, 512
    cfg = kv_cache.KVCacheConfig(n_kv_heads=n_kv, head_dim=d, page_size=256,
                                 n_pages=S * 8 + S + 1, max_seqs=S, max_pages_per_seq=16,
                                 quantized=quantized, dtype=torch.bfloat16)
    trash = cfg.n_pages - 1
    lengths = torch.randint(1, 2048, (S,), generator=gen, device=dev).tolist()
    lengths[3] = 0          # an empty slot: decode gives exact zeros
    lengths[5] = 512        # a length on a page boundary
    cache = make_cache(cfg, dev, gen, lengths)
    bf = torch.bfloat16
    out = {}

    # K3 kv_chunk_write: a chunk crossing pages, with padding rows
    start, true_len = 1100, 450
    k = torch.randn((n_kv, chunk, d), generator=gen, device=dev).to(bf)
    v = torch.randn((n_kv, chunk, d), generator=gen, device=dev).to(bf)
    ck, cp = clone_cache(cache), clone_cache(cache)
    kv_cache.write_tokens_at(ck, cfg, 0, start, k, v, true_len, trash)
    kv_cache._write_tokens_plain(cp, cfg, 0, start, k, v, true_len, trash)
    torch.cuda.synchronize()
    diffs = diff_outside_trash(ck, cp, trash)
    if diffs:
        fail(f"{name}: kv_chunk_write differs from its plain version: {diffs}")
    out["kv_chunk_write"] = (0.0,
                             time_ms(lambda: native.kv_chunk_write(ck, cfg, 0, start, k, v,
                                                                   true_len, trash)),
                             time_ms(lambda: kv_cache._write_tokens_plain(
                                 cp, cfg, 0, start, k, v, true_len, trash)))

    # K4 kv_append: two inactive slots
    kn = torch.randn((S, n_kv, d), generator=gen, device=dev).to(bf)
    vn = torch.randn((S, n_kv, d), generator=gen, device=dev).to(bf)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    active[3] = active[7] = False
    ck, cp = clone_cache(cache), clone_cache(cache)
    kv_cache.append_tokens_batched(ck, cfg, kn, vn, active, trash)
    kv_cache._append_plain(cp, cfg, kn, vn, active, trash)
    cp.lengths += active.to(torch.int32)
    torch.cuda.synchronize()
    diffs = diff_outside_trash(ck, cp, trash)
    if diffs or not torch.equal(ck.lengths, cp.lengths):
        fail(f"{name}: kv_append differs from its plain version: {diffs}")
    out["kv_append"] = (0.0,
                        time_ms(lambda: native.kv_append(ck, cfg, kn, vn, active, trash)),
                        time_ms(lambda: kv_cache._append_plain(cp, cfg, kn, vn, active, trash)))

    # K1 paged_decode
    q = torch.randn((S, n_q, d), generator=gen, device=dev).to(bf)
    scale = 1.0 / d ** 0.5
    rule = CausalRule()
    o = decode.paged_decode_attention(q, cache, cfg)
    ref = decode._paged_decode_plain(q, cache, cfg, scale, rule)
    torch.cuda.synchronize()
    err = float((o.float() - ref.float()).abs().max())
    if not torch.isfinite(o).all() or err > attn_tol(ref):
        fail(f"{name}: paged_decode max error {err} > {attn_tol(ref)}")
    if not torch.equal(o[3], torch.zeros_like(o[3])):
        fail(f"{name}: paged_decode empty slot is not zero")
    out["paged_decode"] = (err,
                           time_ms(lambda: native.paged_decode(q, cache, cfg, scale * LOG2E, rule)),
                           time_ms(lambda: decode._paged_decode_plain(q, cache, cfg, scale, rule)))

    # K2 paged_prefill: a chunk at position 1024 of slot 0 (a cached prefix)
    start, true_len = 1024, 512
    qp = torch.randn((chunk, n_q, d), generator=gen, device=dev).to(bf)
    o = prefill.paged_prefill_attention(qp, cache, cfg, 0, start, true_len)
    qs = (qp.float() * torch.tensor(scale * LOG2E, dtype=torch.float32)).to(bf)
    ref = prefill._paged_prefill_plain(qs, cache, cfg, 0, start, true_len, rule)
    torch.cuda.synchronize()
    err = float((o[:true_len].float() - ref[:true_len].float()).abs().max())
    if not torch.isfinite(o).all() or err > attn_tol(ref):
        fail(f"{name}: paged_prefill max error {err} > {attn_tol(ref)}")
    total = start + true_len
    out["paged_prefill"] = (err,
                            time_ms(lambda: native.paged_prefill(qs, cache, cfg, 0, start, total,
                                                                 0, -(-total // 256), rule)),
                            time_ms(lambda: prefill._paged_prefill_plain(
                                qs, cache, cfg, 0, start, true_len, rule)))
    for kname, (e, ms, pms) in out.items():
        print(f"kernel {name} {kname}: max_abs_err={e} ms={ms} plain_ms={pms}", flush=True)
    return out


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

    # ---- 1: build (one nvcc per source, all at once) ----
    t0 = time.perf_counter()
    libs = native.build()
    for src in libs:
        native.library(src)
    print(f"build: {sorted(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # ---- 2: kernels against their plain versions ----
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    main_case = kernel_case("int8_8q8kv", 8, 8, True, dev, gen)
    kernel_case("int8_gqa_8q2kv", 8, 2, True, dev, gen)
    kernel_case("bf16_8q8kv", 8, 8, False, dev, gen)

    # ---- 3: the engine at the 168M configuration ----
    mcfg = ModelConfig(vocab=32768, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8,
                       d_head=128, d_ff=4096, dtype=torch.bfloat16)
    ecfg = EngineConfig(max_seqs=16, page_size=256, n_pages=16 * 8 + 16 + 1,
                        max_pages_per_seq=16, quantized_kv=True, prefill_chunk=512)
    cpu_gen = torch.Generator().manual_seed(args.seed)
    t0 = time.perf_counter()
    cpu_model = init_params(mcfg, cpu_gen)
    n_params = sum(p.numel() for p in cpu_model.parameters())
    print(f"model: {n_params} params, init {time.perf_counter() - t0:.3f} s", flush=True)
    eng = DecodeEngine(mcfg, cpu_model, ecfg, device=dev)   # casts its own copy
    prompt_gen = torch.Generator().manual_seed(args.seed + 1)

    def prompt(n):
        return torch.randint(1, mcfg.vocab, (n,), generator=prompt_gen).tolist()

    lens = torch.randint(300, 1901, (18,), generator=prompt_gen).tolist()
    prompts = [prompt(n) for n in lens]
    shared = prompt(512)                      # two full pages
    prompts[4] = shared + prompt(300)
    prompts[5] = shared + prompt(700)
    n_new = 32

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
    rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: native.LAUNCHES[k] for k in native.SERVING_KERNELS}
    for rid, p in zip(rids, prompts):
        got = results.get(rid, [])
        if len(got) != len(p) + n_new or got[:len(p)] != p:
            fail(f"request {rid} returned {len(got)} tokens, expected {len(p) + n_new}")
        if not all(0 <= t < mcfg.vocab for t in got[len(p):]):
            fail(f"request {rid} produced a token outside the vocabulary")
    if eng.prefix_cache.hits < 1:
        fail("the prefix cache never hit")
    if min(launches.values()) < 1:
        fail(f"a kernel of the path never launched: {launches}")
    decode_s = wall - prefill_s[0]
    st = eng.stats
    print(f"engine: {len(rids)} requests, stats {json.dumps(st)}, "
          f"prefix hits {eng.prefix_cache.hits}, launches {json.dumps(launches)}", flush=True)
    print(f"engine: wall {wall:.3f} s; prefill {st['prefill_tokens']} tokens in "
          f"{prefill_s[0]:.3f} s = {st['prefill_tokens'] / prefill_s[0]:.1f} tokens/s; "
          f"decode {st['decode_tokens']} tokens in {decode_s:.3f} s over {st['steps']} steps "
          f"= {st['decode_tokens'] / decode_s:.1f} tokens/s", flush=True)

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

    csrc = "tf_flash_attention_tpu_torch/csrc/"
    replaces = {
        "paged_decode": "tf_flash_attention_tpu/serving/decode.py:113",
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
    measured = dict(main_case, **op)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": csrc + native.KERNEL_SOURCES[k],
         "replaces": replaces[k], "launches": launches[k], "path": path_of[k],
         "max_abs_err": measured[k][0], "ms": measured[k][1], "plain_ms": measured[k][2]}
        for k in replaces]}))
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


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
    """Phase 5.  Returns ({kernel: (max_abs_err, ms, plain_ms)}, {kernel:
    launches in the op path's run})."""
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
    print(f"op (h) gqa 8/2 bf16 q-outer (direct call): launches {json.dumps(qouter_launches)}; "
          f"max_abs_err bwd {err['flash_bwd_qouter']}", flush=True)
    op_launches["flash_bwd_qouter"] = qouter_launches.get("flash_bwd_qouter", 0)
    missing = [kn for kn in native.ATTENTION_KERNELS if not op_launches.get(kn)]
    if missing:
        fail(f"op path: kernels never launched: {missing} ({op_launches})")

    # kernel and plain times (these launches are not counted in any path)
    times = {}

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
    # products per kernel (each 2 * area * width): forward S, PV; fused
    # backward S, dP, dV, dK, dQ; split dQ S, dP, dQ; split dK/dV S, dP, dV, dK
    launch = {
        "flash_fwd": (lambda: native.flash_fwd(q_s, k, v, rule_c, tabs(ft), 128, 128),
                      plain_fwd, 2),
        "banded_fwd": (lambda: native.banded_fwd(q_s, k, v, rule_c, tabs(fb)[0], 128, 128),
                       plain_fwd, 2),
        "resident_fwd": (lambda: native.resident_fwd(q_s, k, v, rule_c, tabs(fr)[0], 128, 128),
                         plain_fwd, 2),
        "flash_bwd_fused": (
            lambda: native.flash_bwd_fused(q_s, k, v, do, lse2, delta, rule_c, tabs(bt), 128,
                                           128, 1.0 / math.log2(math.e)), plain_fused, 5),
        "banded_bwd": (
            lambda: native.banded_bwd(q_s, k, v, do, lse2, delta, rule_c, tabs(bb)[0], 128,
                                      128, 1.0 / math.log2(math.e)), plain_fused, 5),
        "flash_bwd_qouter": (
            lambda: native.flash_bwd_qouter(q_s, k, v, do, lse2, delta, rule_c, tabs(bq), 128,
                                            128, scale), plain_fused, 5),
        "flash_bwd_dq": (
            lambda: native.flash_bwd_dq(q_s, k, v, do, lse2, delta, rule_c, tabs(rdq), 128, 128,
                                        scale), plain_split, 3),
        "flash_bwd_dkv": (
            lambda: native.flash_bwd_dkv(q, k_s, v, do, lse2, delta, rule_c, tabs(rdkv), 128,
                                         128, scale), plain_split, 4),
    }
    for kn, (kern, plain, products) in launch.items():
        ms, plain_ms = time_ms(kern, n=10), time_ms(plain, n=5)
        times[kn] = (ms, plain_ms)
        print(f"kernel {kn} (slice): ms={ms} plain_ms={plain_ms} useful TFLOP/s="
              f"{products * area2 * d / ms / 1e9:.3f}", flush=True)
    split_ms = times["flash_bwd_dq"][0] + times["flash_bwd_dkv"][0]
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
    window = {
        "window_fwd": (lambda: native.window_fwd(qd_s, kd, vd, rc_d, starts_q, fw.band, fw.sub,
                                                 fw.masked),
                       lambda: forward._flash_forward_plain(qd_s, kd, vd, pack_d, local_rule),
                       2),
        "window_bwd": (lambda: native.window_bwd(qd_s, kd, vd, dod, lse2_d, delta_d, rc_d,
                                                 starts_k, bw.band, bw.sub,
                                                 1.0 / math.log2(math.e)),
                       lambda: backward._flash_backward_plain(qd, kd, vd, dod, lse2_d, delta_d,
                                                              pack_d, local_rule, scale_d, "kv"),
                       5),
    }
    for kn, (kern, plain, products) in window.items():
        ms, plain_ms = time_ms(kern, n=10), time_ms(plain, n=5)
        times[kn] = (ms, plain_ms)
        print(f"kernel {kn} (case d, band {fw.band if kn == 'window_fwd' else bw.band}): "
              f"ms={ms} plain_ms={plain_ms} useful TFLOP/s (128-tile schedule)="
              f"{products * area2_d * 64 / ms / 1e9:.3f}", flush=True)
    return {kn: (err[kn],) + times[kn] for kn in native.ATTENTION_KERNELS}, op_launches


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
          f"steps 2-5 {ms:.3f} ms = {8 * 2048 / ms * 1e3:.1f} tokens/s; launches in the 5 "
          f"steps {json.dumps(launches)}", flush=True)
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


if __name__ == "__main__":
    main()
