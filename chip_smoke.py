#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before the final line):
  0. device: requires CUDA (no CPU fallback); prints the card's name and
     power limit as nvidia-smi reports them;
  1. build: compiles the serving kernels from csrc/ with nvcc;
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
     logits of a 512-token prompt's last token must agree.

The last two lines are a JSON object describing the kernels and
{"ok": true, "device": {...}}.
"""

import argparse
import copy
import json
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

    # ---- 1: build ----
    t0 = time.perf_counter()
    lib = native.build()
    native.library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.3f} s", flush=True)

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
    eng = DecodeEngine(mcfg, copy.deepcopy(cpu_model), ecfg, device=dev)
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
    launches = dict(native.LAUNCHES)
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
    for where, model in (("cpu", cpu_model), ("cuda", copy.deepcopy(cpu_model))):
        e = DecodeEngine(mcfg, model, small, device=where)
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

    src = "tf_flash_attention_tpu_torch/csrc/serving_kernels.cu"
    replaces = {
        "paged_decode": "tf_flash_attention_tpu/serving/decode.py:113",
        "paged_prefill": "tf_flash_attention_tpu/serving/prefill.py:49",
        "kv_chunk_write": "tf_flash_attention_tpu/serving/kv_cache.py:286",
        "kv_append": "tf_flash_attention_tpu/serving/kv_cache.py:548",
    }
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": launches[k], "max_abs_err": main_case[k][0],
         "ms": main_case[k][1], "plain_ms": main_case[k][2]} for k in replaces]}))
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
