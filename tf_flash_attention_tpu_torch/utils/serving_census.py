"""The CUDA kernels a serving step launches, and the KV writes' times.

    python tf_flash_attention_tpu_torch/utils/serving_census.py [--root DIR] [--layers N]

Imports ``tf_flash_attention_tpu_torch`` from ``--root`` (default: the
tree this file lies in), so that an earlier tree unpacked in a directory of
the checkout (``build/parent``, say) is measured by the same code in the
same run, through the public entries both trees share.  Prints two JSON
lines, each naming the tree and the card:

- ``kv_writes``: at ``chip_smoke.py`` phase 2's int8 case (8 kv heads,
  d 128, page 256, 16 slots; a 512-token chunk at 1,100 of which 451 rows
  are real, K/V transposed from the projection's (chunk, n_kv, d)), the
  public entries ``write_tokens_at`` (flat and shard 0 of page stride 4)
  and ``append_tokens_batched`` (one token a slot, slots 3 and 7
  inactive), and the same three through the bindings alone
  (``native.kv_chunk_write``, ``native.kv_append``, called as each tree
  takes them): CUDA-event ms a call, the write kernel's own device ms a
  call (``torch.profiler``) and the CUDA kernels one call launches (two
  calls counted);
- ``census``: the 168M decoder's engine (``--layers`` of its 8 layers,
  random weights), flat and cp = 4 on the one card, each with and without
  speculation (3 drafts, gamma 4), serving four 1,100-token prompts: the
  CUDA kernels that the second and third prefill chunk, decode step and
  speculative step each launch (``torch.profiler``; memory copies and sets
  counted apart), with the KV writes' and the most frequent names.  The
  two calls of each launch the same kernels; where their counts differ,
  the profiler dropped events in that run.  The engine's steps are CUDA
  graphs on the card: the first call of each captures it, the second and
  third replay it, and beside the profiler's count of a replay stands the
  graph's own (``step_kernels``: its kernel and memory nodes, counted once
  at capture, and its replays), which is the "kernels a step" figure.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import statistics
import sys
from pathlib import Path

import torch

#: the KV writes' kernels, by the names the profiler lists
KV_KERNELS = ("kv_chunk_write_kernel", "kv_append_kernel")


def kernels_of(fn):
    """(fn()'s result, Counter of the device activities one call of fn
    launches, by name: kernels, memory copies and sets)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, collections.Counter(e.name for e in prof.events()
                                    if e.device_type == torch.autograd.DeviceType.CUDA)


def summary(counts, top=8) -> dict:
    """Kernels and copies/sets of a Counter from ``kernels_of``; the KV
    writes' kernels and the ``top`` most frequent names."""
    copies = sum(n for name, n in counts.items() if name.startswith(("Memcpy", "Memset")))
    return {"kernels": sum(counts.values()) - copies, "copies": copies,
            "kv_writes": sum(n for name, n in counts.items()
                             if any(k in name for k in KV_KERNELS)),
            "top": {name[:60]: n for name, n in counts.most_common(top)}}


def step_kernels(step, counts) -> dict:
    """The ``summary`` of a call of ``step`` from its profiler ``counts``;
    for a graphed step (``serving/graphs.py``), also its graph: the kernel
    and memory nodes libcuda holds, counted once at capture (a replay
    runs them all), the wrappers' launches captured in it and its replays
    so far."""
    out = summary(counts)
    graphs = getattr(step, "graphs", None)
    if graphs:
        g = next(iter(graphs.values()))
        out["graph"] = {"nodes": g.nodes, "wrapper_launches": sum(g.launches.values()),
                        "replays": g.replays}
    return out


def step_census(eng, prompts, n_new=6) -> dict:
    """The device activities of ``eng``'s second and third prefill chunk,
    decode step and speculative step while it serves ``prompts`` (each of
    two chunks or more) for ``n_new`` tokens: {call: [summary of the
    second, of the third]}."""
    watched = {"prefill_chunk": "_chunk_prefill", "decode_step": "_decode_step",
               "spec_step": "_spec_step"}
    out = {}

    def watch(label, inner):
        calls = [0]

        def wrapped(*args, **kwargs):
            calls[0] += 1
            if calls[0] not in (2, 3):
                return inner(*args, **kwargs)
            result, counts = kernels_of(lambda: inner(*args, **kwargs))
            out.setdefault(label, []).append(step_kernels(inner, counts))
            return result
        return wrapped

    steps = {attr: getattr(eng, attr) for attr in watched.values()}
    for label, attr in watched.items():
        setattr(eng, attr, watch(label, steps[attr]))
    try:
        for p in prompts:
            eng.submit(p, max_new_tokens=n_new)
        eng.run()
    finally:
        for attr, step in steps.items():
            setattr(eng, attr, step)
    return out


def _event_ms(fn, n=20, reps=5) -> float:
    """Median CUDA-event ms a call over ``reps`` windows of ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def _kernel_ms(fn, name, n=20):
    """The device ms a call of the kernels named ``name`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name)
    return total / 1e3 / n if total else None


def kv_write_times(dev, seed=0) -> dict:
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.serving import kv_cache
    gen = torch.Generator(device=dev).manual_seed(seed)
    S, n_kv, d, ps, mp, chunk = 16, 8, 128, 256, 16, 512
    cfg = kv_cache.KVCacheConfig(n_kv_heads=n_kv, head_dim=d, page_size=ps,
                                 n_pages=S * mp + 1, max_seqs=S, max_pages_per_seq=mp,
                                 quantized=True, quant_dtype=torch.int8)
    trash = cfg.n_pages - 1
    cache = kv_cache.PagedKVCache.create(cfg, dev)
    cache.page_tables.copy_(torch.randperm(S * mp, generator=gen, device=dev)
                            .reshape(S, mp).to(torch.int32))
    cache.lengths.copy_(torch.randint(1, 2048, (S,), generator=gen, device=dev)
                        .to(torch.int32))
    bf = torch.bfloat16
    k = torch.randn((chunk, n_kv, d), generator=gen, device=dev).to(bf).transpose(0, 1)
    v = torch.randn((chunk, n_kv, d), generator=gen, device=dev).to(bf).transpose(0, 1)
    kn = torch.randn((S, n_kv, d), generator=gen, device=dev).to(bf)
    vn = torch.randn((S, n_kv, d), generator=gen, device=dev).to(bf)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    active[3] = active[7] = False
    calls = {
        "write_tokens_at": (lambda: kv_cache.write_tokens_at(cache, cfg, 0, 1100, k, v, 451,
                                                             trash), KV_KERNELS[0]),
        "write_tokens_at[cp]": (lambda: kv_cache.write_tokens_at(cache, cfg, 0, 1100, k, v,
                                                                 451, trash, 4, 0),
                                KV_KERNELS[0]),
        "append_tokens_batched": (lambda: kv_cache.append_tokens_batched(cache, cfg, kn, vn,
                                                                         active, trash),
                                  KV_KERNELS[1]),
    }
    # the bindings alone, as each tree's native module takes them: a tree
    # with ``chunk_write_meta`` takes the scalars as a device vector; one
    # with ``_owned_rows`` reads strided K/V and sets the lengths in the
    # kernel; an earlier one takes contiguous K/V and the true length
    if hasattr(kv_cache, "chunk_write_meta"):
        meta = kv_cache.chunk_write_meta(0, 1100, 451, trash, 1, dev)[0]
        meta_cp = kv_cache.chunk_write_meta(0, 1100, 451, trash, 4, dev)[0]
        calls.update({
            "native.kv_chunk_write": (lambda: native.kv_chunk_write(cache, cfg, meta, k, v),
                                      KV_KERNELS[0]),
            "native.kv_chunk_write[cp]": (lambda: native.kv_chunk_write(cache, cfg, meta_cp, k,
                                                                        v, 4), KV_KERNELS[0]),
            "native.kv_append": (lambda: native.kv_append(cache, cfg, kn, vn, active),
                                 KV_KERNELS[1])})
    elif hasattr(kv_cache, "_owned_rows"):
        rows = kv_cache._owned_rows(cfg, 1100, 451)
        rows_cp = kv_cache._owned_rows(cfg, 1100, 451, 4, 0)
        calls.update({
            "native.kv_chunk_write": (lambda: native.kv_chunk_write(cache, cfg, 0, 1100, k, v,
                                                                    *rows), KV_KERNELS[0]),
            "native.kv_chunk_write[cp]": (lambda: native.kv_chunk_write(
                cache, cfg, 0, 1100, k, v, *rows_cp, 4, 0), KV_KERNELS[0]),
            "native.kv_append": (lambda: native.kv_append(cache, cfg, kn, vn, active),
                                 KV_KERNELS[1])})
    else:
        kc, vc = k.contiguous(), v.contiguous()
        calls.update({
            "native.kv_chunk_write": (lambda: native.kv_chunk_write(cache, cfg, 0, 1100, kc, vc,
                                                                    451, trash), KV_KERNELS[0]),
            "native.kv_chunk_write[cp]": (lambda: native.kv_chunk_write(
                cache, cfg, 0, 1100, kc, vc, 451, trash, 4, 0), KV_KERNELS[0]),
            "native.kv_append": (lambda: native.kv_append(cache, cfg, kn, vn, active, trash),
                                 KV_KERNELS[1])})
    out = {}
    for label, (fn, name) in calls.items():
        out[label] = {"ms": _event_ms(fn), "kernel_ms": _kernel_ms(fn, name),
                      "kernels_a_call": [summary(kernels_of(fn)[1])["kernels"]
                                         for _ in range(2)]}
    return out


def engine_census(dev, n_layers=8, seed=0) -> dict:
    from tf_flash_attention_tpu_torch.models.transformer import ModelConfig, init_params
    from tf_flash_attention_tpu_torch.parallel.mesh import make_mesh
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig
    mcfg = ModelConfig(vocab=32768, d_model=1024, n_layers=n_layers, n_heads=8, n_kv_heads=8,
                       d_head=128, d_ff=4096, dtype=torch.bfloat16)
    params = init_params(mcfg, torch.Generator().manual_seed(seed), device="cpu")
    pgen = torch.Generator().manual_seed(seed + 1)
    prompts = [torch.randint(1, mcfg.vocab, (1100,), generator=pgen).tolist() for _ in range(4)]
    flat = EngineConfig(max_seqs=16, page_size=256, n_pages=16 * 8 + 16 + 1,
                        max_pages_per_seq=16, quantized_kv=True, prefill_chunk=512)
    cp = EngineConfig(max_seqs=8, page_size=256, n_pages=129, max_pages_per_seq=16,
                      quantized_kv=True, prefill_chunk=512, prefix_caching=False)
    mesh = make_mesh((4,), ("seq",), [dev] * 4)
    out = {}
    for label, ecfg, kw in (("flat", flat, dict(device=dev)), ("cp", cp, dict(mesh=mesh))):
        for spec in (0, 3):
            eng = DecodeEngine(mcfg, params, dataclasses.replace(ecfg, speculative_tokens=spec),
                               **kw)
            out[label + (" speculative" if spec else "")] = step_census(eng, prompts)
            del eng
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the tree whose tf_flash_attention_tpu_torch to measure")
    ap.add_argument("--layers", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the census runs only on the GPU")
    sys.path.insert(0, str(args.root.resolve()))
    import tf_flash_attention_tpu_torch as port
    dev = torch.device("cuda", 0)
    where = {"tree": str(args.root), "package": str(Path(port.__file__).parent),
             "card": torch.cuda.get_device_name(0)}
    print(json.dumps({**where, "kv_writes": kv_write_times(dev)}), flush=True)
    print(json.dumps({**where, "census": engine_census(dev, args.layers)}), flush=True)


if __name__ == "__main__":
    main()
