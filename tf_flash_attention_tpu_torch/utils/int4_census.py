"""The experiment tools' decode kernels and the serving decode, timed.

    python tf_flash_attention_tpu_torch/utils/int4_census.py [--root DIR]

Imports ``tf_flash_attention_tpu_torch`` from ``--root`` (default: the
tree this file lies in), so that an earlier tree unpacked in a directory of
the checkout (``build/parent``, say; a tree from the one that added
``utils/serving_census.py`` on) is timed by the same code in the same run.
At the int4 unpack tool's shapes (``experiments/exp_int4_unpack.py``: 16
rows, 8 kv heads of 8 query rows, 8,192 keys in pages of 256, d 128, every
row reading the one K/V), each of its six kernels through
``native.exp_int4_decode``; at exp_decode's (``experiments/exp_decode.py``:
16 slots of 8,192 tokens, 8 q / 8 kv heads, d 128, an int8 cache of pages
of 512 written from random bf16 K/V), each of its five variants through
``native.exp_paged_decode``; and ``paged_decode`` at ``chip_smoke.py``
phase 2's int8 case (8 q / 8 kv heads, d 128, page 256, 16 slots of
1-2,047 tokens, slot 3 empty, slot 5 at 512) through
``native.paged_decode``.  For each: CUDA-event ms a call, the device ms a
call of the kernels it launches (``torch.profiler``; each launches one)
and the body the launch reports, with its splits and CTAs ("not
reported" where the tree's launch reports none: the scalar template).
Prints one JSON line naming the tree and the card.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch


def _report(native, kernel: str) -> dict:
    walk = dict(native.WALKS.get(kernel, {}))
    return walk if walk else {"body": "not reported"}


def _launched_ms(fn) -> float:
    """The device ms a call of every kernel ``fn`` launches (one, here), so
    that trees whose kernels have other names time alike."""
    from tf_flash_attention_tpu_torch.utils.serving_census import _kernel_ms
    return _kernel_ms(fn, "")


def tool_times(dev, seed=0) -> dict:
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.experiments import exp_int4_unpack as x
    from tf_flash_attention_tpu_torch.ops.kernel_common import LOG2E
    from tf_flash_attention_tpu_torch.utils.serving_census import _event_ms
    q, (k4, ks4, v4, vs4, _, _, k8, ks8, v8, vs8) = x.build(
        torch.Generator(device=dev).manual_seed(seed), dev)
    c = 1.0 / math.sqrt(x.D) * LOG2E
    out = {}
    for name, kernel in x.KERNELS.items():
        args = (q, k8, ks8, v8, vs8) if kernel.startswith("exp_int4_int8") else (q, k4, ks4, v4,
                                                                                 vs4)
        fn = lambda args=args, kernel=kernel: native.exp_int4_decode(kernel, *args, c)
        fn()
        torch.cuda.synchronize()
        out[name] = {"ms": _event_ms(fn), "kernel_ms": _launched_ms(fn),
                     **_report(native, kernel)}
    return out


def exp_decode_times(dev, seed=0) -> dict:
    """exp_decode's five variants at the tool's shapes (its ``main``'s
    cache, written from this seed's K/V)."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.experiments import exp_decode as x
    from tf_flash_attention_tpu_torch.ops.kernel_common import LOG2E
    from tf_flash_attention_tpu_torch.serving.kv_cache import (KVCacheConfig, PageAllocator,
                                                               PagedKVCache, write_prompt)
    from tf_flash_attention_tpu_torch.utils.serving_census import _event_ms
    S, seq, n_kv, d, page = 16, 8192, 8, 128, 512
    cfg = KVCacheConfig(n_kv_heads=n_kv, head_dim=d, page_size=page,
                        n_pages=S * seq // page + 1, max_seqs=S, max_pages_per_seq=seq // page,
                        quantized=True)
    cache = PagedKVCache.create(cfg, dev)
    alloc = PageAllocator(cfg.n_pages - 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    uni = lambda shape: torch.rand(shape, generator=gen, device=dev) * 2 - 1
    for slot in range(S):
        write_prompt(cache, cfg, slot, alloc.alloc(slot, seq // page),
                     uni((n_kv, seq, d)).to(torch.bfloat16), uni((n_kv, seq, d)).to(torch.bfloat16))
    q = uni((S, n_kv, d)).to(torch.bfloat16)
    scales = {True: (cache.k_scales, cache.v_scales),
              False: (x.page_major(cache.k_scales), x.page_major(cache.v_scales))}
    out = {}
    for variant in x.VARIANTS:
        args = (variant.removesuffix("_t"), q, cache.k_pages, cache.v_pages,
                *scales[variant.endswith("_t")], cache.page_tables, cache.lengths,
                1.0 / math.sqrt(d) * LOG2E)
        fn = lambda args=args: native.exp_paged_decode(*args)
        fn()
        torch.cuda.synchronize()
        out[variant] = {"ms": _event_ms(fn), "kernel_ms": _launched_ms(fn),
                        **_report(native, "exp_paged_decode")}
    return out


def serving_decode_times(dev, seed=0) -> dict:
    """paged_decode at phase 2's int8 case (its shapes; lengths from this
    seed)."""
    from tf_flash_attention_tpu_torch import native
    from tf_flash_attention_tpu_torch.mask_rules import CausalRule
    from tf_flash_attention_tpu_torch.ops.kernel_common import LOG2E
    from tf_flash_attention_tpu_torch.serving import kv_cache
    from tf_flash_attention_tpu_torch.utils.serving_census import _event_ms
    gen = torch.Generator(device=dev).manual_seed(seed)
    S, n_kv, d, ps, mapped = 16, 8, 128, 256, 8
    cfg = kv_cache.KVCacheConfig(n_kv_heads=n_kv, head_dim=d, page_size=ps,
                                 n_pages=S * mapped + S + 1, max_seqs=S,
                                 max_pages_per_seq=2 * mapped, quantized=True,
                                 quant_dtype=torch.int8)
    cache = kv_cache.PagedKVCache.create(cfg, dev)
    for pages in (cache.k_pages, cache.v_pages):
        pages.copy_(torch.randint(-127, 128, pages.shape, generator=gen, device=dev))
    for sc in (cache.k_scales, cache.v_scales):
        sc.copy_(0.005 + 0.02 * torch.rand(sc.shape, generator=gen, device=dev))
    perm = torch.randperm(cfg.n_pages - 1, generator=gen, device=dev)[:S * mapped]
    cache.page_tables[:, :mapped] = perm.reshape(S, mapped).to(torch.int32)
    lengths = torch.randint(1, 2048, (S,), generator=gen, device=dev)
    lengths[3], lengths[5] = 0, 512
    cache.lengths.copy_(lengths.to(torch.int32))
    q = (torch.rand((S, 8, d), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    fn = lambda: native.paged_decode(q, cache, cfg, d ** -0.5 * LOG2E, CausalRule())
    fn()
    torch.cuda.synchronize()
    return {"ms": _event_ms(fn), "kernel_ms": _launched_ms(fn), **_report(native, "paged_decode")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the tree whose tf_flash_attention_tpu_torch to measure")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the census runs only on the GPU")
    sys.path.insert(0, str(args.root.resolve()))
    import tf_flash_attention_tpu_torch as port
    dev = torch.device("cuda", 0)
    where = {"tree": str(args.root), "package": str(Path(port.__file__).parent),
             "card": torch.cuda.get_device_name(0)}
    print(json.dumps({**where, "exp_int4_unpack": tool_times(dev),
                      "exp_decode": exp_decode_times(dev),
                      "paged_decode": serving_decode_times(dev)}), flush=True)


if __name__ == "__main__":
    main()
