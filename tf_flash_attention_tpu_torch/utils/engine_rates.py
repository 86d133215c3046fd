"""The flat serving engine's prefill and decode rates at ``chip_smoke.py``
phase 3's configuration.

    python tf_flash_attention_tpu_torch/utils/engine_rates.py [--root DIR] [--reps N]

Imports ``tf_flash_attention_tpu_torch`` from ``--root`` (default: the
tree this file lies in), so that an earlier tree unpacked in a directory of
the checkout (``build/parent``, say) is measured by the same code, through
the public entries both trees share.  The 168M decoder (random weights
from ``--seed``) on one card, int8 KV, pages of 256, 16 slots, chunks of
512, serves phase 3's 18 requests (300 to 1,900 prompt tokens, two sharing
a 512-token prefix) for 32 greedy tokens each, ``--reps`` times on a fresh
engine; the first run warms up and is left out.  Rates as phase 3 reads
them: prefill tokens over the time around each admission's prefill, decode
tokens over the rest of the run's wall clock; and the median wall time of
the steps that admit nothing (decode steps alone, the host's work
included), which spreads less than the rates.  Prints one JSON line with
the tree, the card's name and power limit, and every run's numbers.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch


def serve_rates(eng, prompts, n_new):
    """(prefill tokens/s, decode tokens/s, median ms of a step that admits
    nothing) of ``eng`` serving ``prompts``."""
    prefill_s, step_s = [0.0], []
    inner, inner_step = eng._prefill, eng.step

    def timed(p, slot):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = inner(p, slot)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t
        return r

    def timed_step():
        admitted = eng.stats["admitted"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = inner_step()
        torch.cuda.synchronize()
        if n and eng.stats["admitted"] == admitted:
            step_s.append(time.perf_counter() - t)
        return n

    eng._prefill, eng.step = timed, timed_step
    for p in prompts:
        eng.submit(p, max_new_tokens=n_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats
    return (st["prefill_tokens"] / prefill_s[0], st["decode_tokens"] / (wall - prefill_s[0]),
            1e3 * statistics.median(step_s))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the tree whose tf_flash_attention_tpu_torch to measure")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the rates are measured only on the GPU")
    sys.path.insert(0, str(args.root.resolve()))
    from tf_flash_attention_tpu_torch.models.transformer import ModelConfig, init_params
    from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mcfg = ModelConfig(vocab=32768, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8,
                       d_head=128, d_ff=4096, dtype=torch.bfloat16)
    ecfg = EngineConfig(max_seqs=16, page_size=256, n_pages=16 * 8 + 16 + 1,
                        max_pages_per_seq=16, quantized_kv=True, prefill_chunk=512)
    params = init_params(mcfg, torch.Generator().manual_seed(args.seed), device="cpu")
    pgen = torch.Generator().manual_seed(args.seed + 1)
    prompt = lambda n: torch.randint(1, mcfg.vocab, (n,), generator=pgen).tolist()
    prompts = [prompt(n) for n in torch.randint(300, 1901, (18,), generator=pgen).tolist()]
    shared = prompt(512)
    prompts[4], prompts[5] = shared + prompt(300), shared + prompt(700)
    runs = []
    for _ in range(args.reps):
        eng = DecodeEngine(mcfg, params, ecfg, device=dev)
        runs.append(serve_rates(eng, prompts, 32))
        del eng
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tree": str(args.root), "card": smi,
                      "prefill_tokens_per_s": [r[0] for r in runs[1:]],
                      "decode_tokens_per_s": [r[1] for r in runs[1:]],
                      "decode_step_ms_median": [r[2] for r in runs[1:]],
                      "warm_up": list(runs[0])}), flush=True)


if __name__ == "__main__":
    main()
