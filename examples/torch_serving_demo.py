#!/usr/bin/env python
"""Continuous-batching serving demo with an INT8 paged KV cache on the
PyTorch port (``serving_demo.py``'s model, engine and requests), on the
CUDA card unless ``--device`` says otherwise.

Run: python examples/torch_serving_demo.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from tf_flash_attention_tpu_torch.models.transformer import ModelConfig, init_params
from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig


def main(device=None):
    """Serve the demo's five requests on ``device`` (the card when None);
    returns what it prints: ``results`` ({rid: tokens}), ``prefix_hits``,
    ``prefix_pages`` and ``spec_stats``."""
    device = torch.device("cuda") if device is None else torch.device(device)
    cfg = ModelConfig(vocab=256, d_model=256, n_layers=2, n_heads=8, n_kv_heads=4,
                      d_head=64, d_ff=512, max_seq=512, dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)

    engine = DecodeEngine(cfg, params, EngineConfig(
        max_seqs=4, page_size=128, n_pages=32, max_pages_per_seq=4,
        quantized_kv=True,
        prefill_mode="chunked", prefill_chunk=128,  # chunked prefill
        prefix_caching=True,                        # shared-prefix page reuse
        speculative_tokens=3), device=device)       # prompt-lookup speculation

    shared_prefix = list(range(1, 129))  # one full page, cached after req 0
    rids = [
        engine.submit(shared_prefix + [1, 2, 3], max_new_tokens=12),
        engine.submit(shared_prefix + [9, 8], max_new_tokens=12),  # prefix hit
        engine.submit([42] * 10, max_new_tokens=12),
        engine.submit([5, 5], max_new_tokens=12),
        engine.submit([13, 17, 19], max_new_tokens=12),  # queues until a slot frees
    ]
    results = engine.run(max_steps=60)
    for rid in rids:
        print(f"request {rid}: {results[rid]}")
    out = {"results": {rid: results[rid] for rid in rids},
           "prefix_hits": engine.prefix_cache.hits, "prefix_pages": len(engine.prefix_cache),
           "spec_stats": dict(engine.spec_stats)}
    print(f"prefix cache: {out['prefix_hits']} hits, {out['prefix_pages']} pages registered")
    print(f"speculation: {out['spec_stats']}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
