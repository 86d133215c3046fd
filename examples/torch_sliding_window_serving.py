#!/usr/bin/env python
"""Sliding-window serving demo on the PyTorch port: unbounded streams,
bounded memory (``sliding_window_serving.py``'s model, engine and
request), on the CUDA card unless ``--device`` says otherwise.

A model with ``ModelConfig.rule = LocalRule(window)`` served through the
engine: the paged kernels skip pages below the window and mask it per
element; logical pages wrap modulo ``max_pages_per_seq`` (the rolling page
table), prompts page in lazily chunk by chunk and pages behind the window
are evicted, so the generation runs past the page table's nominal reach
while holding a handful of pages; the int4 (nibble-packed) KV cache halves
the bytes again.

Run: python examples/torch_sliding_window_serving.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from tf_flash_attention_tpu_torch.mask_rules import LocalRule
from tf_flash_attention_tpu_torch.models.transformer import ModelConfig, init_params
from tf_flash_attention_tpu_torch.serving.engine import DecodeEngine, EngineConfig


def main(device=None):
    """Serve the 300-token prompt and 400 new tokens on ``device`` (the card
    when None); returns what it prints: ``tokens`` (the sequence),
    ``stats`` and ``pages_cap`` (the engine's live-set cap a sequence)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    cfg = ModelConfig(vocab=256, d_model=256, n_layers=2, n_heads=8, n_kv_heads=4,
                      d_head=64, d_ff=512, max_seq=4096, dtype=torch.bfloat16,
                      rule=LocalRule(window_size=64, is_causal=True))
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)

    ecfg = EngineConfig(
        max_seqs=2, page_size=32,
        n_pages=16,              # 512 tokens of physical KV, total
        max_pages_per_seq=6,     # table nominally addresses 192 tokens...
        quantized_kv=True, kv_quant_dtype="int4",
        prefill_mode="chunked", prefill_chunk=32,
        prefix_caching=False)    # window models run without the registry
    engine = DecodeEngine(cfg, params, ecfg, device=device)

    # a 300-token prompt (> physical capacity) + 400 generated tokens
    # (> 2x the table's nominal reach): lazy paging + the rolling table
    # keep the live set window-bounded throughout
    prompt = [(7 * i + 3) % cfg.vocab for i in range(300)]
    rid = engine.submit(prompt, max_new_tokens=400)
    toks = engine.run(max_steps=500)[rid]
    print(f"generated {len(toks) - len(prompt)} tokens (sequence length {len(toks)})")
    print("tail:", toks[-16:])
    s = dict(engine.stats)
    print(f"stats: steps={s['steps']} prefill_chunks={s['prefill_chunks']} "
          f"pages_evicted={s['pages_evicted']} "
          f"peak_pages={s['pages_in_use_peak']} of {ecfg.n_pages - 1}")
    if s["pages_in_use_peak"] > engine._pages_cap * ecfg.max_seqs:
        raise AssertionError(f"peak pages {s['pages_in_use_peak']} past the live-set cap "
                             f"{engine._pages_cap} x {ecfg.max_seqs} slots")
    return {"tokens": toks, "stats": s, "pages_cap": engine._pages_cap}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
