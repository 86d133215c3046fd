"""Fixtures of the benchmark's CPU tests: run with

    python -m pytest bench_port/tests -q

from the root of the repository.  ``tiny_root`` is a copy of
``BENCHMARK.json`` and ``bench_port/`` with a tiny cell added the way a
later change adds one: new configuration, traffic and metric files and new
entries of ``BENCHMARK.json``, no edit of a file that was there."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH_DIR = HERE.parent
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2}

DUMMY_READER = '''"""dummy_tokens.tiny: tokens served over the whole run (a reader a test adds)."""


def read(run):
    return sum(len(r.emits) for r in run.requests)
'''


def add_tiny_cell(root: Path, window=None, dtype="bfloat16", limit=0.05, offline=False) -> str:
    """Add the cell ``tiny.chat`` to the benchmark copy at ``root`` from new
    files and new entries only (with ``offline``, every request queued
    before the window, as ``batch_4k``); returns its name.  Its per-layer
    metrics are a reader of its own and ``decode_step_ms.tiny``, which finds
    the shared ``decode_step_ms.py``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "bench_port/configs/mistral-7b-v0.1.json").read_text())
    cfg.update(TINY, sliding_window=window, torch_dtype=dtype)
    (root / "bench_port/configs/tiny.json").write_text(json.dumps(cfg))
    mix = {"driver": "serve",
           "arrival": {"kind": "poisson", "rate_per_s": 40.0, "pre_window_s": 0.3},
           "system_prompts": {"count": 2, "tokens": 16},
           "prompt": {"dist": "lognormal", "median": 20, "sigma": 0.5, "min": 4, "max": 40},
           "output": {"dist": "lognormal", "median": 12, "sigma": 0.5, "min": 4, "max": 30},
           "lengths_seed": 0, "warmup": {"prompt_tokens": 32, "new_tokens": 3},
           "engine": {"max_seqs": 4, "page_size": 16, "n_pages": 40, "max_pages_per_seq": 8,
                      "prefill_chunk": 16,
                      "prefix_caching": True},
           "check": {"max_logit_gap": limit, "requests": 6}}
    if offline:
        mix.update(arrival={"kind": "offline", "n_requests": 40}, warm_retired=2)
    (root / "bench_port/traffic/tiny_chat.json").write_text(json.dumps(mix))
    (root / "bench_port/metrics/dummy_tokens.tiny.py").write_text(DUMMY_READER)
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "bench_port/configs/tiny.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.chat", "config": "tiny", "traffic": "tiny_chat",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("ttft_p95_ms", "itl_p95_ms"):
            m["workloads"].append("tiny.chat")
    bench["per_layer"].append({"name": "dummy_tokens.tiny", "unit": "tokens", "better": "higher",
                               "source": "program_counter", "layer": "scheduler",
                               "moves": "ttft_p95_ms", "workloads": ["tiny.chat"]})
    bench["per_layer"].append({"name": "decode_step_ms.tiny", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "model step",
                               "moves": "itl_p95_ms", "workloads": ["tiny.chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "tiny.chat"


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def run_cell(root: Path, cell: str, seed: int = 3_000_000_123, seconds: float = 1.5,
             trace: int = 0, control: int = 0) -> dict:
    """One run of ``cell`` on the CPU, past the harness's look for a card."""
    import time
    import run as entry
    args = entry.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace), "--control", str(control)])
    return entry.execute(root, args, "cpu", time.perf_counter())

