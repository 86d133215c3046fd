"""On the card: the control (the reference in float8 e4m3, put in the
program's place) comes out not correct in each serving cell, at the cell's
own size and window, on three seeds, while the program's own widest gap in
the same runs stays within the limit.  Skips without a card.  With ``-s`` it
prints each run's control gap, the program's and the limit.

    python -m pytest bench_port/tests/test_bench_port_control.py -q -s
"""

import json
import time

import pytest
import torch

from conftest import ROOT

CELLS = ("deepseek7b.batch", "mistral7b.chat")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their published widths")
    import run as entry
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    for seed in (3_000_100_001, 3_000_100_002, 3_000_100_003):
        args = entry.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                            "--control", "1"])
        out = entry.execute(ROOT, args, torch.device("cuda", 0), time.perf_counter())
        check = out["checks"]["logit_gap"]
        print(f"{cell} seed {seed}: control {check['value']!r}, program "
              f"{out['readings']['program_logit_gap']!r}, limit {check['limit']!r}, "
              f"{out['readings']['tokens_compared']} tokens", flush=True)
        assert out["correct"] is False and check["value"] > check["limit"]
        assert out["readings"]["program_logit_gap"] <= check["limit"]
