"""Find the highest arrival rate a serving cell sustains, once, on the card.

    python3 bench_port/sweep.py --workload mistral7b.chat --seed 7 --seconds 40 \
        --rates 6,8,10,12

One engine of the cell, built as ``run.py`` builds it, serves the cell's
traffic mix at each rate in turn for ``--seconds``, from an empty engine
(the previous rate's requests are drained first).  For each rate it prints
one JSON line: the requests due after the first quarter of the stretch,
their time to first token (median, 95th percentile; an unanswered request
counts with its wait so far), the queue left at the end, and the medians of
the first and the second half of those requests' waits, which part where
the backlog grows.  A rate is sustained where the queue does not grow: the
second half's median no more than the first's plus one engine step.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from benchlib import bench, program, serve, traffic  # noqa: E402
from benchlib.arith import percentile  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = HERE.parent
    _, cfg, mix = bench.cell_inputs(root, bench.load_benchmark(root), args.workload)
    dev = torch.device("cuda", 0)
    eng = program.build_engine(cfg, mix["engine"], args.seed, dev)
    warm = traffic.warmup_request(mix, cfg["vocab_size"], args.seed)
    eng.submit(warm.prompt.tolist(), max_new_tokens=warm.max_new)
    while eng.num_active or eng.scheduler.queued:
        eng.run(max_steps=1)
    for rate in (float(r) for r in args.rates.split(",")):
        m = dict(mix, arrival=dict(mix["arrival"], rate_per_s=rate, pre_window_s=0.0))
        reqs = traffic.requests(m, cfg["vocab_size"], args.seed, args.seconds)
        loop = serve.Loop(eng, reqs, serve.clock())
        loop.until(loop.t0 + args.seconds)
        end = serve.clock()
        late = [r for r in reqs if r.due >= args.seconds / 4 and loop.t0 + r.due < end]
        waits = [(r.first_t if r.first_t is not None else end) - (loop.t0 + r.due) for r in late]
        half = len(waits) // 2
        walls = [s.t1 - s.t0 for s in loop.steps if not s.admitted and s.produced]
        print(json.dumps({
            "rate_per_s": rate, "requests": len(late),
            "ttft_median_ms": 1e3 * statistics.median(waits),
            "ttft_p95_ms": 1e3 * percentile(waits, 95),
            "first_half_median_ms": 1e3 * statistics.median(waits[:half]),
            "second_half_median_ms": 1e3 * statistics.median(waits[half:]),
            "queued_at_end": len(loop.queue) + sum(1 for r in loop.pending
                                                     if loop.t0 + r.due < end),
            "decode_step_median_ms": 1e3 * statistics.median(walls) if walls else None,
            "steps": len(loop.steps)}), flush=True)
        loop.pending.clear()
        while loop.busy():
            loop.step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
