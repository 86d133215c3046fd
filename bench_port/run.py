"""Run one cell of the port's benchmark once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are those ``BENCHMARK.json`` names (``benchlib/bench.py``
says where each file is found).  The run needs as many CUDA cards as the
cell asks for and exits with code 2, printing no result, without them.  Its
last line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1`` also the
traced stretch's ``busy_s`` and ``window_s``), with ``--trace 1`` a
``breakdown`` of the stretch, and last ``checks``: each number compared
beside its limit, which also end standard error.  It exits with code 3,
printing no result, if a JAX module or the JAX package is loaded once the
window has closed.

``--control 1`` puts the control of ``check.py`` in the program's place in
the comparison, so that the run reads not correct where the limit holds;
the benchmark's own runs leave it off.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import bench  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(device, chips: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def execute(root: Path, args, device, t_start: float) -> dict:
    """Run the cell on ``device`` and return the result's object."""
    import torch
    torch.set_num_threads(2)
    bench_doc = bench.load_benchmark(root)
    cell, config, traffic = bench.cell_inputs(root, bench_doc, args.workload)
    run = bench.Run(root=root, cell=cell, config=config, traffic=traffic, seed=args.seed,
                    seconds=args.seconds, trace=bool(args.trace), t_start=t_start,
                    control=bool(args.control))
    bench.driver(traffic).execute(run, device)
    dev = device_info(device, cell["chips"])
    dev["memory_peak_bytes"] = run.memory_peak_bytes
    out = {"correct": all(ok for *_, ok in run.checks) and bool(run.checks),
           "attempted": run.attempted,
           "failed": run.failed,
           "metrics": bench.read_metrics(run, bench.metrics_for(bench_doc, cell["name"],
                                                                run.trace)),
           "device": dev}
    if run.trace and run.timeline is not None:
        dev["busy_s"] = run.timeline.busy_seconds() if run.timeline.spans else 0.0
        dev["window_s"] = run.timeline.seconds if run.timeline.spans else 0.0
        out["breakdown"] = {"device_ops": run.timeline.top_ops(10),
                            "idle_gaps": run.timeline.gaps_by_host(10)}
    if run.readings:
        out["readings"] = dict(run.readings)
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit, _ in run.checks}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    cell = bench.find(bench.load_benchmark(ROOT)["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = execute(ROOT, args, torch.device("cuda", 0), T_START)
    bad = bench.forbidden_modules()
    if bad:
        print(f"loaded what the port must not: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
