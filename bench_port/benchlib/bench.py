"""What a run reads from ``BENCHMARK.json`` and the files it names, and what
it prints.

Everything a cell needs is found by name: its configuration at the
``file`` its ``configs`` entry gives, its traffic mix at
``bench_port/traffic/<traffic>.json`` (whose ``driver`` names the module of
``benchlib`` that runs it), its configuration's plain reference at
``bench_port/references/<reference>.py``, and each metric's reader at
``bench_port/metrics/<metric>.py``, or where there is none, at the file
named by the part of the metric's name before its first dot (one
``idle_share.py`` serves ``idle_share.batch`` and ``idle_share.chat``).  A
reader is a module with ``read(run)``, which returns the metric's value
from the run's records, or None where it finds nothing to read (the metric
is then left out of the result).  Adding a cell, a configuration, a mix
or a metric takes new files and new entries of ``BENCHMARK.json`` only.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, List, Optional

HARNESS = "bench_port"
#: top-level module names no run may load (compared whole: the port's
#: ``tf_flash_attention_tpu_torch`` begins with the JAX package's name)
FORBIDDEN = ("jax", "jaxlib", "flax", "tf_flash_attention_tpu")


@dataclasses.dataclass
class Run:
    """One run's inputs and records, as the metric readers see them."""

    root: Path
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    control: bool = False
    setup_s: Optional[float] = None
    w0: Optional[float] = None        # the measured window, host clock
    w1: Optional[float] = None
    requests: List[Any] = dataclasses.field(default_factory=list)
    steps: List[Any] = dataclasses.field(default_factory=list)
    stats0: dict = dataclasses.field(default_factory=dict)   # engine counters at w0
    stats1: dict = dataclasses.field(default_factory=dict)   # and at w1
    engine: dict = dataclasses.field(default_factory=dict)   # the engine's settings
    timeline: Any = None              # devtrace.Timeline of the traced stretch
    traced: tuple = (0, 0)            # the steps [i0, i1) inside the traced stretch
    memory_peak_bytes: int = 0
    origin: float = 0.0               # host clock at which the traffic's due times start
    attempted: int = 0                # requests in the window
    failed: int = 0                   # compared requests that failed the check
    checks: list = dataclasses.field(default_factory=list)  # (name, value, limit, ok)
    readings: dict = dataclasses.field(default_factory=dict)  # extra numbers (control)

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def window_steps(self) -> list:
        return [s for s in self.steps if s.t0 >= self.w0]

    def traced_steps(self) -> list:
        return self.steps[self.traced[0]:self.traced[1]]


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_inputs(root: Path, bench: dict, cell_name: str):
    """(cell entry, configuration dict, traffic dict) of a cell."""
    cell = find(bench["workloads"], cell_name, "workload")
    conf = find(bench["configs"], cell["config"], "config")
    return (cell, load_json(root / conf["file"]),
            load_json(root / HARNESS / "traffic" / f"{cell['traffic']}.json"))


def metrics_for(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str):
    folder = root / HARNESS / "metrics"
    path = folder / f"{metric}.py"
    if not path.exists():
        path = folder / f"{metric.split('.')[0]}.py"
    return load_module(path, "bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def reference(root: Path, config: dict):
    name = config["reference"]
    return load_module(root / HARNESS / "references" / f"{name}.py", "bench_reference_" + name)


def driver(traffic: dict):
    return importlib.import_module(f"benchlib.{traffic['driver']}")


def forbidden_modules() -> List[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def read_metrics(run: Run, entries: List[dict]) -> dict:
    out = {}
    for m in entries:
        value = reader(run.root, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
