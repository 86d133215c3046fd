"""The one generator of serving traffic, driven by a ``traffic/*.json`` file.

A mix file gives the arrivals (``offline``: every request queued at once;
``poisson``: an open loop at ``rate_per_s``), the prompt and output length
distributions, optional shared system prompts, and a cap on prompt plus
output.  The lengths, the system prompt each request takes and the gaps
between arrivals are drawn once from the file's own ``lengths_seed``, so
every run seed serves the same sizes at the same due times; the run's
``--seed`` draws the token ids.  (Reordering the sizes by the run seed
made the chat cell's tail latencies differ by a quarter from seed to seed
against a few hundredths between two runs of one seed: the order set the
work.)  Distributions (``min``/``max`` clip every draw):

* ``uniform``: whole numbers in [min, max];
* ``loguniform``: exp of a uniform draw over [ln min, ln max], rounded;
* ``lognormal``: ``median * exp(sigma * N(0, 1))``, rounded.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np


@dataclasses.dataclass(eq=False)
class Req:
    """One request: due ``due`` seconds after the traffic starts."""

    due: float
    prompt: np.ndarray          # int64 token ids
    max_new: int
    rid: Optional[int] = None
    generated: int = 0
    first_t: Optional[float] = None
    admit_step_t: Optional[float] = None
    done_t: Optional[float] = None
    emits: List[float] = dataclasses.field(default_factory=list)


def draw(spec: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` whole-number lengths from the distribution ``spec``."""
    kind, lo, hi = spec["dist"], spec["min"], spec["max"]
    if kind == "uniform":
        x = rng.integers(lo, hi + 1, size=n).astype(np.float64)
    elif kind == "loguniform":
        x = np.exp(rng.uniform(math.log(lo), math.log(hi), size=n))
    elif kind == "lognormal":
        x = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def arrival_offsets(arrival: dict, rng: np.random.Generator, span: float) -> np.ndarray:
    """Exponential gaps at ``rate_per_s`` until their sum passes ``span``
    seconds; returns the gaps (not yet ordered by the run)."""
    rate = float(arrival["rate_per_s"])
    gaps: List[float] = []
    total = 0.0
    while total <= span:
        g = float(rng.exponential(1.0 / rate))
        gaps.append(g)
        total += g
    return np.asarray(gaps)


def requests(traffic: dict, vocab: int, seed: int, seconds: float) -> List[Req]:
    """The run's requests in order of their due times."""
    arrival = traffic["arrival"]
    shape = np.random.default_rng(int(traffic.get("lengths_seed", 0)))
    if arrival["kind"] == "offline":
        gaps = np.zeros(int(arrival["n_requests"]))
    elif arrival["kind"] == "poisson":
        gaps = arrival_offsets(arrival, shape, float(arrival.get("pre_window_s", 0)) + seconds)
    else:
        raise ValueError(f"unknown arrival kind {arrival['kind']!r}")
    n = len(gaps)
    prompt_len = draw(traffic["prompt"], shape, n)
    out_len = draw(traffic["output"], shape, n)
    sys_spec = traffic.get("system_prompts")
    sys_idx = (np.arange(n) % sys_spec["count"]) if sys_spec else np.full(n, -1)
    sys_tokens = int(sys_spec["tokens"]) if sys_spec else 0
    cap = traffic.get("max_total")
    if cap:
        out_len = np.minimum(out_len, cap - sys_tokens - prompt_len)
        if (out_len < 1).any():
            raise ValueError("max_total leaves a request no output")

    run = np.random.default_rng(int(seed))
    systems = [run.integers(0, vocab, size=sys_tokens) for _ in range(sys_spec["count"])
               ] if sys_spec else []
    out = []
    for due, n_prompt, n_out, k in zip(np.cumsum(gaps), prompt_len, out_len, sys_idx):
        body = run.integers(0, vocab, size=int(n_prompt))
        prompt = np.concatenate([systems[k], body]) if k >= 0 else body
        out.append(Req(due=float(due), prompt=prompt.astype(np.int64), max_new=int(n_out)))
    return out


def warmup_request(traffic: dict, vocab: int, seed: int) -> Req:
    """A request that takes every compiled shape of the engine once (a
    prompt of whole chunks and a few decode steps), from the seed."""
    w = traffic["warmup"]
    rng = np.random.default_rng([int(seed), 1])
    return Req(due=0.0, prompt=rng.integers(0, vocab, size=int(w["prompt_tokens"])),
               max_new=int(w["new_tokens"]))
