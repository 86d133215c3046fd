"""The serving driver: the port's ``DecodeEngine`` under a traffic mix.

Set-up builds the engine with the seed's weights and serves one warm-up
request, which takes every compiled shape of the cell once (the chunked
prefill's graph and the decode step's).  Then the mix's requests arrive:

* ``offline``: every request is queued at once, and steps run before the
  window until ``warm_retired`` requests have retired, so it opens with
  every slot busy and admissions under way, not with the first batch in
  lockstep;
* ``poisson``: an open loop; requests are submitted when they are due,
  ``pre_window_s`` seconds of traffic run before the window, and each
  request's time counts from its due time.

The window drives ``DecodeEngine.run(max_steps=1)``, one engine step a call
(admission with its chunked prefill, one decode step, retirement), for
``--seconds``, and ends with the first step that ends past it.  A token
counts as served when the step that made it returns.  With ``--trace 1``
``torch.profiler`` covers the steps that start within the traced stretch
(``devtrace.Stretch``).  After the window the engine serves on, with no new
arrivals and outside every metric, until the admitted request with the
longest context has finished, so that the comparison reaches the longest
positions the window served (past Mistral's window, where a request goes
past it).  Then the engine is freed and ``check.py`` compares a sample of
the finished requests with the plain reference.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import time
from typing import List

import torch

from . import check, devtrace, program, traffic as traffic_mod

clock = time.perf_counter


@dataclasses.dataclass
class Step:
    """One ``run(max_steps=1)`` call."""

    t0: float
    t1: float
    admitted: List[int]         # prompt lengths of the requests it admitted
    prefill_tokens: int         # tokens it prefilled (after any cached prefix)
    keys: List[int]             # each decoding slot's keys, its new token's among them
    produced: int               # tokens it served


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Loop:
    def __init__(self, eng, reqs, t0: float):
        self.eng, self.t0 = eng, t0
        self.pending = collections.deque(reqs)
        self.queue = collections.deque()        # submitted, not yet admitted
        self.active: list = []
        self.steps: List[Step] = []

    def submit_due(self, now: float) -> None:
        while self.pending and self.t0 + self.pending[0].due <= now:
            r = self.pending.popleft()
            with torch.profiler.record_function("bench.submit"):
                r.rid = self.eng.submit(r.prompt.tolist(), max_new_tokens=r.max_new)
            self.queue.append(r)

    def step(self) -> None:
        eng = self.eng
        p0 = eng.stats["prefill_tokens"]
        t0 = clock()
        with torch.profiler.record_function("bench.step"):
            res = eng.run(max_steps=1)
        t1 = clock()
        admitted = []
        # admission is first come, first served: the queue's head first
        while self.queue and len(res[self.queue[0].rid]) > len(self.queue[0].prompt):
            r = self.queue.popleft()
            r.admit_step_t = t0
            self.active.append(r)
            admitted.append(len(r.prompt))
        keys, produced, still = [], 0, []
        for r in self.active:
            n = len(res[r.rid]) - len(r.prompt)
            new = n - r.generated
            if new > 0:
                if r.first_t is None:
                    r.first_t = t1
                r.emits.extend([t1] * new)
                produced += new
            if n >= 2 and new > 0:
                keys.append(len(r.prompt) + n - 1)
            r.generated = n
            if n >= r.max_new:
                r.done_t = t1
            else:
                still.append(r)
        self.active = still
        self.steps.append(Step(t0, t1, admitted, eng.stats["prefill_tokens"] - p0, keys,
                               produced))

    def busy(self) -> bool:
        return bool(self.eng.num_active or self.eng.scheduler.queued)

    def until(self, deadline: float, stretch=None) -> None:
        """Serve until ``deadline``; ``stretch`` traces the steps inside it."""
        while True:
            if stretch is not None:
                stretch.tick(len(self.steps))
            now = clock()
            if now >= deadline:
                break
            self.submit_due(now)
            if self.busy():
                self.step()
            elif self.pending:
                with torch.profiler.record_function("bench.wait"):
                    time.sleep(max(0.0, min(self.t0 + self.pending[0].due, deadline) - now))
            else:
                break


def execute(run, device) -> None:
    cfg, mix = run.config, run.traffic
    vocab = cfg["vocab_size"]
    eng = program.build_engine(cfg, mix["engine"], run.seed, device)
    run.engine = dict(mix["engine"])
    warm = traffic_mod.warmup_request(mix, vocab, run.seed)
    eng.submit(warm.prompt.tolist(), max_new_tokens=warm.max_new)
    while eng.num_active or eng.scheduler.queued:
        eng.run(max_steps=1)
    _sync(device)
    # the profiler warms before the traffic starts: its first start takes seconds
    stretch = devtrace.Stretch(run.trace, torch.device(device).type == "cuda", clock)

    reqs = traffic_mod.requests(mix, vocab, run.seed, run.seconds)
    arrival = mix["arrival"]
    loop = Loop(eng, reqs, clock())
    if arrival["kind"] == "offline":
        loop.submit_due(loop.t0)
        retired = eng.stats["retired"] + int(mix["warm_retired"])
        while eng.stats["retired"] < retired:
            loop.step()
    else:
        loop.until(loop.t0 + float(arrival.get("pre_window_s", 0)))
    _sync(device)

    run.w0 = clock()
    run.setup_s = run.w0 - run.t_start
    run.stats0 = dict(eng.stats)
    stretch.open(run.w0, run.seconds)
    loop.until(run.w0 + run.seconds, stretch)
    run.w1 = clock()
    run.timeline, run.traced = stretch.close(len(loop.steps)), stretch.steps
    run.stats1 = dict(eng.stats)
    run.steps, run.requests, run.origin = list(loop.steps), reqs, loop.t0
    run.attempted = sum(1 for r in reqs if loop.t0 + r.due < run.w1
                        and (r.done_t is None or r.done_t >= run.w0))
    if torch.device(device).type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    run.readings["pages_in_use_peak"] = run.stats1["pages_in_use_peak"]
    admitted = [r for r in reqs if r.admit_step_t is not None]
    if admitted:
        # of equal contexts, a finished one saves the wait
        longest = max(admitted, key=lambda r: (len(r.prompt) + r.max_new, r.done_t is not None))
        while longest.done_t is None:
            loop.step()
    results = eng.run(max_steps=0)
    served = {r.rid: results[r.rid][len(r.prompt):] for r in reqs if r.done_t is not None}
    del eng, loop, results
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    check.serve(run, served, device)
