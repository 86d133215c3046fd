"""The device timeline of a traced stretch, from ``torch.profiler``.

``Tracer`` starts the profiler (CPU and CUDA activity) at a step boundary
inside the traced window and stops it at a later one, after the device has
drained, so every device operation in the trace belongs to the steps
between.  ``Timeline`` holds what the per-layer readers take from it:

* device operations (kernels, copies, sets) as ``(name, start, end)`` in
  nanoseconds of the profiler's clock;
* the harness's spans (``record_function`` names starting ``bench.``) and
  the host operations inside them, on the same clock;
* the stretch, from the first harness span's start to the last one's end.

Busy time is the union of the device intervals; an idle gap is a stretch
of it in which no operation runs on any stream.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

Interval = Tuple[str, int, int]


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1000)


@dataclasses.dataclass
class Timeline:
    device: List[Interval]
    spans: List[Interval]
    host: List[Interval]

    @property
    def bounds(self) -> Tuple[int, int]:
        return min(s for _, s, _ in self.spans), max(e for _, _, e in self.spans)

    @property
    def seconds(self) -> float:
        lo, hi = self.bounds
        return (hi - lo) / 1e9

    def kernels(self, patterns: Sequence[str]) -> List[Interval]:
        """The device operations whose name holds any of ``patterns``."""
        return [iv for iv in self.device if any(p in iv[0] for p in patterns)]

    def busy_seconds(self) -> float:
        lo, hi = self.bounds
        return sum(e - s for s, e in merged(self.device, lo, hi)) / 1e9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        lo, hi = self.bounds
        gaps, cur = [], lo
        for s, e in merged(self.device, lo, hi):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((cur, hi))
        return gaps

    def top_ops(self, n: int = 10) -> List[list]:
        """The device operations that took most time, summed by name."""
        tot: Dict[str, int] = collections.Counter()
        for name, s, e in self.device:
            tot[name] += e - s
        return [[name, ns / 1e9] for name, ns in tot.most_common(n)]

    def gaps_by_host(self, n: int = 10) -> List[list]:
        """Idle seconds summed by what the host was doing at each gap's
        middle: the harness span open there and the innermost host
        operation inside it (``harness`` where no span is open)."""
        spans = sorted(self.spans, key=lambda iv: iv[1])
        host = sorted(self.host, key=lambda iv: iv[1])
        starts = [s for _, s, _ in host]
        span_starts = [s for _, s, _ in spans]
        tot: Dict[str, int] = collections.Counter()
        for s, e in self.idle_gaps():
            mid = (s + e) // 2
            label = "harness"
            i = bisect.bisect_right(span_starts, mid) - 1
            if i >= 0 and spans[i][2] >= mid:
                label = spans[i][0]
                inner = _innermost(host, starts, mid)
                if inner:
                    label += "/" + inner
            tot[label] += e - s
        return [[name, ns / 1e9] for name, ns in tot.most_common(n)]


def _innermost(host: List[Interval], starts: List[int], t: int, look: int = 400) -> Optional[str]:
    """The latest-starting host operation open at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - look), -1):
        if host[j][2] >= t:
            return host[j][0]
    return None


def merged(intervals: Iterable[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the intervals, clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    out: List[List[int]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for _, s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Tracer:
    """``torch.profiler`` over one stretch of steps (CUDA activity where
    the run is on the card).  ``warm()``, in set-up, runs one throwaway
    cycle: the first start of the profiler initialises CUPTI, which takes
    seconds."""

    def __init__(self, cuda: bool):
        self.acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            self.acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.cuda = cuda
        self.prof = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def warm(self) -> None:
        with torch.profiler.profile(activities=self.acts):
            torch.ones(8, device="cuda" if self.cuda else "cpu").sum()
            self._sync()

    def start(self) -> None:
        self._sync()
        self.prof = torch.profiler.profile(activities=self.acts)
        self.prof.start()

    def stop(self) -> None:
        self._sync()
        self.prof.stop()

    def timeline(self) -> Timeline:
        dev, spans, host = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            s = _ns(e, "start")
            iv = (e.name(), s, s + _ns(e, "duration"))
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # the GPU side of a harness span covers its idle time too
                if not iv[0].startswith("bench."):
                    dev.append(iv)
            elif iv[0].startswith("bench."):
                spans.append(iv)
            else:
                host.append(iv)
        return Timeline(dev, spans, host)


class Stretch:
    """The traced stretch of a window: its last ``SECONDS`` (at most half
    the window).  The profiler starts at the first step boundary past the
    stretch's start and stops once the window has closed, so the seconds
    its stop takes to gather the trace fall outside the window; ``steps``
    are the indices [i0, i1) of the steps between.  Built in set-up, where
    it warms the tracer; no tracer where the run does not trace."""

    SECONDS = 4.0

    def __init__(self, trace: bool, cuda: bool, clock):
        self.tracer = Tracer(cuda) if trace else None
        if self.tracer is not None:
            self.tracer.warm()
        self.clock = clock
        self.lo = self.i0 = self.i1 = None

    def open(self, w0: float, window: float) -> None:
        self.lo = w0 + window - min(self.SECONDS, 0.5 * window)

    def tick(self, n_steps: int) -> None:
        """Called at each step boundary, ``n_steps`` steps done."""
        if self.tracer is not None and self.i0 is None and self.clock() >= self.lo:
            self.tracer.start()
            self.i0 = n_steps

    def close(self, n_steps: int):
        """Stop the profiler once the window has closed; the timeline, or
        None."""
        if self.tracer is None or self.i0 is None:
            return None
        self.tracer.stop()
        self.i1 = n_steps
        return self.tracer.timeline()

    @property
    def steps(self) -> tuple:
        return (self.i0 or 0, self.i1 or 0)
