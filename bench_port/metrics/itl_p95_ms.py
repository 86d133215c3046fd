"""itl_p95_ms: the 95th percentile of every gap between two consecutive output
tokens of a request, over the gaps that end in the window.  A request's
first two tokens come from one step (its prefill, then that step's
decode), so that gap is 0."""

from benchlib.arith import percentile


def read(run):
    gaps = [b - a for r in run.requests for a, b in zip(r.emits, r.emits[1:])
            if run.w0 < b <= run.w1]
    return 1e3 * percentile(gaps, 95) if gaps else None
