"""ttft_p95_ms: the 95th percentile, over every request due in the window, of
the time from its due time to its first token; a request with no first
token when the window closes counts with its wait so far."""

from benchlib.arith import percentile


def read(run):
    waits = []
    for r in run.requests:
        due = run.origin + r.due
        if run.w0 <= due < run.w1:
            got = r.first_t if r.first_t is not None and r.first_t <= run.w1 else run.w1
            waits.append(got - due)
    return 1e3 * percentile(waits, 95) if waits else None
