"""queue_wait_p95_ms.chat: the 95th percentile, over every request due in the
window, of the time from its due time to the start of the engine step that
admitted it (the steps already running and the admissions ahead of it); a
request not admitted when the window closes counts with its wait so far."""

from benchlib.arith import percentile


def read(run):
    waits = []
    for r in run.requests:
        due = run.origin + r.due
        if run.w0 <= due < run.w1:
            got = r.admit_step_t if r.admit_step_t is not None else run.w1
            waits.append(max(0.0, min(got, run.w1) - due))
    return 1e3 * percentile(waits, 95) if waits else None
