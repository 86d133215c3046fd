"""decode_step_ms: the median wall time of the window's ``run(max_steps=1)``
calls that admitted nothing: one graphed decode step and the host loop
around it (upload of the inputs, the tokens copied back, bookkeeping)."""

import statistics


def read(run):
    walls = [s.t1 - s.t0 for s in run.window_steps() if not s.admitted and s.produced]
    return 1e3 * statistics.median(walls) if walls else None
