"""serve_tok_s: tokens served in the window (each counted when the step that
made it returns) over the window's seconds."""


def read(run):
    n = sum(1 for r in run.requests for t in r.emits if run.w0 < t <= run.w1)
    return n / run.window_s if run.requests else None
