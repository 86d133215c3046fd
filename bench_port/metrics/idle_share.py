"""idle_share: the share of the traced stretch in which no operation runs on
the device, on any stream (the complement of the union of the profiler's
device intervals)."""


def read(run):
    tl = run.timeline
    if tl is None or not tl.spans or not tl.device:
        return None
    return 100.0 * (1.0 - tl.busy_seconds() / tl.seconds)
