"""device_idle_share.serve: share of the profiled window in which no
device operation ran, in %."""
from harness import trace


def read(run):
    w = run.window
    if w is None or w.end <= w.start:
        return None
    return 100.0 * (1.0 - trace.busy_us(w.ops) / (w.end - w.start))
