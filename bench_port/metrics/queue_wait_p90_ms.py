"""queue_wait_p90_ms: 90th percentile of the time from when a request was
due to its admission to a slot (the engine's `_admit` call, host clock),
over every request admitted before the traced run's profiler window
opened: opening and closing the window stall the engine (0.7 to 8 s on
the card), and the backlog that leaves behind is the profiler's, not the
engine's. Without a window, over every request."""
import numpy as np


def read(run):
    cut = run.trace_opened_at
    waits = [(r.admit - r.arrival) * 1e3 for r in run.requests
             if cut is None or r.admit < cut]
    return float(np.percentile(waits, 90)) if waits else None
