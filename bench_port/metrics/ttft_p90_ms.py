"""ttft_p90_ms: 90th percentile, over every request of the window, of the
time from when it was due to its first token (host clock; numpy's linear
percentile)."""
import numpy as np


def read(run):
    return float(np.percentile([(r.first - r.arrival) * 1e3
                                for r in run.requests], 90))
