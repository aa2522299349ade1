"""tpot_p90_ms: 90th percentile, over every request of the window with at
least two tokens, of (last token - first token) / (tokens - 1): the gap a
user sees between tokens, prefill chunks run in between included (host
clock)."""
import numpy as np


def read(run):
    v = [(r.last - r.first) * 1e3 / (len(r.tokens) - 1)
         for r in run.requests if len(r.tokens) >= 2]
    return float(np.percentile(v, 90)) if v else None
