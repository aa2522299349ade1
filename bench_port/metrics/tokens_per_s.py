"""tokens_per_s: output tokens of every request of the window, over the
time from the first arrival to the last token (host clock)."""


def read(run):
    reqs = run.requests
    span = max(r.last for r in reqs) - min(r.arrival for r in reqs)
    return sum(len(r.tokens) for r in reqs) / span if span > 0 else None
