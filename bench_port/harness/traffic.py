"""The one generator of serving traffic: an open loop of requests drawn
from a mix's parameters (`traffic/<mix>.json`) and the run's seed.

Every seed gets the same work: n = round(rate * seconds) requests whose
prompt lengths, output lengths and inter-arrival gaps are the n
quantiles (i + 1/2) / n of the mix's distributions, in one arrangement
fixed by the mix ("order_seed"): which length goes with which request
and which gap comes where. The run's seed draws the prompt tokens (and,
elsewhere, the weights). When a long output arrives decides when the run
drains, so an arrangement drawn per seed would move `tokens_per_s` and
the tails from seed to seed; fixed, two seeds differ in content only,
and a run's spread is the system's, not the sample's.

Distributions: "lognormal" (median, sigma) clipped to [min, max].
Prompt lengths are rounded up to whole pages. Arrivals: "poisson" gaps (exponential quantiles at mean 1 /
rate), the first request due at 0.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np


@dataclasses.dataclass
class Planned:
    rid: int
    prompt: np.ndarray      # (L,) int64 token ids
    max_new: int
    arrival: float          # seconds after the run's start


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n quantiles (i + 1/2) / n of `dist`, ascending, as floats."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(p) for p in u])
        v = dist["median"] * np.exp(dist["sigma"] * z)
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(v, dist["min"], dist["max"])


def lengths(dist: dict, n: int) -> np.ndarray:
    """Whole lengths, rounded up to dist['page'] (default 1)."""
    page = int(dist.get("page", 1))
    v = np.ceil(quantiles(dist, n) / page) * page
    return np.clip(v, dist["min"], dist["max"]).astype(np.int64)


def n_requests(mix: dict, seconds: float) -> int:
    return max(1, int(round(mix["rate_per_s"] * seconds)))


def plan(mix: dict, vocab: int, seed: int, seconds: float) -> List[Planned]:
    """The run's requests, in arrival order."""
    n = n_requests(mix, seconds)
    order = np.random.Generator(np.random.PCG64(int(mix["order_seed"])))
    prompts = order.permutation(lengths(mix["prompt"], n))
    outputs = order.permutation(lengths(mix["output"], n))
    if mix["arrivals"] != "poisson":
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    u = (np.arange(n - 1) + 0.5) / max(n - 1, 1)
    gaps = order.permutation(-np.log1p(-u) / mix["rate_per_s"])
    rng = np.random.Generator(np.random.PCG64(seed))
    arrivals = np.concatenate([[0.0], np.cumsum(gaps)])
    return [Planned(i, rng.integers(0, vocab, size=int(prompts[i]),
                                    dtype=np.int64),
                    int(outputs[i]), float(arrivals[i])) for i in range(n)]


def max_len(mix: dict) -> int:
    """A slot's length: the longest prompt and output the mix can draw."""
    page = int(mix["prompt"].get("page", 1))
    return int(math.ceil(mix["prompt"]["max"] / page) * page
               + mix["output"]["max"])
