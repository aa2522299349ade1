"""Smoke-size cells for the benchmark's CPU tests: the committed
configurations' structure at tiny widths, and a tiny chat mix."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for _p in (str(BENCH.parent / "src"), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import spec  # noqa: E402

SMOKE_SIZES = {
    "granite-20b": dict(n_layers=2, d_model=128, n_heads=8, n_kv_heads=1,
                        head_dim=16, d_ff=256, vocab=512, cim_cores=48),
    "deepseek-moe-16b": dict(n_layers=2, d_model=128, n_heads=4,
                             n_kv_heads=4, head_dim=32, d_ff=64, vocab=512,
                             n_experts=8, top_k=2, n_shared_experts=1,
                             d_expert=64, cim_cores=48),
}
SMOKE_MIX = {
    "kind": "serve", "arrivals": "poisson", "order_seed": 0, "rate_per_s": 12.0,
    "prompt": {"dist": "lognormal", "median": 16, "sigma": 1.0, "min": 8,
               "max": 64, "page": 8},
    "output": {"dist": "lognormal", "median": 6, "sigma": 0.8, "min": 2,
               "max": 16},
    "slots": 4, "chunk": 32, "check_sample": 8, "min_sample_tokens": 10,
}


def smoke_cell(workload: str) -> spec.Cell:
    """The committed cell `workload` at smoke size."""
    cell = spec.cell(workload)
    cfg = copy.deepcopy(cell.config)
    m = cfg["model"]
    m.update(SMOKE_SIZES[m["arch"]])
    # logits at d_model 128 spread 0.02 * sqrt(128) ~ 0.23, a seventh of
    # granite-20b's: the smoke model's limit is its own (sound runs read
    # 0 here, the planted faults 0.65 to 1.01)
    m["check"] = {"max_logit_gap": 0.05}
    cell.config = cfg
    cell.traffic = dict(SMOKE_MIX)
    return cell


def run_smoke(workload: str, seed: int = 2147483905, seconds: float = 1.5,
              control: bool = False):
    """One smoke-size run of `workload` on the CPU: (line, checks)."""
    import time
    import torch
    from harness.serve import run_cell
    return run_cell(smoke_cell(workload), seed, seconds, trace=False,
                    device=torch.device("cpu"), t_start=time.perf_counter(),
                    control=control)
