"""Run one cell of the benchmark once, on the machine it is started on.

    python3 bench_port/run.py --workload granite20b.chat --seed 7 \
        --seconds 30 --trace 0

Everything the cell needs is found by name from BENCHMARK.json (see
`harness/spec.py`). The run makes its weights, calibration batches and
traffic from --seed, deploys the program (`repro_torch`) on the card,
warms up the cell's shapes, serves the traffic, checks a sample of what
it served against the plain reference (`reference/`), and prints one
JSON line last on standard output: the end-to-end metrics with
--trace 0, the per-layer metrics (from a profiled sub-window) with
--trace 1. Each number compared for `correct` is printed beside its
limit, last on standard error and under "checks" in the line.

A cell's mix names its kind ("kind": "serve"); the runner of a kind is
`harness/<kind>.py`, whose `run_cell` makes the run and its line, so a
later kind of cell (a training job) comes as files of its own.

Exits non-zero and prints no result without enough CUDA devices, or if
JAX or the JAX package was loaded. --rate overrides the mix's rate (the
knee sweep); --control 1 puts the TF32 control in the program's place in
the comparison (the line must then read not correct: set-up of the
limits). Neither is used by a measured run.
"""
T_START = __import__("time").perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _env():
    """Build and kernel caches at fixed paths inside the checkout."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("USE_FLAX", "0")
    for p in (str(ROOT / "src"), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden():
    """Top-level names in sys.modules that are JAX's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch
    from harness import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{n} available", file=sys.stderr)
        return 2
    if args.rate is not None:
        cell.traffic["rate_per_s"] = args.rate
    runner = importlib.import_module(f"harness.{cell.traffic['kind']}")
    line, checks = runner.run_cell(
        cell, args.seed, args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0), t_start=T_START,
        control=bool(args.control))
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
