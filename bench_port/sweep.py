"""Run `run.py` several times in a row, one process at a time, and keep
each run's output: the knee sweep, the seed sets behind the bounds and
the limits, and the trials of a new cell.

    python3 bench_port/sweep.py --out build/sweep \
        --run granite20b.chat:seed=11:seconds=20:rate=6 \
        --run granite20b.chat:seed=12:seconds=20:trace=1

Each --run is a workload and run.py's options as key=value. Writes
<out>/<i>.out and <i>.err per run and prints one summary line per run:
its exit code, wall seconds, and the result line's metrics, checks and
info. Not used by a measured run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def parse(spec: str):
    name, *opts = spec.split(":")
    kw = dict(o.split("=", 1) for o in opts)
    args = ["--workload", name, "--seed", kw.pop("seed"),
            "--seconds", kw.pop("seconds"), "--trace", kw.pop("trace", "0")]
    for k, v in kw.items():
        args += [f"--{k}", v]
    return args


def summary(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if not lines:
        return {}
    r = json.loads(lines[-1])
    m = {k: v["value"] for k, v in r["metrics"].items()}
    c = {k: v["value"] for k, v in r["checks"].items()}
    return {"correct": r["correct"], "metrics": m, "checks": c,
            "info": r.get("info"), "device": r["device"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--run", action="append", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for i, spec in enumerate(args.run):
        t = time.perf_counter()
        p = subprocess.run([sys.executable, str(HERE / "run.py"),
                            *parse(spec)], capture_output=True, text=True)
        wall = time.perf_counter() - t
        (out / f"{i}.out").write_text(p.stdout)
        (out / f"{i}.err").write_text(p.stderr)
        print(json.dumps({"run": spec, "rc": p.returncode, "wall_s": wall,
                          **summary(p.stdout)}), flush=True)
        if p.returncode:
            print(p.stderr[-3000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
