"""Everything a run needs, found by name: the cell in `BENCHMARK.json`,
its configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`, which may extend another mix) and the reader
of each metric (`metrics/<metric>.py`). A later change adds a cell, a
configuration, a mix or a metric as new files; none of these is edited.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable          # read(run) -> value or None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json, extensions resolved
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic_file(name: str) -> dict:
    """The mix `name`; an "extends" key names a mix whose parameters it
    takes, its own keys overriding them."""
    mix = load_json(BENCH_DIR / "traffic" / f"{name}.json")
    base = mix.pop("extends", None)
    if base is None:
        return mix
    out = traffic_file(base)
    out.update(mix)
    return out


def reader(name: str) -> Callable:
    """`read` of metrics/<name>.py (a file per metric, loaded by path: a
    metric's name may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(entries, cell: str) -> List[Metric]:
    return [Metric(m["name"], m["unit"], reader(m["name"]))
            for m in entries
            if "workloads" not in m or cell in m["workloads"]]


def cell(name: str) -> Cell:
    """The cell `name` of BENCHMARK.json."""
    bench = load_json(ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(ROOT / conf["file"]),
                traffic=traffic_file(w["traffic"]),
                end_to_end=_metrics(bench["end_to_end"], name),
                per_layer=_metrics(bench["per_layer"], name))


def metric_values(metrics: List[Metric], run) -> Dict[str, dict]:
    """name -> {"value", "unit"} of every metric whose reader finds
    something to read in `run`."""
    out = {}
    for m in metrics:
        v = m.read(run)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out
