"""Process-local metrics registry: counters, gauges, log-bucketed
histograms, with JSON and Prometheus-text export (port of
`repro/obs/metrics.py`, the same code: plain Python, no framework).

Everything here is host-side Python updated at step boundaries where the
engine has already waited for the device, so recording adds no device
synchronization. Single-threaded by design (the engine loop is); no locks.

Histograms are log-bucketed: geometric bucket boundaries cover 1 us ..
~137 s at x2 per bucket, so TTFT, per-token latency and prefill-chunk
time share one shape. Exact count / sum / min / max ride along, so means
are exact while quantiles are bucket-interpolated.

Export schema (`to_dict`, written by `serve --metrics-out`), the
reference's, so files from both packages line up:

    {"counters":   [{"name", "labels": {..}, "value"}, ...],
     "gauges":     [{"name", "labels": {..}, "value"}, ...],
     "histograms": [{"name", "labels", "count", "sum", "min", "max",
                     "buckets": [[le_or_None, cumulative_count], ...]}]}

`le` is a bucket's inclusive upper bound; the final bucket's bound is
None (JSON has no +Inf). `to_prometheus` renders the same data in the
Prometheus text exposition format (histograms as `_bucket`/`_sum`/
`_count` with an explicit `+Inf` bucket).

Every export takes `extra_labels`, stamped onto every series at export
time (a rank tag in multi-process runs); `merge_registries` merges
per-rank exports (a series in two documents raises) and
`dict_to_prometheus` renders a merged document.
"""
from __future__ import annotations

import bisect
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def default_latency_buckets() -> List[float]:
    """Geometric (x2) bucket bounds, 1 us .. ~137 s — the one shape every
    serve-path latency histogram shares."""
    return [1e-6 * 2.0 ** i for i in range(28)]


class Counter:
    """Monotonically-increasing value family; `labels()` binds a series."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0.0)

    def series(self):
        return sorted(self._series.items())


class Gauge:
    """Set-to-current-value family (occupancy, queue depth, traces)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        self._series[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0.0)

    def series(self):
        return sorted(self._series.items())


class _HistogramSeries:
    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)     # +1 = overflow (+Inf)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class Histogram:
    """Log-bucketed histogram family with exact count/sum/min/max."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        bounds = list(buckets) if buckets is not None \
            else default_latency_buckets()
        if bounds != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name}: bucket bounds must be "
                             "strictly increasing")
        self.bounds = bounds
        self._series: Dict[LabelKey, _HistogramSeries] = {}

    def _get(self, labels: Dict[str, str]) -> _HistogramSeries:
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistogramSeries(len(self.bounds))
        return s

    def observe(self, value: float, **labels) -> None:
        s = self._get(labels)
        s.counts[bisect.bisect_left(self.bounds, value)] += 1
        s.count += 1
        s.sum += value
        s.min = min(s.min, value)
        s.max = max(s.max, value)

    def count(self, **labels) -> int:
        key = _label_key(labels)
        return self._series[key].count if key in self._series else 0

    def sum(self, **labels) -> float:
        key = _label_key(labels)
        return self._series[key].sum if key in self._series else 0.0

    def quantile(self, q: float, **labels) -> float:
        """Bucket-interpolated q-quantile (q in [0, 1]). Exact min/max cap
        the interpolation, so q=0 / q=1 return the true extremes."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None or s.count == 0:
            return 0.0
        target = q * s.count
        cum = 0
        lo = s.min
        for i, c in enumerate(s.counts):
            hi = self.bounds[i] if i < len(self.bounds) else s.max
            hi = min(hi, s.max)
            if c:
                if cum + c >= target:
                    frac = (target - cum) / c
                    lo = max(min(lo, s.max), s.min)
                    return lo + (max(hi, lo) - lo) * frac
                cum += c
            lo = hi
        return s.max

    def series(self):
        return sorted(self._series.items())


class MetricsRegistry:
    """One process-local registry; metric constructors are idempotent
    (same name returns the same family, a kind clash raises)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _register(self, cls, name, help, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.kind}, not {cls.kind}")
            return m
        m = cls(name, help, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def value(self, name: str, **labels) -> float:
        """Convenience probe for counters/gauges (0.0 when absent)."""
        m = self._metrics.get(name)
        if m is None or isinstance(m, Histogram):
            return 0.0
        return m.value(**labels)

    # ------------------------------------------------------------- export

    def to_dict(self, extra_labels: Optional[Dict[str, str]] = None
                ) -> dict:
        extra = _check_extra(extra_labels)
        out = {"counters": [], "gauges": [], "histograms": []}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                for key, s in m.series():
                    cum, buckets = 0, []
                    for i, c in enumerate(s.counts):
                        cum += c
                        le = m.bounds[i] if i < len(m.bounds) else None
                        buckets.append([le, cum])
                    out["histograms"].append({
                        "name": m.name, "labels": _merge_labels(key, extra),
                        "count": s.count, "sum": s.sum,
                        "min": None if s.count == 0 else s.min,
                        "max": None if s.count == 0 else s.max,
                        "buckets": buckets})
            else:
                dest = out["counters"] if isinstance(m, Counter) \
                    else out["gauges"]
                for key, v in m.series():
                    dest.append({"name": m.name,
                                 "labels": _merge_labels(key, extra),
                                 "value": v})
        return out

    def to_json(self, extra_labels: Optional[Dict[str, str]] = None,
                **json_kw) -> str:
        json_kw.setdefault("indent", 2)
        json_kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(extra_labels), **json_kw)

    def to_prometheus(self, extra_labels: Optional[Dict[str, str]] = None
                      ) -> str:
        extra = _check_extra(extra_labels)
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for key, s in m.series():
                    key = _label_key(_merge_labels(key, extra))
                    cum = 0
                    for i, c in enumerate(s.counts):
                        cum += c
                        le = (repr(m.bounds[i]) if i < len(m.bounds)
                              else "+Inf")
                        lk = _label_str(key + (("le", le),))
                        lines.append(f"{m.name}_bucket{lk} {cum}")
                    lines.append(
                        f"{m.name}_sum{_label_str(key)} {s.sum}")
                    lines.append(
                        f"{m.name}_count{_label_str(key)} {s.count}")
            else:
                for key, v in m.series():
                    key = _label_key(_merge_labels(key, extra))
                    lines.append(f"{m.name}{_label_str(key)} {v}")
        return "\n".join(lines) + "\n"

    def write_json(self, path: str,
                   extra_labels: Optional[Dict[str, str]] = None) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(extra_labels))
            f.write("\n")

    def write_prometheus(self, path: str,
                         extra_labels: Optional[Dict[str, str]] = None
                         ) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus(extra_labels))


# -------------------------------------------------- multi-process merge

def _check_extra(extra: Optional[Dict[str, str]]) -> Dict[str, str]:
    return {str(k): str(v) for k, v in (extra or {}).items()}


def _merge_labels(key: LabelKey, extra: Dict[str, str]) -> Dict[str, str]:
    base = dict(key)
    clash = set(base) & set(extra)
    if clash:
        raise ValueError(f"extra label(s) {sorted(clash)} collide with "
                         "instrument labels — a rank tag must not "
                         "overwrite a recorded dimension")
    base.update(extra)
    return base


def merge_registries(docs: Sequence[dict]) -> dict:
    """Merge exported `to_dict` documents (one per rank) into one doc.

    Series identity is (kind, name, labels); an identity appearing in two
    documents raises — that is the double-counting bug this helper exists
    to prevent (two ranks exporting the same un-tagged series would sum
    on any dashboard). Tag each doc at export time
    (`to_dict(extra_labels={"rank": ...})`) and the identities are
    disjoint by construction. Output series are sorted by (name, labels)
    so the merged file is deterministic across gather orders."""
    out = {"counters": [], "gauges": [], "histograms": []}
    seen = set()
    for doc in docs:
        for kind in ("counters", "gauges", "histograms"):
            for e in doc[kind]:
                ident = (kind, e["name"], _label_key(e["labels"]))
                if ident in seen:
                    raise ValueError(
                        f"duplicate series in merge: {kind[:-1]} "
                        f"{e['name']}{_label_str(_label_key(e['labels']))}"
                        " — export each rank with a distinct rank label")
                seen.add(ident)
                out[kind].append(e)
    for kind in out:
        out[kind].sort(key=lambda e: (e["name"],
                                      _label_key(e["labels"])))
    return out


def dict_to_prometheus(doc: dict) -> str:
    """Render a `to_dict`-shaped document (typically `merge_registries`
    output — no live registry exists for it) in the Prometheus text
    format. Emits one # TYPE per family, exactly like `to_prometheus`
    (help strings are registry state and don't survive the JSON round
    trip, so none are emitted)."""
    lines: List[str] = []
    typed = set()

    def _type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for e in sorted(doc["counters"] + doc["gauges"],
                    key=lambda e: (e["name"], _label_key(e["labels"]))):
        kind = "counter" if any(e is c for c in doc["counters"]) \
            else "gauge"
        _type(e["name"], kind)
        lines.append(f"{e['name']}{_label_str(_label_key(e['labels']))} "
                     f"{e['value']}")
    for h in sorted(doc["histograms"],
                    key=lambda e: (e["name"], _label_key(e["labels"]))):
        _type(h["name"], "histogram")
        key = _label_key(h["labels"])
        for le, cum in h["buckets"]:
            lk = _label_str(key + (("le",
                                    "+Inf" if le is None else repr(le)),))
            lines.append(f"{h['name']}_bucket{lk} {cum}")
        lines.append(f"{h['name']}_sum{_label_str(key)} {h['sum']}")
        lines.append(f"{h['name']}_count{_label_str(key)} {h['count']}")
    return "\n".join(lines) + "\n"
