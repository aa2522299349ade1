"""The program's host spans laid on the traced run's device trace.

The program (`repro_torch.obs.trace`) records host spans into its process
buffer while a torch.profiler session records, on the Unix clock kineto
puts its own events on (`profiled()`; a program without spans has no
such reader, and then every function here finds nothing). The profiler
`Window` keeps times relative to the profiler's start, so the single
offset between the two is fitted from the engine calls both sides mark:
each `bp.prefill` / `bp.decode` range of the harness against the
`serve.prefill` / `serve.decode` span it wraps (`fit_offset`).

What the per-layer metrics read: the share of the chunks' host time
(less their wait for the device) spent in the MoE FFN's spans
(`moe_host_share`), and each chunk's routed rows per expert and layer
(the args of its `moe.experts` spans, `chunks`). Host milliseconds
(`host_ms`, `moe_host_ms`) are read only from a buffer handed to the
engine in a run without the profiler (`trace_report.py --handed 1`):
inside the profiled window they carry the profiler's own cost. For the
report (`report`): each idle gap of the device named by the innermost
program span open at its start, and the idle time inside the harness's
ranges split over the innermost span open at each instant.

Times are microseconds throughout.
"""
from __future__ import annotations

import bisect
import dataclasses
import statistics
from typing import Dict, List, Optional, Tuple

from . import trace

CALLS = {"bp.prefill": "serve.prefill", "bp.decode": "serve.decode"}
MATCH_US = 500.0        # a range and its span start this close, aligned
NO_SPAN = "no program span"


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    args: dict

    @property
    def us(self) -> float:
        return self.end - self.start


def program_spans() -> List[Span]:
    """The X events of the program's process buffer on the Unix clock,
    sorted by start (parents before the children they hold); [] where the
    program keeps none."""
    from repro_torch.obs import trace as program_trace
    read = getattr(program_trace, "profiled", None)
    buf = read() if read is not None else None
    return [] if buf is None else of_buffer(buf)


def of_buffer(buf) -> List[Span]:
    """The host spans of a program trace buffer, on its export clock,
    sorted by start (parents before the children they hold)."""
    out = [Span(e["name"], e["ts"], e["ts"] + e["dur"], e["args"])
           for e in buf.to_dict()["traceEvents"]
           if e["ph"] == "X" and e.get("cat") == "span"]
    return sorted(out, key=lambda s: (s.start, -s.end))


def inside(spans: List[Span], parent: Span) -> List[Span]:
    """The spans that start within `parent` (its descendants; spans
    nest)."""
    starts = [s.start for s in spans]
    i = bisect.bisect_left(starts, parent.start)
    j = bisect.bisect_right(starts, parent.end)
    return [s for s in spans[i:j] if s is not parent and s.end <= parent.end]


def host_ms(spans: List[Span], call: str) -> Optional[float]:
    """Mean over the `call` spans (serve.prefill, serve.decode) of their
    host ms less their `.wait` child; None without one."""
    calls = [s for s in spans if s.name == call]
    if not calls:
        return None
    wait = call + ".wait"
    per = [c.us - sum(s.us for s in inside(spans, c) if s.name == wait)
           for c in calls]
    return sum(per) / len(per) / 1e3


def _moe_us(spans: List[Span]) -> List[float]:
    """Microseconds inside the `moe.*` spans of each serve.prefill span."""
    return [sum(s.us for s in inside(spans, c) if s.name.startswith("moe."))
            for c in spans if c.name == "serve.prefill"]


def moe_host_ms(spans: List[Span]) -> Optional[float]:
    """Mean over the serve.prefill spans of the host ms inside their
    `moe.*` spans; None without a chunk or without MoE spans."""
    per = _moe_us(spans)
    if not any(per):
        return None
    return sum(per) / len(per) / 1e3


def moe_host_share(spans: List[Span]) -> Optional[float]:
    """The % of the serve.prefill spans' host time (less their `.wait`)
    spent inside their `moe.*` spans, summed over the chunks; None without
    a chunk or without MoE spans."""
    per = _moe_us(spans)
    host = host_ms(spans, "serve.prefill")
    if not any(per) or not host:
        return None
    return 100.0 * sum(per) / (host * 1e3 * len(per))


def _marks(window: trace.Window, spans: List[Span]):
    """(call, start) of the harness's bp.prefill / bp.decode ranges, named
    by the span each wraps, and the start times of those spans by call."""
    ranges = [(CALLS[r[0].split(":")[0]], r[1]) for r in window.ranges
              if r[0].split(":")[0] in CALLS]
    marks: Dict[str, List[float]] = {}
    for s in spans:
        if s.name in CALLS.values():
            marks.setdefault(s.name, []).append(s.start)
    return ranges, marks


def _fit(window: trace.Window, spans: List[Span]):
    """(offset, pairs, ranges): the offset (window time = span time +
    offset) that puts the most serve.prefill / serve.decode spans within
    MATCH_US of the start of the bp.prefill / bp.decode range of the same
    kind, trying each span against each of the first ranges, refined to
    the median over those (range start, span start) pairs; the offset is
    None without a pair."""
    ranges, marks = _marks(window, spans)
    best: List[Tuple[float, float]] = []
    for kind, t in ranges[:8]:
        for u in marks.get(kind, []):
            pairs = _pairs(ranges, marks, t - u)
            if len(pairs) > len(best):
                best = pairs
    off = statistics.median(t - u for t, u in best) if best else None
    return off, best, len(ranges)


def fit_offset(window: trace.Window, spans: List[Span]) -> Optional[float]:
    """The offset of `_fit`; None without a pair."""
    return _fit(window, spans)[0]


def _pairs(ranges, marks, offset: float) -> List[Tuple[float, float]]:
    """(range start, span start) of every range whose kind has a span
    starting within MATCH_US of it under `offset`."""
    out = []
    for kind, t in ranges:
        us = marks.get(kind, [])
        i = bisect.bisect_left(us, t - offset - MATCH_US)
        if i < len(us) and abs(us[i] + offset - t) <= MATCH_US:
            out.append((t, us[i]))
    return out


def _shift(spans: List[Span], off: float) -> List[Span]:
    return [Span(s.name, s.start + off, s.end + off, s.args) for s in spans]


def aligned(window: trace.Window, spans: List[Span]) -> List[Span]:
    """The spans moved onto the window's clock; [] when no offset fits."""
    off = fit_offset(window, spans)
    return [] if off is None else _shift(spans, off)


def chunks(window: trace.Window, spans: List[Span]
           ) -> List[Tuple[int, List[List[int]], list]]:
    """(rows, routed rows per expert of each layer, CIM and other device
    operations) of every bp.prefill range with device operations whose
    serve.prefill span aligns with it and whose moe.experts spans all
    carry their counts."""
    on = aligned(window, spans)
    calls = [s for s in on if s.name == "serve.prefill"]
    starts = [c.start for c in calls]
    out = []
    for label, s, e, ops in trace.by_range(window):
        if not label.startswith("bp.prefill:") or not ops:
            continue
        i = bisect.bisect_left(starts, s - MATCH_US)
        if i == len(calls) or abs(calls[i].start - s) > MATCH_US:
            continue
        experts = [x.args.get("routed_rows") for x in inside(on, calls[i])
                   if x.name == "moe.experts"]
        if not experts or any(r is None for r in experts):
            continue
        out.append((int(label.split(":")[1]), experts, ops))
    return out


def segments(spans: List[Span]) -> List[Tuple[float, float, str]]:
    """(start, end, name) pieces of time, each inside the innermost span
    open through it; time outside every span has no piece."""
    out, stack, cur = [], [], None

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))

    for s in spans:
        while stack and stack[-1].end <= s.start:
            top = stack.pop()
            emit(cur, top.end, top.name)
            cur = top.end
        if stack:
            emit(cur, s.start, stack[-1].name)
        stack.append(s)
        cur = s.start
    while stack:
        top = stack.pop()
        emit(cur, top.end, top.name)
        cur = top.end
    return out


def idle_gaps(window: trace.Window) -> List[Tuple[float, float]]:
    """The intervals of the window in which no device operation ran."""
    gaps, cur = [], window.start
    for _, s, e in sorted(window.ops, key=lambda o: o[1]):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if window.end > cur:
        gaps.append((cur, window.end))
    return gaps


def _clip(pieces, ranges) -> List[Tuple[float, float]]:
    """The parts of `pieces` inside `ranges` (each sorted, disjoint)."""
    out, j = [], 0
    for a, b in pieces:
        while j < len(ranges) and ranges[j][1] <= a:
            j += 1
        k = j
        while k < len(ranges) and ranges[k][0] < b:
            lo, hi = max(a, ranges[k][0]), min(b, ranges[k][1])
            if hi > lo:
                out.append((lo, hi))
            k += 1
    return out


def _split(pieces, segs) -> Dict[str, float]:
    """Microseconds of `pieces` under each segment's name (NO_SPAN
    outside every segment)."""
    out: Dict[str, float] = {}
    starts = [a for a, _, _ in segs]
    for a, b in pieces:
        i, t = max(bisect.bisect_right(starts, a) - 1, 0), a
        while i < len(segs) and segs[i][0] < b:
            sa, sb, name = segs[i]
            if sb > a:
                lo, hi = max(sa, a), min(sb, b)
                if lo > t:
                    out[NO_SPAN] = out.get(NO_SPAN, 0.0) + lo - t
                out[name] = out.get(name, 0.0) + hi - lo
                t = hi
            i += 1
        if b > t:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + b - t
    return out


def idle_split(window: trace.Window, spans_on: List[Span]) -> Dict[str, float]:
    """Device-idle microseconds inside the bp.prefill and bp.decode ranges,
    split by the innermost program span open at each instant."""
    ranges = [(s, e) for label, s, e in window.ranges
              if label.split(":")[0] in CALLS]
    return _split(_clip(idle_gaps(window), ranges), segments(spans_on))


def report(window: trace.Window, spans: List[Span]) -> dict:
    """The alignment, the idle split inside the harness's ranges (with the
    share below serve.prefill / serve.decode), and the ten longest idle
    gaps named by the innermost span open at their start."""
    off, best, n_ranges = _fit(window, spans)
    if off is None:
        return {}
    on = _shift(spans, off)
    split = idle_split(window, on)
    total = sum(split.values())
    top = set(CALLS.values()) | {NO_SPAN}
    below = sum(v for k, v in split.items() if k not in top)
    segs = segments(on)
    starts = [a for a, _, _ in segs]

    def innermost(t):
        i = bisect.bisect_right(starts, t) - 1
        return segs[i][2] if i >= 0 and t < segs[i][1] else NO_SPAN

    named = [(innermost(a), (b - a) / 1e3) for a, b in idle_gaps(window)]
    resid = [t - u - off for t, u in best]
    return {
        "offset_us": off, "pairs": len(best), "ranges": n_ranges,
        "pair_residual_us": [min(resid), max(resid)],
        "idle_in_ranges_ms": total / 1e3,
        "idle_below_share": below / total if total else None,
        "idle_by_span_ms": {k: v / 1e3 for k, v in
                            sorted(split.items(), key=lambda kv: -kv[1])},
        "idle_gaps_ms": [[n, g] for n, g in
                         sorted(named, key=lambda g: -g[1])[:10]],
    }
