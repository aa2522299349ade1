"""The traced run's device trace: a capped, marked torch.profiler window
inside the measured window, and its reduction to busy time, per-range
kernel times and the breakdown.

The window opens as `chip_smoke.py`'s `marked_window` (commit a424505)
opens its own, a workaround kept as it was found: CUPTI has dropped the
first kernels of a window, so it opens on a pause and PAD_KERNELS short
spin kernels, then a marker kernel, and only what starts after the last
spin kernel is read. Host ranges (`record_function`) mark each prefill
chunk, decode step and admission the engine runs, so every device
operation is put to the range that was open when it started (each of
those calls ends in a synchronize).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

PAD_KERNELS = 64
RANGES = ("bp.decode", "bp.prefill", "bp.admit")


@dataclasses.dataclass
class Window:
    """What the reduction keeps of one profiler window (microseconds)."""
    start: float
    end: float
    ops: List[Tuple[str, float, float]]         # (name, start, end)
    ranges: List[Tuple[str, float, float]]      # (label, start, end)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6


class Profiler:
    """Opens a profiler window once the run is `at` seconds in, closes it
    when it has seen `min_decode` decode steps and `min_prefill` prefill
    chunks, or after `cap_s` seconds. `tick(now)` is called before each
    engine call."""

    def __init__(self, at: float, cap_s: float, min_decode: int,
                 min_prefill: int):
        self.at, self.cap_s = at, cap_s
        self.min_decode, self.min_prefill = min_decode, min_prefill
        self.prof = None
        self.opened = self.closed = False
        self.t_open = 0.0
        self.opened_at = None   # seconds into the run the window opened
        self.seen = {"bp.decode": 0, "bp.prefill": 0}
        self.stall_s = 0.0      # host seconds the run spent opening and
                                # closing the window

    def warm(self):
        """Set-up: one throwaway profiler session, so that CUPTI is loaded
        and initialised before the window opens inside the run (opening
        the first session on the card stalls the engine for seconds)."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda._sleep(50)
            torch.cuda.synchronize()

    def tick(self, now: float, label: str):
        import torch
        t = time.perf_counter()
        if not self.opened and now >= self.at:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            torch.cuda.synchronize()
            self.prof.start()
            time.sleep(0.05)
            for _ in range(PAD_KERNELS):
                torch.cuda._sleep(50)
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)              # the marker
            self.opened, self.t_open = True, time.perf_counter()
            self.opened_at = now
            self.stall_s += self.t_open - t
        elif self.opened and not self.closed:
            done = all(self.seen[k] >= n for k, n in (
                ("bp.decode", self.min_decode),
                ("bp.prefill", self.min_prefill)))
            if done or time.perf_counter() - self.t_open > self.cap_s:
                torch.cuda.synchronize()
                self.prof.stop()
                self.closed = True
                self.stall_s += time.perf_counter() - t
        if self.opened and not self.closed and label in self.seen:
            self.seen[label] += 1

    def finish(self) -> Optional[Window]:
        """Close the window if the run ended inside it; reduce it."""
        if self.prof is None:
            return None
        if not self.closed:
            import torch
            torch.cuda.synchronize()
            self.prof.stop()
            self.closed = True
        return reduce_events(self.prof.events())


def reduce_events(events) -> Optional[Window]:
    """The device operations after the marker and the labelled host
    ranges, or None when the window shows no marker. The profiler mirrors
    each labelled range on the device's timeline; those copies are not
    device operations."""
    dev = sorted(((e.name, e.time_range.start, e.time_range.end)
                  for e in events if e.device_type.name == "CUDA"
                  and e.name.split(":")[0] not in RANGES),
                 key=lambda t: t[1])
    marks = [end for name, _, end in dev if "spin_kernel" in name]
    if not marks:
        return None
    start = marks[-1]
    ops = [o for o in dev if o[1] >= start and "spin_kernel" not in o[0]]
    ranges = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in events if e.device_type.name == "CPU"
                     and e.name.split(":")[0] in RANGES),
                    key=lambda t: t[1])
    ranges = [r for r in ranges if r[1] >= start]
    end = max([o[2] for o in ops] + [r[2] for r in ranges] + [start])
    return Window(start, end, ops, ranges)


def busy_us(ops) -> float:
    """Microseconds in which some device operation ran (their union)."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def is_cim(name: str) -> bool:
    """A kernel of the port's CUDA C++ library (`kernels/build.py`): the
    CIM kernels' term pass, fold and walk."""
    return "cim_" in name


def by_range(w: Window) -> List[Tuple[str, float, float, list]]:
    """Each labelled range with the device operations that started while
    it was open."""
    out, i = [], 0
    ops = w.ops
    for label, s, e in w.ranges:
        while i < len(ops) and ops[i][1] < s:
            i += 1
        j = i
        mine = []
        while j < len(ops) and ops[j][1] <= e:
            mine.append(ops[j])
            j += 1
        out.append((label, s, e, mine))
    return out


def breakdown(w: Window) -> Dict[str, list]:
    """The ten device operations that took most time, and the ten
    longest idle gaps, each named by the host range open at its start
    ('engine host' outside them)."""
    tot: Dict[str, float] = {}
    for name, s, e in w.ops:
        key = name.replace("(anonymous namespace)::", "").split("(")[0][:80]
        tot[key] = tot.get(key, 0.0) + (e - s) / 1e6
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    gaps, cur = [], w.start
    for name, s, e in sorted(w.ops, key=lambda o: o[1]):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w.end > cur:
        gaps.append((cur, w.end))

    def host_at(t):
        for label, s, e in w.ranges:
            if s <= t <= e:
                return label.split(":")[0]
        return "engine host"

    named = sorted(((host_at(a), (b - a) / 1e6) for a, b in gaps),
                   key=lambda g: -g[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in named]}
