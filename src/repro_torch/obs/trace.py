"""Per-request span timelines as Chrome trace-event JSON (port of
`repro/obs/trace.py`, the same code).

The engine records spans in seconds since run start (`obs/clock`);
export converts to the microsecond `ts`/`dur` floats the Chrome
trace-event format wants, so the file loads in Perfetto or
chrome://tracing.

Layout used by `launch/scheduler`:

  * pid ENGINE_PID ("engine"), tid 0: whole-engine "decode_step" /
    "prefill_chunk" slices plus "occupancy" counter tracks (live slots,
    prefilling, queued).
  * pid REQUEST_PID ("requests"), one tid per request (tid = rid): a
    "request" slice from arrival to finish, with that request's
    "prefill_chunk" / "decode" slices nested inside it.

Every span also carries its seconds (`dur_s`) in `args`, so sums of
spans reconcile with the engine's latency stats without the
microsecond round trip.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

ENGINE_PID = 1
REQUEST_PID = 2


class TraceBuffer:
    """Append-only list of Chrome trace events (host-side, no clocks of
    its own — callers pass timestamps from `obs/clock`)."""

    def __init__(self):
        self.events: List[dict] = []
        self._named: set = set()

    # ------------------------------------------------------------ naming

    def name_process(self, pid: int, name: str) -> None:
        if ("process", pid) in self._named:
            return
        self._named.add(("process", pid))
        self.events.append({"ph": "M", "name": "process_name", "pid": pid,
                            "tid": 0, "args": {"name": name}})

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        if ("thread", pid, tid) in self._named:
            return
        self._named.add(("thread", pid, tid))
        self.events.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    # ------------------------------------------------------------ events

    def complete(self, name: str, ts_s: float, dur_s: float, *,
                 pid: int = ENGINE_PID, tid: int = 0, cat: str = "serve",
                 args: Optional[Dict] = None) -> None:
        """One complete ("X") slice; ts/dur in SECONDS (relative)."""
        a = dict(args or {})
        a["dur_s"] = dur_s
        self.events.append({"ph": "X", "name": name, "cat": cat,
                            "pid": pid, "tid": tid,
                            "ts": ts_s * 1e6, "dur": dur_s * 1e6,
                            "args": a})

    def instant(self, name: str, ts_s: float, *, pid: int = ENGINE_PID,
                tid: int = 0, cat: str = "serve",
                args: Optional[Dict] = None) -> None:
        self.events.append({"ph": "i", "name": name, "cat": cat,
                            "pid": pid, "tid": tid, "ts": ts_s * 1e6,
                            "s": "t", "args": dict(args or {})})

    def counter(self, name: str, ts_s: float, values: Dict[str, float], *,
                pid: int = ENGINE_PID) -> None:
        self.events.append({"ph": "C", "name": name, "pid": pid, "tid": 0,
                            "ts": ts_s * 1e6, "args": dict(values)})

    # ------------------------------------------------------------ export

    def to_dict(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def to_json(self, **json_kw) -> str:
        json_kw.setdefault("indent", None)
        return json.dumps(self.to_dict(), **json_kw)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")
