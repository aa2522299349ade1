"""Per-request span timelines and the program's host spans as Chrome
trace-event JSON (port of `repro/obs/trace.py`, extended).

The engine records slices in seconds since run start (`obs/clock`);
export converts to the microsecond `ts`/`dur` floats the Chrome
trace-event format wants, so the file loads in Perfetto or
chrome://tracing. A buffer anchored to a run (`anchor`) also keeps the
Unix-nanosecond reading taken at the same instant as its zero, and
exports `ts` on that clock: the clock `torch.profiler` (kineto) puts its
events on, so the file overlays a profiler's Chrome export. Unanchored,
the origin is 0 and `ts` stays relative, as in the reference.

Layout used by `launch/scheduler`:

  * pid ENGINE_PID ("engine"), tid 0: whole-engine "decode_step" /
    "prefill_chunk" slices plus "occupancy" counter tracks (live slots,
    prefilling, queued).
  * pid ENGINE_PID, tid SPAN_TID ("host spans"): the program's host
    spans (`span`), nested: the engine's calls and their phases, the
    captured step's key walk and replay, and inside an eagerly run step
    each layer and its parts (below).
  * pid REQUEST_PID ("requests"), one tid per request (tid = rid): a
    "request" slice from arrival to finish, with that request's
    "prefill_chunk" / "decode" slices nested inside it.

Every X event carries its host seconds (`dur_s`) in `args`. A step slice
lasts from the host's start of the step to its end (the step waited
for); the CUDA-event seconds of the step ride in its args as `device_s`,
the value the engine's serve_prefill_chunk_s / serve_decode_step_s
histograms observe, so sums of `device_s` reconcile with them exactly.

Host spans. `span(name, **args)` writes one X event to the ACTIVE
buffer, or does nothing when none is: an engine makes a buffer active
for the length of one of its calls (`activate`, `engine_buffer`), so
model code opens spans without plumbing. The buffer is the one handed to
the engine (`serve --trace-out`) or, while a torch.profiler session
records and none was handed, the process buffer (`profiled()`). Outside
both, a span costs one global read. Spans are plain Python: they add no
event to the profiler (a `record_function` range would be mirrored onto
the device timeline). A span may carry a device tensor (`defer`) that
the engine copies to the host after the synchronize it already makes
(`resolve`), so recording adds no synchronize.

Span names:

  serve.admit, serve.idle (the loop's sleep until the next arrival)
  serve.prefill {rid, slot, rows, device_s}
    serve.prefill.enqueue, serve.prefill.wait, serve.prefill.sample
  serve.decode {live, device_s}
    serve.decode.call, serve.decode.wait, serve.decode.emit,
    serve.decode.evict
  step.key (the step's input signature and tensor walk), step.replay
  layer {i}: attn.qkv, attn.core, attn.wo, and mlp or moe.router,
    moe.dispatch, moe.experts {routed_rows}, moe.combine, moe.shared
  unembed
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

import torch

ENGINE_PID = 1
REQUEST_PID = 2
SPAN_TID = 1

_ACTIVE: Optional["TraceBuffer"] = None     # where `span` writes now
_PROFILED: Optional["TraceBuffer"] = None   # the process buffer


class TraceBuffer:
    """Append-only list of Chrome trace events (host-side: callers pass
    timestamps from `obs/clock`, relative to `t0`; `span` reads the clock
    itself)."""

    def __init__(self):
        self.events: List[dict] = []
        self._named: set = set()
        self.t0 = 0.0           # perf_counter s the relative times count from
        self.origin_ns = 0      # Unix ns at t0; 0 exports relative times
        self._pending: list = []

    def anchor(self, t0: Optional[float] = None) -> float:
        """Count this buffer's relative seconds from perf_counter second
        `t0` (now when None), paired with the Unix-nanosecond clock read at
        the same instant; returns t0."""
        p, u = time.perf_counter(), time.time_ns()
        self.t0 = p if t0 is None else t0
        self.origin_ns = u - round((p - self.t0) * 1e9)
        return self.t0

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
                 args: Optional[Dict] = None) -> dict:
        """One complete ("X") slice; ts/dur in SECONDS (relative). Returns
        the event."""
        a = dict(args or {})
        a["dur_s"] = dur_s
        ev = {"ph": "X", "name": name, "cat": cat, "pid": pid, "tid": tid,
              "ts": ts_s * 1e6, "dur": dur_s * 1e6, "args": a}
        self.events.append(ev)
        return ev

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

    def resolve(self) -> None:
        """Copy every deferred tensor (`_Span.defer`) to the host into its
        span's args. Call after a synchronize: the copy then waits for
        nothing."""
        for ev, key, tensor, fn in self._pending:
            ev["args"][key] = fn(tensor.tolist())
        self._pending.clear()

    def to_dict(self) -> dict:
        """The Chrome document; `ts` on the Unix clock (microseconds) when
        anchored, relative otherwise."""
        events = list(self.events)
        if self.origin_ns:
            off = self.origin_ns / 1e3
            events = [e if e["ph"] == "M" else dict(e, ts=e["ts"] + off)
                      for e in events]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def to_json(self, **json_kw) -> str:
        json_kw.setdefault("indent", None)
        return json.dumps(self.to_dict(), **json_kw)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")


# ------------------------------------------------------------ host spans

class _Span:
    """One open span of the active buffer (`span`)."""
    __slots__ = ("buf", "name", "args", "t", "deferred")

    def __init__(self, buf: TraceBuffer, name: str, args: Dict):
        self.buf, self.name, self.args = buf, name, args
        self.deferred = []

    def __enter__(self):
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t
        ev = self.buf.complete(self.name, self.t - self.buf.t0, dur,
                               tid=SPAN_TID, cat="span", args=self.args)
        self.buf._pending.extend((ev, *d) for d in self.deferred)
        return False

    def set(self, **args) -> None:
        """Add to this span's args (before it closes)."""
        self.args.update(args)

    def defer(self, key: str, tensor, fn: Callable = lambda v: v) -> None:
        """args[key] := fn(tensor's values as a list), copied to the host
        at the buffer's next `resolve`, not now."""
        self.deferred.append((key, tensor, fn))


class _NoSpan:
    """What `span` returns when no buffer is active: does nothing, and is
    false."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **args) -> None:
        pass

    def defer(self, key, tensor, fn=None) -> None:
        pass


_NO_SPAN = _NoSpan()


def span(name: Optional[str], **args):
    """A context manager that writes one complete event named `name` (with
    `args`) to the active buffer on the host spans' thread, or does
    nothing if no buffer is active or `name` is None."""
    buf = _ACTIVE
    if buf is None or name is None:
        return _NO_SPAN
    return _Span(buf, name, args)


class activate:
    """`with activate(buf) as buf:` makes `buf` the buffer spans go to for
    the block, and restores the one before after it; `activate(None)`
    changes nothing."""
    __slots__ = ("buf", "old")

    def __init__(self, buf: Optional[TraceBuffer]):
        self.buf = buf

    def __enter__(self):
        global _ACTIVE
        self.old = _ACTIVE
        if self.buf is not None:
            self.buf.name_thread(ENGINE_PID, SPAN_TID, "host spans")
            _ACTIVE = self.buf
        return self.buf

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self.old
        return False


def profiled() -> Optional[TraceBuffer]:
    """The process buffer: the host spans engines recorded while a
    torch.profiler session was recording and no buffer was handed to
    them, anchored when it was made (None before the first)."""
    return _PROFILED


def engine_buffer(handed: Optional[TraceBuffer]) -> Optional[TraceBuffer]:
    """The buffer one engine call's spans go to: `handed`, the caller's;
    else, while a torch.profiler session records on this thread, the
    process buffer (made and anchored at first use); else None: spans
    off, for the price of this flag check."""
    global _PROFILED
    if handed is not None:
        return handed
    if not torch.autograd._profiler_enabled():
        return None
    if _PROFILED is None:
        _PROFILED = TraceBuffer()
        _PROFILED.anchor()
        _PROFILED.name_process(ENGINE_PID, "engine")
    return _PROFILED
