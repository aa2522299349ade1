"""The serve-path clock of the port (port of `repro/obs/clock.py`).

Host time comes from here; device time from CUDA events (`timed_call` on
a CUDA device), which record on the stream, so the host does not wait for
the card until it reads the time.
"""
from __future__ import annotations

import contextlib
import time

import torch


def now() -> float:
    """Monotonic seconds (perf_counter); only differences mean anything."""
    return time.perf_counter()


def timed_call(fn, *args, device=None):
    """(result, seconds) for ONE call. On a CUDA device the time is that
    of CUDA events recorded around the call on the current stream (the
    host synchronizes on the end event); elsewhere it is the host clock."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


class _Stopwatch:
    """Elapsed-seconds holder for `stopwatch()`; frozen when it exits."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._frozen = None

    @property
    def s(self) -> float:
        if self._frozen is not None:
            return self._frozen
        return time.perf_counter() - self._t0

    def freeze(self):
        self._frozen = time.perf_counter() - self._t0


@contextlib.contextmanager
def stopwatch():
    """Coarse phase timing (deploy, build): `with stopwatch() as sw: ...`,
    then `sw.s` seconds."""
    sw = _Stopwatch()
    try:
        yield sw
    finally:
        sw.freeze()
