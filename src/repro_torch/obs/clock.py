"""The serve-path clock of the port (port of `repro/obs/clock.py`).

Host time comes from here; device time from CUDA events (`timed_call` on
a CUDA device), which record on the stream, so the host does not wait for
the card until it reads the time.
"""
from __future__ import annotations

import contextlib
import time

import torch

from .trace import span


def now() -> float:
    """Monotonic seconds (perf_counter); only differences mean anything."""
    return time.perf_counter()


def timed_call(fn, *args, device=None, spans=(None, None)):
    """(result, seconds) for ONE call. On a CUDA device the time is that
    of CUDA events recorded around the call on the current stream (the
    host synchronizes on the end event); elsewhere it is the host clock.
    `device` may be a list of devices the call enqueues work on: over
    more than one distinct CUDA device the time is the host clock's from
    every device idle to every device done (events time one device
    only). `spans` names the host spans (`obs/trace.span`) of the call
    up to its return and of the wait for the device."""
    call, wait = spans
    with span(call):
        devs = device if isinstance(device, (list, tuple)) else [device]
        devs = list(dict.fromkeys(torch.device(d) for d in devs
                                  if d is not None))
        cuda = [d for d in devs if d.type == "cuda"]
        events = len(cuda) == 1 and len(devs) == 1
        if events:
            with torch.cuda.device(cuda[0]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args)
                end.record()
        else:
            for d in cuda:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            out = fn(*args)
    with span(wait):
        if events:
            end.synchronize()
            return out, start.elapsed_time(end) / 1e3
        for d in cuda:
            torch.cuda.synchronize(d)
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
