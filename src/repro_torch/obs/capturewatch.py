"""Compilation watchdogs for the serving engine's step functions (the
port's counterpart of `repro/obs/jitwatch.py`).

The engine's contract is ONE compiled decode step for every occupancy
pattern. In the reference a compilation is a jit trace; here a step
compiles when

  * its function keeps its own compilation cache (`_cache_size()`, as
    `launch.steps.CapturedStep` does: one CUDA graph per input signature
    and set of input addresses): that cache grows;
  * otherwise: its input signature is new (the shapes and dtypes of its
    tensors, in dicts too, and the values of its static arguments),
    which is what a jit cache counts.

`JitWatcher` only keeps the ledger: it makes the count an exported
metric (`jit_traces{entry=...}`, the reference's names) and, opt-in, a
hard assertion: `strict=True` raises `JitRetraceError` when an entry
passes its budget, and `seal()` after warmup makes any later compilation
raise, naming the entry point. A new signature raises before its call
runs; a function's own cache is read after the call, as the reference
reads jit's. The signature's walk is the host span "step.key"
(`obs/trace.span`).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import torch

from . import clock
from .trace import span


class JitRetraceError(RuntimeError):
    """A sealed (or over-budget, under strict) entry point compiled."""


def tensors(args, static_argnums: Sequence[int] = ()):
    """The tensors of `args` (positional, dicts walked in key order; static
    arguments and everything else left out) as (path, tensor) pairs."""
    out = []

    def walk(path, v):
        if isinstance(v, torch.Tensor):
            out.append((path, v))
        elif isinstance(v, dict):
            for k in sorted(v, key=str):
                walk(path + (k,), v[k])

    for i, a in enumerate(args):
        if i not in static_argnums:
            walk((i,), a)
    return out


def signature(args, static_argnums: Sequence[int] = ()):
    """What a jit cache keys a call on: each tensor's path, shape, dtype
    and device, and the values of the static arguments."""
    return tuple((p, tuple(t.shape), t.dtype, t.device.type)
                 for p, t in tensors(args, static_argnums)) + tuple(
        ("static", i, args[i]) for i in static_argnums)


class WatchedStep:
    """A step function plus its compilation ledger. Drop-in: `__call__`
    forwards to the function; `traces` is the number of compilations."""

    def __init__(self, name: str, fun, *, max_traces: Optional[int],
                 watcher: "JitWatcher", static_argnums: Sequence[int] = ()):
        self.name = name
        self.fun = fun
        self.max_traces = max_traces
        self.static_argnums = tuple(static_argnums)
        self.traces = 0
        self.calls = 0
        self.compile_s = 0.0
        self._seen = set()
        self._watcher = watcher
        functools.update_wrapper(self, fun,
                                 assigned=("__doc__", "__name__"),
                                 updated=())

    def __call__(self, *args):
        t0 = clock.now()
        own = getattr(self.fun, "_cache_size", None)
        if own is None:          # a new signature raises before it runs
            with span("step.key"):
                self._seen.add(signature(args, self.static_argnums))
            self._check(len(self._seen))
        out = self.fun(*args)
        self.calls += 1
        n = len(self._seen) if own is None else own()
        if n > self.traces:
            self.compile_s += clock.now() - t0
            self._check(n)
            self.traces = n
        return out

    def _check(self, n: int) -> None:
        """Raise if compilation #n (a new one) breaks the seal or, under
        strict, the budget; the ledger counts it either way."""
        w = self._watcher
        if n <= self.traces or not (
                w.sealed or (w.strict and self.max_traces is not None
                             and n > self.max_traces)):
            return
        self.traces = n
        raise JitRetraceError(
            f"entry point '{self.name}' compiled (#{n}"
            f"{', sealed after warmup' if w.sealed else ''}"
            f"{'' if self.max_traces is None else f', budget {self.max_traces}'}"
            ") — the one-compilation contract is broken: a new input "
            "shape, dtype or static value, or (captured on the card) new "
            "input tensors")

    @property
    def over_budget(self) -> bool:
        return self.max_traces is not None and self.traces > self.max_traces


class JitWatcher:
    """Compilation ledger over a set of named entry points.

    strict=False (default): compilations are recorded and exported, never
    raised. strict=True: an entry exceeding its `max_traces` budget raises
    at the offending call. `seal()` (either mode) freezes the set — ANY
    later compilation on any entry raises; the engine seals after warmup
    so steady-state serving is compile-free.
    """

    def __init__(self, *, strict: bool = False):
        self.strict = strict
        self.sealed = False
        self.entries: Dict[str, WatchedStep] = {}

    def wrap(self, name: str, fun, *, max_traces: Optional[int] = None,
             static_argnums: Sequence[int] = ()) -> WatchedStep:
        if name in self.entries:
            raise ValueError(f"entry point {name!r} already wrapped")
        ws = WatchedStep(name, fun, max_traces=max_traces, watcher=self,
                         static_argnums=static_argnums)
        self.entries[name] = ws
        return ws

    def seal(self) -> None:
        """Freeze the compilation set: steady state must not compile."""
        self.sealed = True

    def check(self) -> None:
        """The opt-in hard assertion at a report boundary: raise if any
        entry point exceeded its budget during the run."""
        for ws in self.entries.values():
            if ws.over_budget:
                raise JitRetraceError(
                    f"entry point '{ws.name}' compiled {ws.traces} times "
                    f"(budget {ws.max_traces}) — one-compilation contract "
                    "broken")

    def report(self) -> dict:
        return {name: {"traces": ws.traces,
                       "max_traces": ws.max_traces,
                       "calls": ws.calls,
                       "compile_s": ws.compile_s}
                for name, ws in sorted(self.entries.items())}

    def export(self, registry) -> None:
        """Publish the ledger into a MetricsRegistry (report boundary)."""
        g_tr = registry.gauge("jit_traces",
                              "compiled trace count per jit entry point")
        g_bud = registry.gauge("jit_trace_budget",
                               "allowed traces (-1 = unbounded)")
        g_cs = registry.gauge("jit_compile_s",
                              "wall seconds of trace-growing calls")
        c_calls = registry.counter("jit_calls", "calls per entry point")
        for name, ws in sorted(self.entries.items()):
            lab = {"entry": name}
            g_tr.set(ws.traces, **lab)
            g_bud.set(-1 if ws.max_traces is None else ws.max_traces,
                      **lab)
            g_cs.set(ws.compile_s, **lab)
            c_calls.inc(ws.calls - c_calls.value(**lab), **lab)
