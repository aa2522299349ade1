"""Serving-time observability of the port (port of `repro/obs`), host-side
only: recording happens at step boundaries where the engine has already
waited for the device.

  * `metrics`      — counters / gauges / log-bucketed histograms with
                     JSON and Prometheus export;
  * `chipmeter`    — per-compiled-chip dispatch meters: plan geometry x
                     host-counted MVM rows x `core/energy.mvm_cost` =
                     modeled energy and TOPS/W;
  * `trace`        — per-request span timelines as Chrome trace-event
                     JSON (Perfetto);
  * `capturewatch` — compilation counts per engine entry point (a CUDA
                     graph capture on the card, a new input signature
                     elsewhere), the counterpart of `repro/obs/jitwatch`;
  * `clock`        — the serve-path clock (host time, CUDA events).
"""
from . import clock  # noqa: F401
from .capturewatch import JitRetraceError, JitWatcher  # noqa: F401
from .chipmeter import ChipMeter  # noqa: F401
from .metrics import (MetricsRegistry, dict_to_prometheus,  # noqa: F401
                      merge_registries)
from .trace import TraceBuffer  # noqa: F401
