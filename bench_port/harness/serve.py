"""The runner of a serving mix (`"kind": "serve"`; run.py finds the runner
of a mix's kind as `harness/<kind>.py` and calls its `run_cell`): the
program deployed from the benchmark's seeded weights and calibration
batches, its continuous-batching engine fed the open-loop traffic, every
token timed on the benchmark's own host clock, the result line.

The program is `repro_torch` and nothing else: `serve.serving_config`'s
config at the file's sizes, `steps.arch_serving(...).deploy_cim` (the
path `launch/serve.deploy` runs: `nn.deploy_cim` -> `core/cim` plan ->
schedule -> program 'ideal' -> calibrate -> pack), and
`launch/scheduler.ContinuousBatchingEngine.run`, which serves every
request given to it and returns when the last has finished.

The benchmark's clock: the engine calls `_admit`, `_prefill_one_chunk`
and `_decode_once` for each request admitted, chunk prefilled and step
decoded; the run wraps these three on its engine instance and reads
`time.perf_counter` when each returns, and the engine's own start from
the `now` each call is handed. A request is due at its planned arrival;
its first token is out when the chunk that ends its prompt returns, each
later one when its decode step returns. The engine's start is read once,
at its first call, as the benchmark's clock less the `now` (or the
admission time) that call is handed.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import traffic as traffic_mod
from . import spec
from .check import passed, serving_checks
from .trace import Profiler, Window, breakdown, busy_us
from .weights import make_params, make_x_cal


@dataclasses.dataclass
class Served:
    """One request as the benchmark saw it (seconds after the engine's
    start)."""
    rid: int
    prompt: np.ndarray
    max_new: int
    arrival: float
    admit: float = -1.0
    first: float = -1.0
    last: float = -1.0
    tokens: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServeRun:
    """What the metric readers read."""
    model: dict
    mix: dict
    device_kind: str
    requests: List[Served]
    setup_s: float
    decode_s: float            # the engine's summed serve_decode_step_s
    prefill_s: float           # and serve_prefill_chunk_s
    decode_steps: int
    prefill_chunks: int
    slots: int
    window: Optional[Window] = None
    profiler_stall_s: float = 0.0
    trace_opened_at: Optional[float] = None   # seconds into the run


def port_config(model: dict):
    """The program's ArchConfig of model section `model`: the registered
    arch at the file's sizes, served through packed chips in float32."""
    import torch
    from repro_torch import configs
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
            "vocab", "n_experts", "top_k", "n_shared_experts", "d_expert",
            "rope_theta", "cim_in_bits", "cim_out_bits")
    cfg = configs.get(model["arch"]).replace(
        **{k: model[k] for k in keys}, d_head=model["head_dim"],
        cim_mode="packed", dtype=torch.float32, tie_embeddings=False)
    if cfg.head_dim != model["head_dim"]:
        raise ValueError("head_dim disagrees with the program's config")
    return cfg


def deploy(model: dict, params: dict, x_cal: List[dict], device):
    """The program's deploy of every chip-mapped projection."""
    from repro_torch.core.types import CoreSpec
    from repro_torch.kernels.cim_mvm import kernel as cim_kernel
    from repro_torch.launch.steps import arch_serving
    cfg = port_config(model)
    if device.type == "cuda":
        cim_kernel.load()
    kw = dict(mode=model["cim_mode"], in_alpha=float(model["in_alpha"]),
              spec=CoreSpec(n_cores=int(model["cim_cores"])),
              x_cal=[{k: v for k, v in lay.items() if k != "experts"}
                     for lay in x_cal])
    if model["n_experts"] > 0:
        kw["x_cal_experts"] = [lay["experts"] for lay in x_cal]
    deployed = arch_serving(cfg, device).deploy_cim(dict(params), **kw)
    return cfg, deployed


def _wrap(eng, served: Dict[int, Served], clock: dict, prof, sync):
    """The three engine calls, timed on the benchmark's clock (module
    docstring), each inside a labelled range when traced."""
    from torch.profiler import record_function
    real_admit = eng._admit
    real_prefill = eng._prefill_one_chunk
    real_decode = eng._decode_once

    def ranged(label, fn, *args):
        if prof is None:
            return fn(*args)
        prof.tick(time.perf_counter() - clock["t0"], label.split(":")[0])
        with record_function(label):
            out = fn(*args)
            sync()
        return out

    def start(now):
        if clock["t0"] is None:
            clock["t0"] = time.perf_counter() - now

    def admit(req):
        start(req.t_admit)
        s = served[req.rid]
        s.admit = time.perf_counter() - clock["t0"]
        ranged("bp.admit", real_admit, req)

    def prefill(now):
        start(now)
        job = eng._jobs[0]
        rows = len(job.chunks[job.next])
        n0 = len(job.req.tokens)
        out = ranged(f"bp.prefill:{rows}", real_prefill, now)
        if len(job.req.tokens) > n0:
            s = served[job.req.rid]
            s.first = s.last = time.perf_counter() - clock["t0"]
            s.tokens.append(job.req.tokens[-1])
        return out

    def decode(now):
        start(now)
        live = list(eng._live.values())
        out = ranged("bp.decode", real_decode, now)
        t = time.perf_counter() - clock["t0"]
        for req in live:
            s = served[req.rid]
            s.last = t
            s.tokens.append(req.tokens[-1])
        return out

    eng._admit, eng._prefill_one_chunk, eng._decode_once = \
        admit, prefill, decode


def serve_cell(model: dict, mix: dict, seed: int, seconds: float, *,
               trace: bool, device, t_start: float):
    """Run one serving cell; returns (ServeRun, raw params, x_cal,
    memory peak bytes). The program's state is freed before returning."""
    import torch
    from repro_torch.launch.scheduler import ContinuousBatchingEngine
    from repro_torch.launch.scheduler import Request
    cuda = device.type == "cuda"
    params = make_params(model, seed, device)
    x_cal = make_x_cal(model, params, seed + 1, device)
    plan = traffic_mod.plan(mix, model["vocab"], seed, seconds)
    cfg, deployed = deploy(model, params, x_cal, device)
    eng = ContinuousBatchingEngine(
        cfg, deployed, n_slots=int(mix["slots"]),
        max_len=traffic_mod.max_len(mix), chunk=int(mix["chunk"]))
    reqs = [Request(rid=p.rid, prompt=p.prompt, max_new=p.max_new,
                    arrival=p.arrival) for p in plan]
    served = {p.rid: Served(p.rid, p.prompt, p.max_new, p.arrival)
              for p in plan}
    prof = None
    if trace:
        prof = Profiler(at=0.4 * seconds, cap_s=4.0, min_decode=20,
                        min_prefill=2)
        prof.warm()

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    clock = {"t0": None}
    _wrap(eng, served, clock, prof, sync)
    # run() warms up every chunk length of its requests and the decode
    # step before it serves: timed here, counted as set-up
    real_warmup = eng.warmup
    warm = {"s": 0.0}

    def warmup(chunk_lens):
        t = time.perf_counter()
        real_warmup(chunk_lens)
        warm["s"] = time.perf_counter() - t

    eng.warmup = warmup
    t_call = time.perf_counter()
    eng.run(reqs)
    setup_s = t_call - t_start + warm["s"]
    window = prof.finish() if prof is not None else None
    m = eng.metrics
    hist = {h: m.get(h) for h in ("serve_decode_step_s",
                                        "serve_prefill_chunk_s")}
    run = ServeRun(
        model=model, mix=mix,
        device_kind=torch.cuda.get_device_name(device) if cuda else "cpu",
        requests=[served[p.rid] for p in plan], setup_s=setup_s,
        decode_s=hist["serve_decode_step_s"].sum(),
        prefill_s=hist["serve_prefill_chunk_s"].sum(),
        decode_steps=hist["serve_decode_step_s"].count(),
        prefill_chunks=hist["serve_prefill_chunk_s"].count(),
        slots=int(mix["slots"]), window=window,
        profiler_stall_s=prof.stall_s if prof is not None else 0.0,
        trace_opened_at=prof.opened_at if prof is not None else None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del eng, deployed, reqs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return run, params, x_cal, peak


def run_cell(cell: spec.Cell, seed: int, seconds: float, *, trace: bool,
             device, t_start: float, control: bool = False
             ) -> Tuple[dict, Dict]:
    """(result line, checks) of one run of a serving cell."""
    run, params, x_cal, peak = serve_cell(
        cell.config["model"], cell.traffic, seed, seconds, trace=trace,
        device=device, t_start=t_start)
    checks, readings = serving_checks(run, params, x_cal, seed,
                                      control=control)
    metrics = spec.metric_values(cell.per_layer if trace
                                 else cell.end_to_end, run)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.device_kind, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    line = {"correct": passed(checks), "attempted": len(run.requests),
            "failed": int(checks["short_requests"]["value"]),
            "metrics": metrics, "device": dev}
    if trace and run.window is not None:
        dev["busy_s"] = busy_us(run.window.ops) / 1e6
        dev["window_s"] = run.window.seconds
        line["breakdown"] = breakdown(run.window)
    tokens = sum(len(r.tokens) for r in run.requests)
    line["info"] = {
        "requests": len(run.requests), "tokens": tokens,
        "rate_per_s": cell.traffic["rate_per_s"],
        "last_token_s": max((r.last for r in run.requests), default=0.0),
        "decode_steps": run.decode_steps,
        "prefill_chunks": run.prefill_chunks,
        "queue_wait_ms_by_third": thirds(run),
        **readings,
    }
    if trace:
        line["info"]["profiler_stall_s"] = run.profiler_stall_s
    line["checks"] = checks
    return line, checks


def thirds(run):
    """Mean queue wait (ms) of the first, middle and last third of the
    requests by arrival: a backlog that grows through the run shows as a
    rising row (the knee sweep reads it)."""
    waits = [(r.admit - r.arrival) * 1e3 for r in run.requests]
    n = len(waits)
    cut = [0, n // 3, 2 * n // 3, n]
    return [sum(waits[a:b]) / max(b - a, 1) for a, b in zip(cut, cut[1:])]
