"""Continuous-batching serving engine: a slotted KV pool and the request
scheduler that drives it (PyTorch port of `repro/launch/scheduler.py`).

The paper's chip stacks are weight-stationary — one compiled chip serves
every in-flight request — so request-level serving is a cache and
scheduling layer over the model's prefill and decode:

  * Slot pool (`init_pool`): the batch dimension of the arch's cache
    becomes a pool of request slots — dense KV caches and the recurrent
    archs' state alike (rwkv6's S / x_tm / x_cm, mamba2's h and zamba2's
    shared-block KV), since every cache tensor keeps the slot dim at
    axis 1. The free-slot bitmap (`active`),
    each slot's last token (`tok`) and per-slot fill (`len`, widened from
    the static path's int) are tensors of the pool. Admission, eviction
    and chunk prefill write into the pool's tensors IN PLACE, so their
    addresses never change and ONE decode step serves every occupancy
    pattern: on the card it is captured once as a CUDA graph and
    replayed every step after (`decode_traces()` counts the captures).
  * Admission / eviction: between decode steps the host assigns free
    slots to arrived requests (FIFO, lowest slot first, never
    double-assigned), zeroes the slot's state and chunk-prefills the
    prompt into it; a finished request flips its `active` bit off — the
    slot is reusable at once because admission resets it.
  * Chunked prefill interleaved with decode: prompts are split into
    `chunk`-sized pieces (default 32) and at most ONE chunk runs per
    engine iteration, so a long prompt never stalls in-flight decodes by
    more than one chunk (`steps.make_slot_prefill_step`).

Correctness: a request served through the pool returns the greedy tokens
of the same request served alone through the static path, with logits
within rounding: every per-row computation (the packed CIM projections
with static PACT alphas, norms, softmax) is independent of which other
slots are occupied. On the card attention's rows are too: its kernel
(`kernels/attention`) sums each row at fixed key splits in a fixed order,
so a row's bits do not depend on the batch, the live slots or where a
chunk boundary falls; on the CPU the plain path's batched float64
products may round in another order. For MoE archs the engine forces
dropless dispatch (`moe_dropless`, as the reference's engine does): with
capacity-factor dispatch co-batched requests would compete for expert
capacity, and a request's tokens would depend on its neighbours. The
recurrent archs' chunked scans (rwkv6 in chunks of 32, mamba2 in 64) see
the same chunks in the pool as in a one-shot prefill only where the
engine's chunk is a multiple of the scan's and the prompt fills whole scan
chunks; elsewhere the scan reassociates, within rounding. On a
tensor-parallel mesh (a 'data' width of 1) the pool lives on the params'
device and the chips' shards run where deploy placed them.

The striped slot pool (a mesh whose 'data' width D is above 1, the
reference's `pool_pspecs`): stripe r holds slots r * S/D .. (r + 1) * S/D
- 1 on data row r's first device (`init_pool(mesh=)`), served with row
r's copy of the chips (`models/nn.row_params`). The engine runs one
sub-pool per stripe, each with its own decode step, captured once on its
row's device (a CUDA graph cannot span devices): `obs/capturewatch`
counts one capture per stripe ('pool_decode/stripe<r>'). Admission takes
the lowest free slot of the whole pool, as the reference does, so slots
fill in the reference's order across the stripes; every decode step
runs every stripe, and tokens and logits are gathered in slot order.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.verify import verify_deployed
from ..device import resolve_device
from ..kernels.build import LAUNCHES
from ..models import transformer as T
from ..obs import JitWatcher, MetricsRegistry, TraceBuffer
from ..obs import trace as obs_trace
from ..obs.chipmeter import ChipMeter
from ..obs.clock import now as clock_now
from ..obs.clock import timed_call
from ..obs.trace import ENGINE_PID, REQUEST_PID, span
from .steps import (CapturedStep, make_decode_step, make_pool_decode_step,
                    make_prefill_step, make_slot_prefill_step)


def _pool_on(cfg, n_slots: int, max_len: int, dev):
    pool = dict(T.init_cache(cfg, n_slots, max_len, dtype=cfg.dtype,
                             device=dev))
    pool["len"] = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
    pool["active"] = torch.zeros((n_slots,), dtype=torch.bool, device=dev)
    pool["tok"] = torch.zeros((n_slots, 1), dtype=torch.int32, device=dev)
    return pool


def init_pool(cfg, n_slots: int, max_len: int, mesh=None, device=None):
    """Slot pool on `device` (CUDA unless "cpu" is passed): the arch's
    cache with `len` widened to a per-slot (n_slots,) int32 tensor, plus
    the `active` bitmap and the per-slot last token. On a mesh whose
    'data' width D is above 1 the pool is striped (`pool_pspecs`): every
    leaf a `distributed/sharding.Sharded` whose stripe r, the slots r *
    n_slots / D .. (r + 1) * n_slots / D - 1, lies on data row r's first
    device (n_slots must divide by D); at D = 1 a mesh changes nothing."""
    if mesh is not None:
        from .mesh import check_serving_mesh
        check_serving_mesh(mesh)
    if mesh is None or mesh.shape["data"] == 1:
        return _pool_on(cfg, n_slots, max_len, resolve_device(device))
    from ..distributed.sharding import Sharded, pool_pspecs
    n_rows = mesh.shape["data"]
    if n_slots % n_rows:
        raise ValueError(f"{n_slots} slots do not stripe over {n_rows} data "
                         "rows")
    stripes = [_pool_on(cfg, n_slots // n_rows, max_len, row.devices[0][0])
               for row in mesh.rows(("data",))]
    specs = pool_pspecs(stripes[0])
    out = {}
    for k, spec in specs.items():
        axis = 0 if k in ("len", "active", "tok") else 1
        shape = list(stripes[0][k].shape)
        shape[axis] *= n_rows
        out[k] = Sharded([st[k] for st in stripes], spec, mesh, shape)
    return out


def _reset_slot(pool, slot: int):
    """Zero one slot's sequence state (axis 1 of every cache tensor: KV or
    recurrent state) and bookkeeping in place (admission reset)."""
    for k, a in pool.items():
        if k in ("len", "active", "tok"):
            a[slot] = 0
        else:
            a[:, slot] = 0
    return pool


def _set_active(pool, slot: int, flag: bool):
    pool["active"][slot] = flag
    return pool


@dataclasses.dataclass
class Request:
    """One serving request. `arrival` is seconds relative to run start
    (open-loop traffic); results are filled in by the engine."""
    rid: int
    prompt: np.ndarray                   # (L,) int
    max_new: int
    arrival: float = 0.0
    # results
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_lat: List[float] = dataclasses.field(default_factory=list)
    t_first: float = -1.0                # arrival -> first token (TTFT)
    t_done: float = -1.0
    t_admit: float = -1.0                # seconds into the run at admission
    energy_pj: float = 0.0               # attributed modeled chip energy
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Stripe:
    """One stripe of the pool: its slots' sub-pool, the params it serves
    with (its data row's chips), its device and its decode step."""
    params: dict
    pool: dict
    device: torch.device
    decode: Any = None


@dataclasses.dataclass
class _PrefillJob:
    slot: int
    req: Request
    chunks: List[np.ndarray]
    next: int = 0


class ContinuousBatchingEngine:
    """Request-level continuous batching over one compiled chip stack, on
    the device the params lie on.

    One decode step serves every occupancy pattern (on the card, one
    captured CUDA graph); admission, eviction and chunked prefill are
    in-place updates of the pool. `capture_logits=True` records each
    request's per-token logits rows (numpy).
    """

    def __init__(self, cfg, params, n_slots: int, max_len: int, *,
                 chunk: int = 32, mesh=None, capture_logits: bool = False,
                 metrics: Optional[MetricsRegistry] = None,
                 trace: Optional[TraceBuffer] = None,
                 strict_jit: bool = False):
        if cfg.n_experts > 0 and not cfg.moe_dropless:
            # the engine's contract: co-batched requests must not compete
            # for expert capacity (module docstring)
            cfg = cfg.replace(moe_dropless=True)
        self.cfg = cfg
        # last gate before the steps close over the chip stacks: a corrupt
        # packed artifact fails here with a named invariant
        self.params = verify_deployed(params)
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.chunk = chunk
        self.capture_logits = capture_logits
        self.pool = init_pool(cfg, n_slots, max_len, mesh=mesh,
                              device=self.device)
        n_rows = 1 if mesh is None else mesh.shape["data"]
        if n_rows == 1:
            self.stripes = [_Stripe(self.params, self.pool, self.device)]
        else:
            from ..models.nn import row_params
            self.stripes = [_Stripe(
                row_params(self.params, r),
                {k: v.shards[r] for k, v in self.pool.items()},
                self.pool["len"].shards[r].device) for r in range(n_rows)]
        self._per_stripe = n_slots // n_rows
        # Every step goes through the watchdog: compilations become a
        # metric on every run and, under strict_jit, a hard assertion. On
        # the card the decode step is captured once and replayed
        # (`CapturedStep`, which adds its launches to the kernels' counters
        # once per replay). The kernels' plain versions (cim_impl="plain",
        # the on-card comparison) read their tables on the host, which a
        # capture forbids: they run eagerly.
        self.jitwatch = JitWatcher(strict=strict_jit)
        self._step = make_pool_decode_step(cfg)
        for r, st in enumerate(self.stripes):
            captured = st.device.type == "cuda" and cfg.cim_impl != "plain"
            st.decode = self.jitwatch.wrap(
                "pool_decode" if n_rows == 1 else f"pool_decode/stripe{r}",
                CapturedStep(self._step, LAUNCHES) if captured
                else self._step, max_traces=1)
        self._prefill = self.jitwatch.wrap("slot_prefill",
                                           make_slot_prefill_step(cfg))
        self._reset = self.jitwatch.wrap("slot_reset", _reset_slot,
                                         max_traces=1)
        self._activate = self.jitwatch.wrap(
            "slot_activate", _set_active, max_traces=2,  # static flag arg
            static_argnums=(2,))
        self._free = list(range(n_slots))      # host mirror of ~active
        self._live: Dict[int, Request] = {}    # slot -> decoding request
        self._jobs: deque = deque()            # chunked prefills in flight
        self._rows_useful = 0                  # token rows that reached a req
        self._rows_dispatched = 0              # rows pushed through the chips
        # Telemetry is always collected into a private registry unless the
        # caller supplies a shared one; the trace buffer is opt-in. Host
        # spans (`obs/trace`) go to that buffer, or to the process buffer
        # while a torch.profiler session records (`_spans`).
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.trace = trace
        self.chipmeter = ChipMeter.from_params(
            params, cfg.cim_in_bits, cfg.cim_out_bits)
        m = self.metrics
        self._m_admitted = m.counter(
            "serve_requests_admitted", "requests admitted to a slot")
        self._m_finished = m.counter(
            "serve_requests_finished", "requests fully served")
        self._m_chunks = m.counter(
            "serve_prefill_chunks", "prefill chunk dispatches")
        self._m_steps = m.counter(
            "serve_decode_steps", "pool decode step dispatches")
        self._m_tok_gen = m.counter(
            "serve_tokens_generated", "tokens emitted to requests")
        self._m_tok_pre = m.counter(
            "serve_tokens_prefilled", "prompt tokens prefilled")
        self._g_occ = m.gauge(
            "serve_slots_occupied", "live decoding slots (of n_slots)")
        self._g_queue = m.gauge(
            "serve_queue_depth", "requests waiting: arrived, no slot yet")
        self._h_decode = m.histogram(
            "serve_decode_step_s", "pool decode step wall seconds")
        self._h_chunk = m.histogram(
            "serve_prefill_chunk_s", "prefill chunk wall seconds")
        self._h_ttft = m.histogram(
            "serve_ttft_s", "arrival to first token, seconds")
        self._h_req = m.histogram(
            "serve_request_s", "arrival to last token, seconds")
        self._h_tok = m.histogram(
            "serve_token_lat_s", "per-token step latency, seconds")

    # ------------------------------------------------------------- plumbing

    def decode_traces(self) -> int:
        """Compilations of the pool decode step (contract: 1), the most of
        any stripe's: on the card its CUDA-graph captures, elsewhere its
        input signatures."""
        return max(st.decode.traces for st in self.stripes)

    def stripe_traces(self) -> List[int]:
        """Each stripe's decode compilations (one per stripe)."""
        return [st.decode.traces for st in self.stripes]

    def _spans(self):
        """Makes this call's span buffer active (`obs/trace.engine_buffer`):
        the handed trace buffer, else the process buffer while a profiler
        records, else none (spans off)."""
        return obs_trace.activate(obs_trace.engine_buffer(self.trace))

    def _where(self, slot: int):
        """(stripe, slot within it) of a pool slot."""
        st = self.stripes[slot // self._per_stripe]
        return st, slot % self._per_stripe

    def _decode_all(self):
        """Every stripe's decode step, in stripe order."""
        return [st.decode(st.params, st.pool) for st in self.stripes]

    def _chunks(self, prompt: np.ndarray) -> List[np.ndarray]:
        c = self.chunk
        return [prompt[i:i + c] for i in range(0, len(prompt), c)]

    def _tokens(self, chunk, device) -> torch.Tensor:
        return torch.from_numpy(np.array(chunk, np.int64)[None]).to(device)

    def warmup(self, chunk_lens) -> None:
        """Run each distinct prefill-chunk length on slot 0 of the idle
        pool (resetting it after each), both activate flags, the reset,
        and the decode step (on the card its capture). Keeps first-use
        work out of every reported latency."""
        for st in self.stripes:
            for n in sorted(set(chunk_lens)):
                self._prefill(st.params, st.pool,
                              self._tokens(np.zeros(int(n)), st.device), 0)
                self._reset(st.pool, 0)
            # both static variants of the activate flag, so a sealed
            # watcher sees no fresh compilation on the first real admit /
            # evict
            self._activate(st.pool, 0, True)
            self._activate(st.pool, 0, False)
            self._reset(st.pool, 0)
            st.decode(st.params, st.pool)
            if st.device.type == "cuda":
                torch.cuda.synchronize(st.device)

    # ------------------------------------------------------------ scheduling

    def _admit(self, req: Request) -> None:
        assert len(req.prompt) + req.max_new <= self.max_len, \
            f"request {req.rid} would overflow the slot (max_len)"
        with self._spans(), span("serve.admit", rid=req.rid):
            slot = self._free.pop(0)
            assert slot not in self._live, "slot double-assign"
            st, local = self._where(slot)
            self._reset(st.pool, local)
            self._jobs.append(_PrefillJob(slot, req,
                                          self._chunks(req.prompt)))
            self._m_admitted.inc()

    def _request_done(self, req: Request, slot: int) -> None:
        """Telemetry at a request's last token: latency histograms, its
        attributed chip energy (useful rows x per-token stack cost — the
        first generated token rides the final prefill chunk, so decode
        rows are len(tokens) - 1), and its trace span."""
        self._m_finished.inc()
        self._h_req.observe(req.t_done - req.arrival)
        rows = len(req.prompt) + max(len(req.tokens) - 1, 0)
        req.energy_pj = rows * self.chipmeter.per_token_pj()
        if self.trace is not None:
            t_admit = req.t_admit if req.t_admit >= 0 else req.arrival
            start = min(req.arrival, t_admit)
            self.trace.name_thread(REQUEST_PID, req.rid, f"req {req.rid}")
            self.trace.complete(
                "request", start, req.t_done - start,
                pid=REQUEST_PID, tid=req.rid,
                args={"rid": req.rid, "slot": slot,
                      "prompt_len": len(req.prompt),
                      "tokens": len(req.tokens),
                      "ttft_s": req.t_first,
                      "energy_pj": req.energy_pj})

    def _finish(self, slot: int, now: float) -> None:
        req = self._live.pop(slot)
        req.t_done = now
        st, local = self._where(slot)
        self._activate(st.pool, local, False)
        self._free.append(slot)
        self._free.sort()
        self._request_done(req, slot)

    def _prefill_one_chunk(self, now: float) -> float:
        """Run ONE chunk of the oldest in-flight prefill; returns step
        seconds. On the final chunk the slot goes live (its first token was
        seeded into pool['tok'] by the chunk step)."""
        t_host = clock_now()
        job = self._jobs[0]
        chunk = job.chunks[job.next]
        n_rows = len(chunk)
        with self._spans() as buf, span(
                "serve.prefill", rid=job.req.rid, slot=job.slot,
                rows=n_rows) as sp:
            st, local = self._where(job.slot)
            (logits, _), dt = timed_call(
                self._prefill, st.params, st.pool,
                self._tokens(chunk, st.device), local, device=st.device,
                spans=("serve.prefill.enqueue", "serve.prefill.wait"))
            sp.set(device_s=dt)
            with span("serve.prefill.sample"):
                if buf is not None:
                    buf.resolve()
                self._chunk_done(job, st, local, n_rows, logits, now, dt,
                                 clock_now() - t_host)
        return dt

    def _chunk_done(self, job: _PrefillJob, st, local: int, n_rows: int,
                    logits, now: float, dt: float, host_s: float) -> None:
        """After a chunk's step: its telemetry and, on the final chunk, the
        first token and the slot's activation (or, at max_new = 1, its
        eviction)."""
        job.next += 1
        self._m_chunks.inc()
        self._m_tok_pre.inc(n_rows)
        self._h_chunk.observe(dt)
        self.chipmeter.count_rows(n_rows)
        self._rows_useful += n_rows
        self._rows_dispatched += n_rows
        if self.trace is not None:
            args = {"slot": job.slot, "rid": job.req.rid, "rows": n_rows,
                    "chunk": job.next, "of": len(job.chunks),
                    "device_s": dt}
            self.trace.complete("prefill_chunk", now, host_s, args=args)
            self.trace.complete("prefill_chunk", now, host_s,
                                pid=REQUEST_PID, tid=job.req.rid, args=args)
        if job.next < len(job.chunks):
            return
        self._jobs.popleft()
        req = job.req
        row = logits[0].cpu().numpy()
        req.tokens.append(int(np.argmax(row)))
        req.token_lat.append(dt)
        self._m_tok_gen.inc()
        self._h_tok.observe(dt)
        req.t_first = now + dt - req.arrival
        self._h_ttft.observe(req.t_first)
        if self.capture_logits:
            req.logits.append(row)
        if req.max_new == 1:
            req.t_done = now + dt
            self._reset(st.pool, local)
            self._free.append(job.slot)
            self._free.sort()
            self._request_done(req, job.slot)
        else:
            self._activate(st.pool, local, True)
            self._live[job.slot] = req

    def _decode_once(self, now: float) -> float:
        t_host = clock_now()
        n_live = len(self._live)
        with self._spans() as buf, span("serve.decode", live=n_live) as sp:
            outs, dt = timed_call(
                self._decode_all, device=[st.device for st in self.stripes],
                spans=("serve.decode.call", "serve.decode.wait"))
            sp.set(device_s=dt)
            with span("serve.decode.emit"):
                if buf is not None:
                    buf.resolve()
                done = self._emit(outs, now, dt, n_live,
                                  clock_now() - t_host)
            with span("serve.decode.evict"):
                for slot in done:
                    self._finish(slot, now + dt)
        return dt

    def _emit(self, outs, now: float, dt: float, n_live: int,
              host_s: float) -> List[int]:
        """After a decode step: its telemetry, and each live request's new
        token (copied out of the pool); returns the slots whose requests
        are done."""
        # Honest hardware accounting: the weight-stationary pool step
        # pushes ALL n_slots rows through every chip regardless of
        # occupancy — empty slots still cost energy. The useful/dispatched
        # ratio surfaces as the run's `utilization`.
        self._m_steps.inc()
        self._m_tok_gen.inc(n_live)
        self._h_decode.observe(dt)
        self.chipmeter.count_rows(self.n_slots)
        self._rows_useful += n_live
        self._rows_dispatched += self.n_slots
        if self.trace is not None:
            self.trace.complete("decode_step", now, host_s,
                                args={"live": n_live, "device_s": dt})
        toks = torch.cat([st.pool["tok"][:, 0].cpu()
                          for st in self.stripes]).numpy()
        # the decode's logits are the graph's output tensor on the card,
        # overwritten by the next replay: copied out now, in slot order
        rows = torch.cat([lg.cpu() for lg, _ in outs]).numpy() \
            if self.capture_logits else None
        done = []
        for slot, req in self._live.items():
            req.tokens.append(int(toks[slot]))
            req.token_lat.append(dt)
            self._h_tok.observe(dt)
            if self.capture_logits:
                req.logits.append(rows[slot])
            if self.trace is not None:
                self.trace.complete("decode", now, host_s, pid=REQUEST_PID,
                                    tid=req.rid,
                                    args={"slot": slot, "device_s": dt})
            if len(req.tokens) >= req.max_new:
                done.append(slot)
        return done

    # -------------------------------------------------------------- serving

    def run(self, requests: List[Request], *,
            realtime: bool = True) -> Dict[str, Any]:
        """Open-loop serve: requests arrive at their `arrival` offsets
        whether or not the engine keeps up. Returns summary stats; per-token
        detail lands on each Request. With realtime=False arrival times are
        ignored (everything is admitted as soon as a slot frees up) — used
        by tests for deterministic scheduling."""
        self.warmup({c.shape[0] for r in requests
                     for c in self._chunks(r.prompt)})
        # warmup compiled every shape this run can produce — from here on,
        # any compilation on any entry point is a contract violation
        self.jitwatch.seal()
        if self.trace is not None:
            self.trace.name_process(ENGINE_PID, "engine")
            self.trace.name_process(REQUEST_PID, "requests")
        pending = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        t0 = clock_now()
        if self.trace is not None:
            self.trace.anchor(t0)
        occ_last = (-1, -1, -1)
        while pending or self._jobs or self._live:
            now = clock_now() - t0
            while pending and self._free and \
                    (not realtime or pending[0].arrival <= now):
                pending[0].t_admit = now
                self._admit(pending.popleft())
            arrived = sum(r.arrival <= now for r in pending) \
                if realtime else len(pending)
            self._g_occ.set(len(self._live))
            self._g_queue.set(arrived + len(self._jobs))
            occ = (len(self._live), len(self._jobs), arrived)
            if self.trace is not None and occ != occ_last:
                occ_last = occ
                self.trace.counter("occupancy", now, {
                    "live_slots": occ[0], "prefilling": occ[1],
                    "queued": occ[2]})
            busy = False
            # each step re-reads the clock: prefill and decode run one
            # after the other within an iteration, and a span starts when
            # its step began
            if self._jobs:
                self._prefill_one_chunk(clock_now() - t0)
                busy = True
            if self._live:
                self._decode_once(clock_now() - t0)
                busy = True
            if not busy:
                # idle: nothing in flight, next request not yet arrived
                if pending and realtime:
                    wait = pending[0].arrival - (clock_now() - t0)
                    if wait > 0:
                        with self._spans(), span("serve.idle"):
                            time.sleep(min(wait, 0.05))
        wall = clock_now() - t0
        self._g_occ.set(0)
        self._g_queue.set(0)
        self.chipmeter.export(self.metrics)
        self.jitwatch.export(self.metrics)
        lats = np.asarray([dt for r in requests for dt in r.token_lat])
        total = sum(len(r.tokens) for r in requests)
        energy_pj = self.chipmeter.energy_pj()
        return {
            "requests": len(requests),
            "tokens": total,
            "wall_s": wall,
            "tok_per_s": total / wall if wall > 0 else 0.0,
            "p50_ms": float(np.percentile(lats, 50) * 1e3) if total else 0.0,
            "p99_ms": float(np.percentile(lats, 99) * 1e3) if total else 0.0,
            "ttft_p50_ms": float(np.percentile(
                [r.t_first for r in requests], 50) * 1e3) if requests else 0.0,
            "decode_traces": self.decode_traces(),
            "mvm_dispatches": self.chipmeter.mvm_dispatches(),
            "energy_pj": energy_pj,
            "pj_per_token": energy_pj / total if total else 0.0,
            "tops_per_w": self.chipmeter.tops_per_w(),
            "utilization": (self._rows_useful / self._rows_dispatched
                            if self._rows_dispatched else 0.0),
        }


def serve_static(cfg, params, requests: List[Request], batch: int,
                 max_len: int, *, capture_logits: bool = False,
                 realtime: bool = True,
                 metrics: Optional[MetricsRegistry] = None) -> Dict[str, Any]:
    """The static-batch baseline at equal request load: requests are taken
    in arrival order, grouped into fixed batches of `batch`, prompts
    left-padded to the group max, prefilled once, then decoded in lockstep
    until every member hits its max_new (the static serve path), on the
    device the params lie on.

    Metered with the same ChipMeter model as the engine, under static-path
    rules: prefill dispatches group_size x padded_len rows (left-padding is
    real dispatched work on a weight-stationary chip), decode dispatches
    group_size rows per lockstep step even for members already done — the
    padding + lockstep waste is what `utilization` exposes against the
    continuous engine's number."""
    dev = params["embed"].device
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    meter = ChipMeter.from_params(params, cfg.cim_in_bits, cfg.cim_out_bits)
    m = metrics if metrics is not None else MetricsRegistry()
    h_pre = m.histogram("static_prefill_s", "static batch prefill seconds")
    h_dec = m.histogram("static_decode_step_s", "static decode step seconds")
    c_tok = m.counter("static_tokens", "tokens emitted by the static path")
    rows_useful = 0
    rows_dispatched = 0
    reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
    groups = [reqs[i:i + batch] for i in range(0, len(reqs), batch)]

    def cache(gb):
        return T.init_cache(cfg, gb, max_len, dtype=cfg.dtype, device=dev)

    # warmup: each distinct (group size, padded prompt len) prefill and the
    # decode step run once before the clock starts, as the engine's warmup
    for gb, lp in sorted({(len(g), max(len(r.prompt) for r in g))
                          for g in groups}):
        c = cache(gb)
        toks = torch.zeros((gb, lp), dtype=torch.long, device=dev)
        logits, c = prefill(params, c, {"tokens": toks})
        decode(params, c, {"tokens": torch.argmax(logits, -1)[:, None]})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = clock_now()
    for group in groups:
        if realtime:  # the whole batch must have arrived before it forms
            wait = max(r.arrival for r in group) - (clock_now() - t0)
            if wait > 0:
                time.sleep(wait)
        lp = max(len(r.prompt) for r in group)
        prompts = np.zeros((len(group), lp), np.int64)
        for j, r in enumerate(group):
            prompts[j, lp - len(r.prompt):] = r.prompt  # left-pad
        (logits, c), dt = timed_call(
            prefill, params, cache(len(group)),
            {"tokens": torch.as_tensor(prompts).to(dev)}, device=dev)
        h_pre.observe(dt)
        meter.count_rows(len(group) * lp)
        rows_useful += sum(len(r.prompt) for r in group)
        rows_dispatched += len(group) * lp
        tok = torch.argmax(logits, -1)[:, None]
        now = clock_now() - t0
        toks, rows = tok[:, 0].tolist(), logits.cpu().numpy()
        for j, r in enumerate(group):
            r.tokens.append(toks[j])
            r.token_lat.append(dt)
            r.t_first = now - r.arrival
            c_tok.inc()
            if capture_logits:
                r.logits.append(rows[j])
        gen_max = max(r.max_new for r in group)
        for _ in range(gen_max - 1):
            (logits, c), dt = timed_call(decode, params, c,
                                         {"tokens": tok}, device=dev)
            h_dec.observe(dt)
            meter.count_rows(len(group))
            rows_dispatched += len(group)
            tok = torch.argmax(logits, -1)[:, None]
            toks, rows = tok[:, 0].tolist(), logits.cpu().numpy()
            for j, r in enumerate(group):
                if len(r.tokens) < r.max_new:  # lockstep: extras discarded
                    r.tokens.append(toks[j])
                    r.token_lat.append(dt)
                    rows_useful += 1
                    c_tok.inc()
                    if capture_logits:
                        r.logits.append(rows[j])
        for r in group:
            r.t_done = clock_now() - t0
    wall = clock_now() - t0
    lats = np.asarray([dt for r in reqs for dt in r.token_lat])
    total = sum(len(r.tokens) for r in reqs)
    energy_pj = meter.energy_pj()
    return {
        "requests": len(reqs),
        "tokens": total,
        "wall_s": wall,
        "tok_per_s": total / wall if wall > 0 else 0.0,
        "p50_ms": float(np.percentile(lats, 50) * 1e3) if total else 0.0,
        "p99_ms": float(np.percentile(lats, 99) * 1e3) if total else 0.0,
        "mvm_dispatches": meter.mvm_dispatches(),
        "energy_pj": energy_pj,
        "pj_per_token": energy_pj / total if total else 0.0,
        "utilization": (rows_useful / rows_dispatched
                        if rows_dispatched else 0.0),
    }
