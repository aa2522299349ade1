"""Port parity, serving telemetry (`repro_torch/obs`, `core/energy.py`):
the port's registry, trace buffer, energy model, chip meter and
compilation watchdog against the reference's (`repro/obs`,
`repro/core/energy.py`) under the same sequence of calls.

The registry, trace buffer and energy model are plain Python in both
packages: their exports must be EQUAL (JSON documents, Prometheus text,
floats). The chip meters are built from each package's own deployment of
the same smoke gemma2-9b params (the reference's stacked pytree, the
port's per-layer lists) and must agree entry for entry and in every
energy figure; the meter's energy is an exact product of integer counts.

The port's host spans (`obs/trace.span`, no reference counterpart): a
smoke MoE engine served under a CPU torch.profiler session records the
span tree into the process buffer, on the profiler's Unix clock, with
the routed rows per expert; nothing is recorded without a profiler or a
handed buffer; the profiler's own events hold no span; tokens are bitwise
the same with spans on and off.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energy as jenergy
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import TraceBuffer as JTrace
from repro.obs import dict_to_prometheus as j_dict_to_prometheus
from repro.obs import merge_registries as j_merge
from repro.obs.chipmeter import ChipMeter as JMeter
from repro.obs.jitwatch import JitWatcher as JJitWatcher
from repro_torch.core import energy as tenergy
from repro_torch.obs import (JitWatcher, MetricsRegistry, TraceBuffer,
                             dict_to_prometheus, merge_registries)
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.chipmeter import ChipMeter


def _drive_registry(r):
    """One sequence of registry calls, applied to either package."""
    c = r.counter("reqs", "requests")
    c.inc()
    c.inc(2.5, arch="a")
    g = r.gauge("occ", "occupancy")
    g.set(3, slot="0")
    g.set(1, slot="0")
    g.set(7, slot="1")
    h = r.histogram("lat_s", "latency")
    for v in (0.0, 3e-7, 1e-6, 2.5e-3, 0.04, 0.04, 1.0, 500.0):
        h.observe(v)
    h.observe(0.1, phase="decode")
    hb = r.histogram("custom", "custom buckets", buckets=[0.5, 1.0, 2.0])
    for v in (0.1, 0.5, 0.7, 3.0):
        hb.observe(v)
    r.histogram("empty", "no observations")
    return r


def test_registry_exports_equal_reference():
    mine, ref = _drive_registry(MetricsRegistry()), _drive_registry(
        JRegistry())
    assert mine.to_dict() == ref.to_dict()
    assert mine.to_json() == ref.to_json()
    assert mine.to_prometheus() == ref.to_prometheus()
    extra = {"rank": "3"}
    assert mine.to_dict(extra) == ref.to_dict(extra)
    assert mine.to_prometheus(extra) == ref.to_prometheus(extra)
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert mine.get("lat_s").quantile(q) == ref.get("lat_s").quantile(q)
    assert mine.value("occ", slot="1") == ref.value("occ", slot="1") == 7.0


def test_registry_errors_match_reference():
    for r in (MetricsRegistry(), JRegistry()):
        r.counter("x")
        with pytest.raises(ValueError, match="already registered"):
            r.gauge("x")
        with pytest.raises(ValueError, match="cannot decrease"):
            r.counter("x").inc(-1)
        with pytest.raises(ValueError, match="strictly increasing"):
            r.histogram("h", buckets=[1.0, 0.5])
        with pytest.raises(ValueError, match="collide"):
            r.counter("y").inc(1, rank="0")
            r.to_dict({"rank": "1"})


def test_merge_and_render_equal_reference():
    docs = [_drive_registry(MetricsRegistry()).to_dict({"rank": str(i)})
            for i in range(2)]
    merged = merge_registries(docs)
    assert merged == j_merge(docs)
    assert dict_to_prometheus(merged) == j_dict_to_prometheus(merged)
    with pytest.raises(ValueError, match="duplicate series"):
        merge_registries([docs[0], docs[0]])


def _drive_trace(t):
    t.name_process(1, "engine")
    t.name_process(1, "engine")                # named once
    t.name_thread(2, 7, "req 7")
    t.complete("decode_step", 0.125, 0.003, args={"live": 2})
    t.complete("request", 0.0, 1.5, pid=2, tid=7, args={"rid": 7})
    t.instant("admit", 0.01, tid=3, args={"slot": 1})
    t.counter("occupancy", 0.2, {"live_slots": 2, "queued": 0})
    return t


def test_trace_json_equals_reference():
    mine, ref = _drive_trace(TraceBuffer()), _drive_trace(JTrace())
    assert mine.to_json() == ref.to_json()
    assert mine.to_dict() == ref.to_dict()


@pytest.mark.parametrize("in_bits", range(1, 9))
def test_mvm_cost_equals_reference(in_bits):
    """Every field of the cost model, exactly, over rows, columns, output
    bits and both nodes."""
    for rows in (1, 35, 128, 255, 256, 257, 1024, 3584):
        for cols in (1, 47, 256, 300, 14336):
            for out_bits in (1, 2, 4, 8):
                for node in ("130nm", "7nm"):
                    a = tenergy.mvm_cost(rows, cols, in_bits, out_bits,
                                         node=node)
                    b = jenergy.mvm_cost(rows, cols, in_bits, out_bits,
                                         node=node)
                    assert (a.energy_pj, a.latency_ns, a.macs, a.ops,
                            a.tops_per_w, a.edp) == \
                        (b.energy_pj, b.latency_ns, b.macs, b.ops,
                         b.tops_per_w, b.edp)


def test_edp_and_stages_equal_reference():
    from repro.core.types import EnergyConfig as JEnergyConfig
    from repro_torch.core.types import EnergyConfig
    assert dataclass_dict(EnergyConfig()) == dataclass_dict(JEnergyConfig())
    for i, o in ((1, 1), (2, 8), (4, 8), (8, 8)):
        mine = tenergy.neurram_edp(i, o)
        ref = jenergy.neurram_edp(i, o)
        assert mine[0] == ref[0]
        assert tenergy.input_stage(i, 200, EnergyConfig()) == \
            jenergy.input_stage(i, 200, JEnergyConfig())
        assert tenergy.output_stage(o, 100, EnergyConfig()) == \
            jenergy.output_stage(o, 100, JEnergyConfig())
    assert tenergy.PRIOR_ART_EDP == jenergy.PRIOR_ART_EDP


def dataclass_dict(obj):
    import dataclasses
    return dataclasses.asdict(obj)


@pytest.fixture(scope="module")
def meters():
    """Each package's chip meter on its own deployment of the same smoke
    gemma2-9b params, counted through the same rows."""
    from repro import configs as jconfigs
    from repro.launch.steps import arch_serving
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import serve as tserve
    cfg = jconfigs.get("gemma2-9b", smoke=True).replace(
        dtype=jnp.float32, cim_mode="packed", cim_mesh=None)
    sv = arch_serving(cfg)
    params = sv.init_params(jax.random.PRNGKey(0))
    deployed = sv.deploy_cim(jax.random.PRNGKey(7), params, mode="ideal",
                             mesh_shape={"model": 1})
    tcfg, tparams, _ = tserve.deploy(
        "gemma2-9b", smoke=True, cim=True, device="cpu",
        params=params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        params)))
    ref = JMeter.from_params(deployed, cfg.cim_in_bits, cfg.cim_out_bits)
    mine = ChipMeter.from_params(tparams, tcfg.cim_in_bits,
                                 tcfg.cim_out_bits)
    for m in (ref, mine):
        for n in (64, 4, 4, 32, 16, 4):
            m.count_rows(n)
        m.count_chip("layers/wq", 3)
    return mine, ref


def _entry(e):
    return (e.name, e.direction, e.rows, e.cols, e.n_stack, e.partition,
            e.in_bits, e.out_bits)


def test_chipmeter_entries_equal_reference(meters):
    mine, ref = meters
    assert sorted(mine.entries) == sorted(ref.entries)
    assert len(mine.entries) == 7
    for key in ref.entries:
        assert _entry(mine.entries[key]) == _entry(ref.entries[key]), key
    assert {e.n_stack for e in mine.entries.values()} == {2}


@pytest.mark.parametrize("query", ["mvm_dispatches", "energy_pj",
                                   "per_token_pj", "tops_per_w", "report"])
def test_chipmeter_numbers_equal_reference(meters, query):
    mine, ref = meters
    assert getattr(mine, query)() == getattr(ref, query)()
    if query in ("mvm_dispatches", "energy_pj", "tops_per_w"):
        assert getattr(mine, query)("layers/wq") == \
            getattr(ref, query)("layers/wq")


def test_chipmeter_export_equals_reference(meters):
    mine, ref = meters
    rm, rr = MetricsRegistry(), JRegistry()
    mine.export(rm)
    ref.export(rr)
    mine.export(rm)                            # idempotent at a boundary
    assert rm.to_dict() == rr.to_dict()


def test_chipmeter_energy_identity_is_exact(meters):
    """energy_pj == mvm_cost(rows, cols, bits).energy_pj * mvm_dispatches
    for every entry, exactly, in the meter and in its exported series."""
    mine, _ = meters
    r = MetricsRegistry()
    mine.export(r)
    total = 0.0
    for (name, d), e in sorted(mine.entries.items()):
        n = mine.mvm_dispatches(name, d)
        want = tenergy.mvm_cost(e.rows, e.cols, e.in_bits,
                                e.out_bits).energy_pj * n
        lab = {"chip": name, "direction": d}
        assert mine.energy_pj(name, d) == want
        assert r.value("chip_energy_pj", **lab) == want
        assert r.value("chip_mvm_dispatches", **lab) == n
        assert r.value("chip_pj_per_mvm", **lab) * n == want
        total += want
    assert mine.energy_pj() == total


def test_chipmeter_from_chip_matches_reference():
    """A bidirectional chip's fwd and bwd entries, both packages."""
    from repro.core import cim as jcim
    from repro.core.types import CIMConfig as JConfig
    from repro_torch.core import cim as tcim
    from repro_torch.core.types import CIMConfig
    w = np.random.default_rng(0).standard_normal((300, 70)).astype(
        np.float32)
    ref = jcim.compile_chip(jax.random.PRNGKey(1), {"rbm": jnp.asarray(w)},
                            JConfig(in_bits=2), mode="ideal",
                            directions=("fwd", "bwd"))
    mine = tcim.compile_chip({"rbm": torch.from_numpy(w)},
                             CIMConfig(in_bits=2), mode="ideal",
                             directions=("fwd", "bwd"),
                             generator=torch.Generator().manual_seed(1))
    a, b = ChipMeter.from_chip(mine, "rbm"), JMeter.from_chip(ref, "rbm")
    assert {k: _entry(e) for k, e in a.entries.items()} == \
        {k: _entry(e) for k, e in b.entries.items()}
    for m in (a, b):
        m.count_rows(64, "fwd")
        m.count_rows(64, "bwd")
    assert a.report() == b.report()


def test_watcher_ledger_and_metric_names_equal_reference():
    """The same calls (two shapes, then a repeat) give the reference's
    ledger and series; only the compile seconds differ."""
    mine, ref = JitWatcher(), JJitWatcher()
    f = mine.wrap("pool_decode", lambda x: x + 1, max_traces=1)
    g = ref.wrap("pool_decode", lambda x: x + 1, max_traces=1)
    for shape in ((2,), (3,), (2,)):
        f(torch.zeros(shape))
        g(jnp.zeros(shape))
    strip = lambda rep: {k: {kk: vv for kk, vv in v.items()
                             if kk != "compile_s"} for k, v in rep.items()}
    assert strip(mine.report()) == strip(ref.report())
    rm, rr = MetricsRegistry(), JRegistry()
    mine.export(rm)
    ref.export(rr)
    dm, dr = rm.to_dict(), rr.to_dict()
    for kind in ("counters", "gauges"):
        keep = lambda doc: [e for e in doc[kind]
                            if e["name"] != "jit_compile_s"]
        assert keep(dm) == keep(dr), kind
    assert json.loads(rm.to_json()).keys() == json.loads(rr.to_json()).keys()


# ------------------------------------------------------------ host spans

SPAN_LENS, SPAN_GENS = [20, 12, 9], [3, 4, 1]


def _span_engine(**kw):
    """A float smoke deepseek engine (2 MoE layers, 8 experts, top-2) and
    its three requests (chunks of 8 rows; one request of a single
    token)."""
    from repro_torch.launch import scheduler as S
    from repro_torch.launch import serve as tserve
    from repro_torch.models import transformer as tT
    cfg = tserve.serving_config("deepseek-moe-16b", smoke=True)
    params = tT.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [S.Request(rid=i, prompt=rng.integers(0, cfg.vocab, (n,))
                      .astype(np.int32), max_new=g)
            for i, (n, g) in enumerate(zip(SPAN_LENS, SPAN_GENS))]
    eng = S.ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=32,
                                     chunk=8, capture_logits=True, **kw)
    return eng, reqs


def _x_spans(buf):
    return sorted((e for e in buf.events
                   if e["ph"] == "X" and e.get("cat") == "span"),
                  key=lambda e: (e["ts"], -e["dur"]))


def _within(events, parent):
    end = parent["ts"] + parent["dur"]
    return [e for e in events if e is not parent
            and parent["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end]


@pytest.fixture(scope="module")
def profiled_run():
    """The engine served once under a CPU profiler session, the prefill
    calls wrapped in a record_function range of the test's own, and the
    router's top-k experts of every MoE layer run while spans record."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import moe as tmoe
    obs_trace._PROFILED = None
    eng, reqs = _span_engine()
    real, router = eng._prefill_one_chunk, tmoe._router
    routed = []

    def probed(now):
        with record_function("test.probe"):
            return real(now)

    def routes(x2, router_w, top_k):
        gate, idx = router(x2, router_w, top_k)
        if obs_trace._ACTIVE is not None:
            routed.append(idx.clone())
        return gate, idx

    eng._prefill_one_chunk = probed
    tmoe._router = routes
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("test.warm"):   # the profiler's first range
                pass                             # pays ~1 ms of its set-up
            eng.run(reqs, realtime=False)
    finally:
        tmoe._router = router
    buf = obs_trace.profiled()
    obs_trace._PROFILED = None
    return {"eng": eng, "reqs": reqs, "prof": prof, "buf": buf,
            "routed": routed}


def test_spans_record_the_engine_tree(profiled_run):
    """Each serve.prefill holds one .enqueue, .wait and .sample, and a
    layer span per layer, each holding the five moe.* spans; each
    moe.experts carries the routed rows, rows x top_k in all and per
    expert what the router chose; each
    serve.decode holds .call, .wait, .emit and .evict."""
    eng, buf = profiled_run["eng"], profiled_run["buf"]
    events = _x_spans(buf)
    prefills = [e for e in events if e["name"] == "serve.prefill"]
    assert len(prefills) == sum(-(-n // 8) for n in SPAN_LENS)
    moe = ["moe.combine", "moe.dispatch", "moe.experts", "moe.router",
           "moe.shared"]
    for pre in prefills:
        kids = _within(events, pre)
        for part in ("enqueue", "wait", "sample"):
            assert [e["name"] for e in kids].count(
                f"serve.prefill.{part}") == 1
        layers = [e for e in kids if e["name"] == "layer"]
        assert [e["args"]["i"] for e in layers] == \
            list(range(eng.cfg.n_layers))
        for lay in layers:
            inner = _within(events, lay)
            assert sorted(e["name"] for e in inner
                          if e["name"].startswith("moe.")) == moe
            assert {"attn.qkv", "attn.core", "attn.wo"} <= \
                {e["name"] for e in inner}
            rows = [e["args"]["routed_rows"] for e in inner
                    if e["name"] == "moe.experts"][0]
            assert len(rows) == eng.cfg.n_experts
            assert sum(rows) == pre["args"]["rows"] * eng.cfg.top_k
        assert pre["args"]["device_s"] > 0
    # each moe.experts span's counts are the router's top-k of that call,
    # expert by expert (spans close, and are stored, in call order)
    experts = [e["args"]["routed_rows"] for e in buf.events
               if e["name"] == "moe.experts"]
    routed = profiled_run["routed"]
    assert len(experts) == len(routed) >= len(prefills) * eng.cfg.n_layers
    for rows, idx in zip(experts, routed):
        assert rows == torch.bincount(idx.reshape(-1),
                                      minlength=eng.cfg.n_experts).tolist()
    decodes = [e for e in events if e["name"] == "serve.decode"]
    assert decodes
    for dec in decodes:
        names = [e["name"] for e in _within(events, dec)]
        for part in ("call", "wait", "emit", "evict"):
            assert names.count(f"serve.decode.{part}") == 1
    assert sum(e["name"] == "serve.admit" for e in events) == \
        len(SPAN_LENS)


def test_profiler_events_hold_no_span_name(profiled_run):
    """Spans add no event to the profiler (a record_function range would
    be mirrored onto the device timeline)."""
    span_names = {e["name"] for e in _x_spans(profiled_run["buf"])}
    prof_names = {e.name for e in profiled_run["prof"].events()}
    assert "test.probe" in prof_names
    assert not span_names & prof_names


def test_span_ts_is_on_the_profilers_clock(profiled_run):
    """An exported serve.prefill `ts` lies within 1 ms of the start of the
    record_function range wrapped around the same engine call, in
    kineto's own events (Unix ns)."""
    kin = sorted(e.start_ns() for e in
                 profiled_run["prof"].profiler.kineto_results.events()
                 if e.name() == "test.probe")
    doc = profiled_run["buf"].to_dict()["traceEvents"]
    ts = sorted(e["ts"] for e in doc if e["name"] == "serve.prefill")
    assert len(kin) == len(ts)
    for k, t in zip(kin, ts):
        assert abs(t - k / 1e3) < 1e3


def test_no_span_without_profiler_or_buffer(monkeypatch):
    """No profiler, no handed buffer: nothing is recorded and no buffer is
    left active."""
    monkeypatch.setattr(obs_trace, "_PROFILED", None)
    eng, reqs = _span_engine()
    eng.run(reqs, realtime=False)
    assert obs_trace.profiled() is None and obs_trace._ACTIVE is None
    assert not obs_trace.span("layer", i=0)


def test_tokens_bitwise_equal_with_spans_on_and_off(profiled_run):
    eng, reqs = _span_engine()
    eng.run(reqs, realtime=False)
    for a, b in zip(reqs, profiled_run["reqs"]):
        assert a.tokens == b.tokens
        for x, y in zip(a.logits, b.logits):
            assert np.array_equal(x, y)


def test_handed_buffer_slices_host_time_with_device_seconds(monkeypatch):
    """A handed buffer (`serve --trace-out`): the spans go to it, its `ts`
    is on the Unix clock, and each engine step slice lasts from the host's
    start of the step to its end with the step's seconds in `device_s`,
    whose sums are the histograms' sums."""
    buf = TraceBuffer()
    monkeypatch.setattr(obs_trace, "_PROFILED", None)
    eng, reqs = _span_engine(trace=buf)
    eng.run(reqs, realtime=False)
    assert obs_trace.profiled() is None
    doc = buf.to_dict()["traceEvents"]
    assert any(e["name"] == "serve.prefill" for e in doc)
    assert min(e["ts"] for e in doc if e["ph"] != "M") > 1e15
    for name, hist in (("prefill_chunk", "serve_prefill_chunk_s"),
                       ("decode_step", "serve_decode_step_s")):
        steps = [e for e in buf.events if e["name"] == name and e["tid"] == 0
                 and e["pid"] == obs_trace.ENGINE_PID]
        assert steps
        assert sum(e["args"]["device_s"] for e in steps) == \
            pytest.approx(eng.metrics.get(hist).sum(), rel=1e-12)
        for e in steps:
            assert e["args"]["dur_s"] >= e["args"]["device_s"]


def test_span_defer_resolves_after_the_step():
    """A deferred tensor lands in its span's args at `resolve`, not
    before; the null span ignores it."""
    buf = TraceBuffer()
    t = torch.tensor([0, 2, 2, 5])
    with obs_trace.activate(buf):
        with obs_trace.span("moe.experts") as sp:
            sp.defer("routed_rows", t, lambda v: [b - a for a, b in
                                                  zip(v, v[1:] + [7])])
        assert "routed_rows" not in buf.events[-1]["args"]
        buf.resolve()
    assert buf.events[-1]["args"]["routed_rows"] == [2, 0, 3, 2]
    assert obs_trace._ACTIVE is None
    obs_trace.span("x").defer("k", t)
