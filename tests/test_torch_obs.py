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
