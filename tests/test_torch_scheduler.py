"""Port parity, continuous batching (`repro_torch/launch/scheduler.py`):
gemma2-9b SMOKE in f32 on the `ideal` chip, the port's engine against the
JAX engine on the same params, calibration batches and requests (the
reference's pool-vs-static set: prompts of 32, 64, 96 and 32 tokens, 5, 3,
4 and 6 generated, 2 slots, chunks of 32, realtime=False), and against
the port's own static path per request; then the slot pool's invariants,
the one-compilation contract and the traffic stream.

The reference runs with `mesh=None` (`cfg.cim_mesh=None`): on jax 0.9 its
meshed path fails (ROADMAP queue C). Tolerance on logits, LOGIT_ATOL =
1e-4, as tests/test_torch_serve.py: O(1) logits through O(100) f32
roundings taken in another order; greedy tokens must be equal. Pool and
static are not compared bit for bit: attention's batched products and the
chunked prefill round in another order (the reference's own pool drifts
by 1 ulp, queue C).

JAX is imported by the fixtures that need it, so the CUDA test also runs
on a card without JAX (`--noconftest`).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.data import traffic_requests
from repro_torch.launch import scheduler as S
from repro_torch.launch import serve as tserve
from repro_torch.obs import JitRetraceError, JitWatcher

LOGIT_ATOL = 1e-4
LENS, GENS = [32, 64, 96, 32], [5, 3, 4, 6]
MAX_LEN = 128


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _requests(vocab, lens, gens):
    return [S.Request(rid=i, prompt=p, max_new=g)
            for i, (p, g) in enumerate(zip(_prompts(vocab, lens), gens))]


@pytest.fixture(scope="module")
def served():
    """Both engines on one deployment: the reference's, and the port's
    from the same params and calibration batches."""
    import jax
    import jax.numpy as jnp
    from _torch_parity import reference_x_cal
    from repro import configs as jconfigs
    from repro.launch.scheduler import ContinuousBatchingEngine, Request
    from repro.launch.steps import arch_serving
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import nn as tnn
    cfg = jconfigs.get("gemma2-9b", smoke=True).replace(
        dtype=jnp.float32, cim_mode="packed", cim_mesh=None)
    sv = arch_serving(cfg)
    params = sv.init_params(jax.random.PRNGKey(0))
    deployed = sv.deploy_cim(jax.random.PRNGKey(7), params, mode="ideal",
                             mesh_shape={"model": 1})
    prompts = _prompts(cfg.vocab, LENS)
    ref_reqs = [Request(rid=i, prompt=p, max_new=g)
                for i, (p, g) in enumerate(zip(prompts, GENS))]
    ref_eng = ContinuousBatchingEngine(cfg, deployed, n_slots=2,
                                       max_len=MAX_LEN, chunk=32,
                                       capture_logits=True)
    ref_stats = ref_eng.run(ref_reqs, realtime=False)

    pnp = jax.tree_util.tree_map(np.asarray, params)
    stacked = {n: pnp["layers"][n] for n in tnn.PACKED_PROJ_KEYS
               if n in pnp["layers"]}
    x_cal = reference_x_cal(jax.random.PRNGKey(7), stacked, 3.0)
    tcfg, tparams, _ = tserve.deploy(
        "gemma2-9b", smoke=True, cim=True, device="cpu",
        params=params_from_numpy(pnp), x_cal=x_cal)
    reqs = _requests(tcfg.vocab, LENS, GENS)
    eng = S.ContinuousBatchingEngine(tcfg, tparams, n_slots=2,
                                     max_len=MAX_LEN, chunk=32,
                                     capture_logits=True)
    stats = eng.run(reqs, realtime=False)
    return {"ref_reqs": ref_reqs, "ref_stats": ref_stats, "ref_eng": ref_eng,
            "ref_cfg": cfg, "ref_params": deployed,
            "reqs": reqs, "stats": stats, "eng": eng, "cfg": tcfg,
            "params": tparams}


def test_engine_tokens_equal_reference(served):
    for r, q in zip(served["reqs"], served["ref_reqs"]):
        assert r.tokens == q.tokens, f"rid {r.rid}"
        assert len(r.tokens) == r.max_new


def test_engine_logits_match_reference(served):
    for r, q in zip(served["reqs"], served["ref_reqs"]):
        assert len(r.logits) == len(q.logits) == r.max_new
        for i, (a, b) in enumerate(zip(r.logits, q.logits)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=LOGIT_ATOL,
                                       err_msg=f"rid {r.rid} token {i}")


@pytest.mark.parametrize("key", ["requests", "tokens", "decode_traces",
                                 "mvm_dispatches", "energy_pj",
                                 "pj_per_token", "tops_per_w",
                                 "utilization"])
def test_engine_accounting_equals_reference(served, key):
    """The same schedule (realtime=False) dispatches the same rows: the
    modeled chip energy and the utilization are the reference's exactly."""
    assert served["stats"][key] == served["ref_stats"][key]


def test_engine_metric_names_equal_reference(served):
    """Every series the engine exports is the reference's (name, labels)."""
    def names(doc):
        return {(kind, e["name"], tuple(sorted(e["labels"].items())))
                for kind in ("counters", "gauges", "histograms")
                for e in doc[kind]}
    assert names(served["eng"].metrics.to_dict()) == \
        names(served["ref_eng"].metrics.to_dict())


def test_pool_matches_static_per_request(served):
    """Each request of the pool, served alone through the port's static
    path (same cache length): greedy tokens equal, logits within
    LOGIT_ATOL."""
    cfg, params = served["cfg"], served["params"]
    for r in served["reqs"]:
        g = tserve.greedy_decode(params, cfg,
                                 torch.as_tensor(r.prompt[None]).long(),
                                 r.max_new, torch.device("cpu"),
                                 max_len=MAX_LEN)
        assert g.tokens[0].tolist() == r.tokens, f"rid {r.rid}"
        for i, (a, b) in enumerate(zip(r.logits, g.logits)):
            np.testing.assert_allclose(a, b[0].numpy(), rtol=0,
                                       atol=LOGIT_ATOL,
                                       err_msg=f"rid {r.rid} token {i}")


def test_static_baseline_matches_reference(served):
    """The static baseline at equal load (lockstep batches of 2, prompts
    left-padded, realtime=False): the reference's tokens, logits within
    LOGIT_ATOL and the same metered rows and energy."""
    from repro.launch.scheduler import Request, serve_static
    lens, gens = [32, 64, 32], [3, 2, 4]
    prompts = _prompts(served["cfg"].vocab, lens, seed=4)
    ref = [Request(rid=i, prompt=p, max_new=g)
           for i, (p, g) in enumerate(zip(prompts, gens))]
    mine = [S.Request(rid=i, prompt=p, max_new=g)
            for i, (p, g) in enumerate(zip(prompts, gens))]
    kw = dict(batch=2, max_len=96, capture_logits=True, realtime=False)
    want = serve_static(served["ref_cfg"], served["ref_params"], ref, **kw)
    got = S.serve_static(served["cfg"], served["params"], mine, **kw)
    for key in ("requests", "tokens", "mvm_dispatches", "energy_pj",
                "pj_per_token", "utilization"):
        assert got[key] == want[key], key
    for r, q in zip(mine, ref):
        assert r.tokens == q.tokens, f"rid {r.rid}"
        for a, b in zip(r.logits, q.logits):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=LOGIT_ATOL)


def _float_engine(n_slots, max_len, **kw):
    cfg = tserve.serving_config("gemma2-9b", smoke=True)
    from repro_torch.models import transformer as tT
    params = tT.init_params(cfg, seed=0, device="cpu")
    return cfg, S.ContinuousBatchingEngine(cfg, params, n_slots=n_slots,
                                           max_len=max_len, **kw)


def test_slot_pool_no_double_assign_and_eviction_frees():
    """More requests than slots: every slot is live for at most one request
    at a time, eviction returns the slot to the free list, and every
    request completes with exactly max_new tokens."""
    cfg, eng = _float_engine(2, 96)
    reqs = _requests(cfg.vocab, [32, 64, 32, 32, 64], [4, 2, 5, 3, 1])
    assignments = []
    orig = eng._admit

    def traced_admit(req):
        orig(req)
        slot = eng._jobs[-1].slot
        assert slot not in eng._live, "slot double-assigned while live"
        assignments.append((slot, req.rid))
    eng._admit = traced_admit
    eng.run(reqs, realtime=False)
    assert sorted(eng._free) == [0, 1] and not eng._live and not eng._jobs
    assert not eng.pool["active"].any()
    assert len(assignments) == len(reqs)
    for r in reqs:
        assert len(r.tokens) == r.max_new
        assert r.t_done >= 0 and r.t_first >= 0


def test_admission_resets_slot_state():
    """Admission zeroes the slot's KV and bookkeeping in place, so a reused
    slot never leaks the previous request's state; the other slot and the
    tensors' addresses stay."""
    cfg = tserve.serving_config("gemma2-9b", smoke=True)
    pool = S.init_pool(cfg, 2, 64, device="cpu")
    for k, a in pool.items():
        if k == "active":
            a.fill_(True)
        else:
            a.add_(1)
    ptrs = {k: a.data_ptr() for k, a in pool.items()}
    out = S._reset_slot(pool, 1)
    assert out is pool
    for k, a in pool.items():
        assert a.data_ptr() == ptrs[k], k
        if k in ("len", "active", "tok"):
            assert not a[1].any() and a[0].all(), k
        else:
            assert not a[:, 1].any(), f"{k} slot not zeroed"
            assert a[:, 0].all(), f"{k} other slot clobbered"


def test_inactive_slot_state_is_bit_identical_across_steps():
    """A frozen (inactive) slot's KV, fill and token do not move while the
    live slot decodes beside it."""
    cfg, eng = _float_engine(2, 96)
    for r in _requests(cfg.vocab, [64, 32], [8, 8]):
        eng._admit(r)
    while eng._jobs:
        eng._prefill_one_chunk(0.0)
    eng._activate(eng.pool, 1, False)
    snap = {k: v.clone() for k, v in eng.pool.items()}
    for _ in range(3):
        eng.stripes[0].decode(eng.params, eng.pool)
    for k in ("k", "v"):
        assert torch.equal(eng.pool[k][:, 1], snap[k][:, 1]), k
        assert not torch.equal(eng.pool[k][:, 0], snap[k][:, 0]), k
    for k in ("len", "tok", "active"):
        assert torch.equal(eng.pool[k][1], snap[k][1]), k
    assert eng.pool["len"].tolist() == [67, 32]


def test_one_decode_compilation_across_occupancy_changes():
    """The decode step compiles ONCE across every occupancy pattern; the
    prefill once per chunk length: a 48-token prompt leaves a 16-token
    chunk, so exactly two signatures ({32, 16})."""
    cfg, eng = _float_engine(3, 128)
    reqs = _requests(cfg.vocab, [32, 48, 32, 96, 32, 64], [3, 6, 2, 4, 5, 1])
    stats = eng.run(reqs, realtime=False)
    assert stats["decode_traces"] == eng.decode_traces() == 1
    assert eng._prefill.traces == 2
    report = eng.jitwatch.report()
    assert report["slot_activate"]["traces"] == 2
    assert report["slot_reset"]["traces"] == 1


def _check_traffic(tokens, lengths, mask, arrivals, gen, *, lo, hi, page,
                   min_gen, max_gen):
    tokens, lengths, mask, arrivals, gen = map(
        np.asarray, (tokens, lengths, mask, arrivals, gen))
    assert lengths.min() >= lo and lengths.max() <= hi
    assert (lengths % page == 0).all()
    np.testing.assert_array_equal(mask.sum(1), lengths)
    assert (tokens[~mask] == 0).all()
    assert (np.diff(arrivals) >= 0).all() and (arrivals > 0).all()
    assert gen.min() >= min_gen and gen.max() <= max_gen


def test_traffic_requests_invariants_and_determinism():
    """The port's stream: the same generator seed gives the same traffic,
    another seed other traffic; lengths are page multiples in range, the
    pad mask matches them, tokens are 0 under it, arrivals increase, gen
    lies in range — the invariants the reference's stream (exported as
    numpy) holds too."""
    import jax
    from repro.data import traffic_requests as ref_traffic
    kw = dict(min_len=32, max_len=96, page=32, rate=40.0)
    a = traffic_requests(torch.Generator().manual_seed(5), 64, 512, **kw)
    b = traffic_requests(torch.Generator().manual_seed(5), 64, 512, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = traffic_requests(torch.Generator().manual_seed(6), 64, 512, **kw)
    assert not torch.equal(a.tokens, c.tokens)
    ref = ref_traffic(jax.random.PRNGKey(5), 64, 512, **kw)
    for t in (a, ref):
        _check_traffic(*(np.asarray(x) for x in t), lo=32, hi=96, page=32,
                       min_gen=4, max_gen=16)
    # every page count and generation budget of the range is drawn
    assert set(a.lengths.tolist()) == {32, 64, 96}
    assert abs(float(a.arrivals[-1]) - 64 / 40.0) < 0.5 * 64 / 40.0


def test_reference_stream_serves_through_the_port():
    """Requests built from the reference's stream (exported as numpy) go
    through the port's engine: every request gets its budget."""
    import jax
    from repro.data import traffic_requests as ref_traffic
    tr = ref_traffic(jax.random.PRNGKey(1), 4, 512, min_len=32, max_len=64,
                     page=32, rate=50.0, min_gen=2, max_gen=4)
    toks, lens = np.asarray(tr.tokens), np.asarray(tr.lengths)
    reqs = [S.Request(rid=i, prompt=toks[i, :lens[i]],
                      max_new=int(tr.gen[i]), arrival=float(tr.arrivals[i]))
            for i in range(4)]
    _, eng = _float_engine(2, 68)
    stats = eng.run(reqs, realtime=False)
    assert stats["decode_traces"] == 1
    assert [len(r.tokens) for r in reqs] == np.asarray(tr.gen).tolist()


def test_sealed_watcher_raises_on_new_signature():
    w = JitWatcher()
    f = w.wrap("f", lambda x, flag: x + 1, static_argnums=(1,))
    f(torch.zeros(2, 3), True)
    w.seal()
    f(torch.ones(2, 3), True)                  # same signature: no raise
    with pytest.raises(JitRetraceError, match="'f'"):
        f(torch.zeros(2, 4), True)             # new shape
    with pytest.raises(JitRetraceError, match="sealed"):
        f(torch.zeros(2, 3), False)            # new static value
    with pytest.raises(JitRetraceError):
        f({"a": torch.zeros(2, 3, dtype=torch.int32)}, True)
    assert w.report()["f"]["traces"] == 4


def test_strict_watcher_raises_over_budget():
    w = JitWatcher(strict=True)
    f = w.wrap("g", lambda x: x, max_traces=1)
    f(torch.zeros(1))
    with pytest.raises(JitRetraceError, match="budget 1"):
        f(torch.zeros(2))
    lax = JitWatcher()
    g = lax.wrap("g", lambda x: x, max_traces=1)
    g(torch.zeros(1))
    g(torch.zeros(2))                          # recorded, not raised
    with pytest.raises(JitRetraceError):
        lax.check()


def test_watcher_reads_a_steps_own_compilations():
    """A step that keeps its own compilation cache (a CUDA-graph capture per
    set of input tensors) is counted by that cache, read after the call,
    not by its input signature; a sealed watcher raises once it grows."""
    class Cached:
        def __init__(self):
            self.n = 0

        def _cache_size(self):
            return self.n

        def __call__(self, x):
            self.n += x
            return x

    w = JitWatcher()
    step = Cached()
    f = w.wrap("step", step, max_traces=1)
    f(1)
    f(0)
    assert (f.traces, f.calls) == (1, 2)
    w.seal()
    with pytest.raises(JitRetraceError, match="'step'"):
        f(1)
    assert step.n == 2 and f.traces == 2 and f.calls == 3


def test_captured_step_refuses_cpu_tensors():
    """A captured step runs on the card or raises: it never runs eagerly on
    host tensors in place of its graph."""
    from repro_torch.launch.steps import CapturedStep
    launches = {"cim_mvm_packed": 0}
    step = CapturedStep(lambda x: x + 1, launches)
    with pytest.raises(ValueError, match="CUDA"):
        step(torch.zeros(2))
    assert step._cache_size() == 0 and launches == {"cim_mvm_packed": 0}


def test_serve_traffic_cli_writes_obs_files(tmp_path, served):
    """`serve --smoke --cim --traffic --requests 4 --slots 2 --device cpu`
    writes the summary (one decode compilation), the metrics in JSON and
    Prometheus text under the reference's names, and a Chrome trace."""
    out = {k: tmp_path / f"{k}.out" for k in ("summary", "metrics", "prom",
                                               "trace")}
    stats = tserve.main([
        "--smoke", "--cim", "--traffic", "--requests", "4", "--slots", "2",
        "--device", "cpu", "--summary-out", str(out["summary"]),
        "--metrics-out", str(out["metrics"]), "--prom-out",
        str(out["prom"]), "--trace-out", str(out["trace"]),
        "--strict-jit"])
    summary = json.loads(out["summary"].read_text())
    assert summary["decode_traces"] == stats["decode_traces"] == 1
    assert summary["mode"] == "traffic" and summary["requests"] == 4
    doc = json.loads(out["metrics"].read_text())
    ref_doc = served["ref_eng"].metrics.to_dict()
    for kind in ("counters", "gauges", "histograms"):
        assert {e["name"] for e in doc[kind]} == \
            {e["name"] for e in ref_doc[kind]}, kind
    prom = out["prom"].read_text()
    assert "# TYPE serve_decode_step_s histogram" in prom
    assert 'jit_traces{entry="pool_decode"} 1.0' in prom
    events = json.loads(out["trace"].read_text())["traceEvents"]
    assert sum(e["name"] == "request" for e in events) == 4


def test_engine_refuses_a_mesh():
    """A mesh serving cannot take (the production mesh's 'pod' axis) and
    a slot count that does not stripe over the data rows are refused; a
    'model'-only mesh leaves the pool whole, two data rows stripe it."""
    from repro_torch.distributed.sharding import Sharded
    from repro_torch.launch.mesh import Mesh
    cfg = tserve.serving_config("gemma2-9b", smoke=True)
    with pytest.raises(ValueError, match="axes"):
        S.init_pool(cfg, 2, 8, mesh=Mesh([[["cpu"]], [["cpu"]]],
                                         ("pod", "data", "model")))
    with pytest.raises(ValueError, match="do not stripe"):
        S.init_pool(cfg, 3, 8, mesh=Mesh([["cpu"], ["cpu"]]))
    assert S.init_pool(cfg, 2, 8, mesh=Mesh([["cpu"] * 2]),
                       device="cpu")["len"].shape == (2,)
    pool = S.init_pool(cfg, 4, 8, mesh=Mesh([["cpu"], ["cpu"]]))
    assert isinstance(pool["k"], Sharded) and pool["k"].shape[1] == 4
    assert [s.shape[1] for s in pool["k"].shards] == [2, 2]


@pytest.mark.cuda
def test_graph_replay_equals_eager_on_card():
    """On the card the decode step is captured once. The capture call runs
    the step once (live slots advance one position, as eagerly); a replay
    equals the step function run eagerly on a clone of the pool, bit for
    bit, with mixed fills (32, 64) and with one slot frozen; each replay
    adds the captured launches to the counters."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.kernels.build import LAUNCHES
    cfg, params, _ = tserve.deploy("gemma2-9b", smoke=True, cim=True,
                                   device="cuda")
    eng = S.ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=96)
    for r in _requests(cfg.vocab, [64, 32], [8, 8]):
        eng._admit(r)
    while eng._jobs:
        eng._prefill_one_chunk(0.0)
    for capture, frozen in ((True, False), (False, False), (False, True)):
        if frozen:
            eng._activate(eng.pool, 1, False)
        clone = {k: v.clone() for k, v in eng.pool.items()}
        before = dict(LAUNCHES)
        logits, _ = eng.stripes[0].decode(eng.params, eng.pool)
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        eager, _ = eng._step(eng.params, clone)
        torch.cuda.synchronize()
        assert torch.equal(logits, eager)
        for k, v in eng.pool.items():
            assert torch.equal(v, clone[k]), k
        if capture:
            assert eng.pool["len"].tolist() == [65, 33]
        else:
            assert launched == eng.stripes[0].decode.fun.per_replay
    assert eng.decode_traces() == 1
    per_replay = dict(eng.stripes[0].decode.fun.per_replay)
    assert per_replay.pop("gqa_attention") == cfg.n_layers
    assert sum(per_replay.values()) == 7 * cfg.n_layers
