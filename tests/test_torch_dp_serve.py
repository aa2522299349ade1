"""Port parity, the data axis in serving: a CIM deploy on a (data, model)
mesh with two data rows, the batch-striped static path and the striped
slot pool (`nn.row_params`, `serve.greedy_decode(stripes=)`,
`scheduler.init_pool(mesh=)`), against the reference on the CPU.

Smoke gemma2-9b cut to one layer, with d_ff 128 and 4 KV heads (every
projection 128 x 128: the reference compiles one chip shape, which keeps
its deploy short), on Meshes of CPU devices of shape 2x1 and 2x2 (every
device the CPU: a row's chips are the same tensors as row 0's). The
reference deploys at the same 'model' width with `cfg.cim_mesh=None` (its
unrolled shard loop: on jax 0.9 its meshed serve path fails, ROADMAP
queue C) and serves the whole batch, or the whole pool, in one piece
(both widths at once, in two threads): the data axis changes where rows
run, not what they compute. Calibration batches are rebuilt from the
reference's keys (`test_torch_tp_serve.shard_x_cal`).

Tolerances: partitions, plans and index maps exactly, every row's chips
equal to the deploy's, tiles and calibrated tensors as
`assert_chip_match` holds them; greedy tokens equal; logits within
LOGIT_ATOL = 1e-4 (tests/test_torch_serve.py).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_chip_match, to_numpy, to_torch
from test_torch_tp_serve import _kinds, shard_x_cal

from repro import configs as jconfigs
from repro.data import lm_tokens
from repro.launch.scheduler import ContinuousBatchingEngine, Request
from repro.launch.steps import arch_serving, make_decode_step
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.sharding import Sharded
from repro_torch.launch import scheduler as S
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import Mesh
from repro_torch.models import nn as tnn

GEMMA = "gemma2-9b"
B, S_LEN, GEN = 4, 8, 4
LOGIT_ATOL = 1e-4
SLOTS, CHUNK, MAX_LEN = 4, 8, 32
LENS, GENS = [8, 16, 8, 16, 8], [4, 2, 3, 4, 2]
CPU = torch.device("cpu")
CUT = dict(n_layers=1, d_ff=128, n_kv_heads=4)
WIDTHS = (1, 2)
KEY_SEED = 7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(vocab):
    rng = np.random.default_rng(4)
    return [(rng.integers(0, vocab, (n,)).astype(np.int32), g)
            for n, g in zip(LENS, GENS)]


def _reference(width):
    """The reference at 'model' width `width`: its deploy, the static
    serve's tokens and logits, and the pool's requests."""
    jc = jconfigs.get(GEMMA, smoke=True).replace(
        dtype=jnp.float32, cim_mode="packed", cim_mesh=None, **CUT)
    sv = arch_serving(jc)
    params = sv.init_params(jax.random.PRNGKey(0))
    ref = sv.deploy_cim(jax.random.PRNGKey(KEY_SEED), params, mode="ideal",
                        mesh_shape={"model": width})
    prompts = lm_tokens(jax.random.PRNGKey(1), B, S_LEN, jc.vocab)
    logits, cache = jax.jit(sv.prefill)(ref, sv.init_state(B, S_LEN + GEN),
                                        prompts)
    decode = jax.jit(make_decode_step(jc))
    toks, ref_logits = [jnp.argmax(logits, -1)[:, None]], [logits]
    for _ in range(GEN - 1):
        logits, cache = decode(ref, cache, {"tokens": toks[-1]})
        toks.append(jnp.argmax(logits, -1)[:, None])
        ref_logits.append(logits)
    stream = _stream(jc.vocab)
    ref_reqs = [Request(rid=i, prompt=p, max_new=g)
                for i, (p, g) in enumerate(stream)]
    ref_stats = ContinuousBatchingEngine(
        jc, ref, n_slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
        capture_logits=True).run(ref_reqs, realtime=False)
    return {"params": params, "ref": ref, "prompts": prompts,
            "ref_stats": ref_stats,
            "ref_tokens": np.asarray(jnp.concatenate(toks, axis=1)),
            "ref_logits": [np.asarray(x) for x in ref_logits],
            "stream": stream, "ref_reqs": ref_reqs}


@pytest.fixture(scope="module")
def references():
    """Both widths' reference runs, in two threads at once (they share
    nothing; XLA compiles without the interpreter lock)."""
    with ThreadPoolExecutor(2) as ex:
        return dict(zip(WIDTHS, ex.map(_reference, WIDTHS)))


@pytest.fixture(scope="module", params=WIDTHS, ids=["2x1", "2x2"])
def served(request, references):
    """The reference at 'model' width M, served whole; the port deployed
    on a 2 x M mesh of CPU devices, served striped (static and pool)."""
    width = request.param
    r = references[width]
    params, ref, prompts = r["params"], r["ref"], r["prompts"]
    stream = r["stream"]
    pnp = jax.tree_util.tree_map(np.asarray, params)
    names = [n for n in tnn.PACKED_PROJ_KEYS if n in pnp["layers"]]
    x_cal, x_shards = shard_x_cal(
        jax.random.PRNGKey(KEY_SEED),
        {n: pnp["layers"][n] for n in names}, 3.0, width,
        _kinds(ref["layers"], names))
    mesh = Mesh([["cpu"] * width] * 2)
    tcfg = tserve.serving_config(GEMMA, smoke=True, cim=True).replace(
        cim_mesh=mesh, **CUT)
    tparams = tnn.deploy_cim(params_from_numpy(pnp), tcfg, mode="ideal",
                             mesh=mesh, x_cal=x_cal, x_cal_shards=x_shards)
    stripes = tserve.data_stripes(tparams, B)
    out = tserve.greedy_decode(tparams, tcfg,
                               to_torch(np.asarray(prompts)).long(), GEN,
                               CPU, stripes=stripes)
    reqs = [S.Request(rid=i, prompt=p, max_new=g)
            for i, (p, g) in enumerate(stream)]
    eng = S.ContinuousBatchingEngine(tcfg, tparams, n_slots=SLOTS,
                                     max_len=MAX_LEN, chunk=CHUNK, mesh=mesh,
                                     capture_logits=True)
    stats = eng.run(reqs, realtime=False)
    return {"width": width, "names": names, "ref": ref, "mesh": mesh,
            "ref_tokens": r["ref_tokens"], "ref_logits": r["ref_logits"],
            "ref_reqs": r["ref_reqs"], "ref_stats": r["ref_stats"],
            "tparams": tparams, "tcfg": tcfg,
            "stripes": stripes, "out": out, "reqs": reqs, "eng": eng,
            "stats": stats}


def _chips(entry):
    """The PackedCIMLayers of a per-layer stack entry, in order."""
    return [c for layer in entry
            for c in (layer.shards if hasattr(layer, "shards") else [layer])]


def test_rows_hold_the_deploys_chips(served):
    """Each data row holds the deploy's chips (partitions, shard count,
    and on one device the very same tensors), and those match the
    reference's shard chips."""
    tp, ref = served["tparams"], served["ref"]["layers"]
    rows = tp["cim_rows"]
    assert len(rows) == 2
    for n in served["names"]:
        deployed = tp["layers"][n + "_cim"]
        spl = ref[n + "_cim"]
        for r, row in enumerate(rows):
            mine = row["entries"][("layers", n + "_cim")]
            for a, b in zip(mine, deployed):
                assert type(a) is type(b), n
                if hasattr(a, "shards"):
                    assert (a.partition, a.n_shards) == (
                        b.partition, b.n_shards) == (spl.partition,
                                                     served["width"]), n
            for a, b in zip(_chips(mine), _chips(deployed)):
                assert a.packed.gd_tiles.data_ptr() == \
                    b.packed.gd_tiles.data_ptr(), (n, r)
        for li, layer in enumerate(deployed):
            chips = layer.shards if hasattr(layer, "shards") else [layer]
            for s, pcl in enumerate(chips):
                pj = jax.tree_util.tree_map(
                    lambda a: np.asarray(a)[li, s], spl.shards)
                assert_chip_match(pcl, pj, f"{n} layer {li} shard {s}")


def test_static_stripes_tokens_equal_reference(served):
    assert len(served["stripes"]) == 2
    assert to_numpy(served["out"].tokens).tolist() == \
        served["ref_tokens"].tolist()


def test_static_stripes_logits_allclose(served):
    for step, (g, want) in enumerate(zip(served["out"].logits,
                                         served["ref_logits"])):
        np.testing.assert_allclose(to_numpy(g), want, rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"token {step}")


def test_striped_pool_tokens_equal_reference(served):
    for r, q in zip(served["reqs"], served["ref_reqs"]):
        assert r.tokens == q.tokens, f"rid {r.rid}"
        assert len(r.tokens) == r.max_new


def test_striped_pool_logits_allclose(served):
    for r, q in zip(served["reqs"], served["ref_reqs"]):
        assert len(r.logits) == len(q.logits) == r.max_new
        for i, (a, b) in enumerate(zip(r.logits, q.logits)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=LOGIT_ATOL,
                                       err_msg=f"rid {r.rid} token {i}")


@pytest.mark.parametrize("key", ["mvm_dispatches", "energy_pj",
                                 "pj_per_token", "utilization"])
def test_striped_pool_chip_energy_equals_reference(served, key):
    """The striped pool's chip meter counts row 0's chips once (the other
    rows' copies in params['cim_rows'] are not metered again), so its
    dispatches, energy, energy per token and utilization equal the
    reference's pool served whole, and so does every request's energy."""
    assert served["stats"][key] == served["ref_stats"][key]
    for r, q in zip(served["reqs"], served["ref_reqs"]):
        assert r.energy_pj == q.energy_pj, f"rid {r.rid}"


def test_striped_pool_one_decode_step_per_stripe(served):
    """Two stripes of two slots, each a sub-pool of the striped pool with
    its own decode entry point, compiled once."""
    eng = served["eng"]
    assert isinstance(eng.pool["k"], Sharded)
    assert [st.pool["len"].shape[0] for st in eng.stripes] == [2, 2]
    assert eng.stripe_traces() == [1, 1]
    assert served["stats"]["decode_traces"] == 1
    assert {"pool_decode/stripe0", "pool_decode/stripe1"} <= set(
        eng.jitwatch.report())
    assert sorted(eng._free) == list(range(SLOTS)) and not eng._live


def test_batch_that_does_not_stripe_runs_on_row_zero(served):
    """A batch the two rows do not divide is served whole, as the
    reference's fit_pspecs replicates it."""
    assert tserve.data_stripes(served["tparams"], 3) is None
    assert len(tserve.data_stripes(served["tparams"], 4)) == 2


def test_serve_cli_stripes_over_data_rows(monkeypatch, capsys):
    """`serve --cim-mesh 2x1` over two local devices (both the CPU here):
    the static path and --traffic serve, the summary reports 2x1; 'auto'
    factors the two devices as the reference does (1x2)."""
    from repro_torch.launch import mesh as mesh_mod
    monkeypatch.setattr(mesh_mod, "local_devices",
                        lambda kind="cuda": [CPU, CPU])
    base = ["--smoke", "--cim", "--device", "cpu", "--layers", "1",
            "--prompt-len", "8", "--gen", "2"]
    tokens = tserve.main(base + ["--batch", "4", "--cim-mesh", "2x1"])
    assert tuple(tokens.shape) == (4, 2)
    assert "mesh=2x1)" in capsys.readouterr().out
    tserve.main(base + ["--traffic", "--requests", "3", "--slots", "2",
                        "--chunk", "8", "--cim-mesh", "2x1"])
    assert "mesh=2x1)" in capsys.readouterr().out
    tserve.main(base + ["--batch", "2"])
    assert "tp=2, mesh=1x2)" in capsys.readouterr().out


def test_striped_decode_is_timed_over_every_stripes_card(monkeypatch):
    """`timed_call` over stripes on two distinct cards waits for both
    before and after the call (host clock: events time one card); CPU
    stripes are timed by the host clock alone."""
    from repro_torch.obs import clock
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    devs = [torch.device("cuda:0"), torch.device("cuda:1")] * 2
    out, dt = clock.timed_call(lambda: "ran", device=devs)
    assert out == "ran" and dt >= 0
    assert synced == devs[:2] * 2
    out, dt = clock.timed_call(lambda: "ran", device=[CPU, CPU])
    assert out == "ran" and dt >= 0 and synced == devs[:2] * 2
