"""Port parity, tensor-parallel CIM serving: the reference's per-shard chip
deploys (`nn.deploy_transformer_cim` / `deploy_recurrent_cim` with
mesh_shape {'model': M}) and the port's, from the same params,
calibration batches and prompts, served greedily on the CPU (batch 2,
prompt 8, 4 generated tokens).

Variants of smoke gemma2-9b: M = 2 on the default chip (single-pass
plans), M = 4 with d_ff = 255 (w_g, w_i and w_o do not divide: replicated
'none' stacks of their own, as the reference's `_mesh_parity_child.py`
makes them), M = 2 on a 4-core chip (merged cores: the scheduled kernel)
and M = 2 with IR drop (47-column tiles); then smoke deepseek-moe-16b (1
layer, 4 experts, top-2, M = 2: the experts placed expert-parallel) and
smoke rwkv6-7b (M = 2).

The reference runs with `cfg.cim_mesh=None` (its unrolled shard loop, the
parity oracle: on jax 0.9 its meshed path fails, ROADMAP queue C). The
port deploys onto a `Mesh` of M CPU devices and serves through its one
executor, `nn.sharded_packed_loop`, whose output must equal its shards'
own launches combined in shard order bit for bit. The
reference draws each chip's calibration batches from jax.random inside
its deploy (shard s from fold_in(key, s), the 'none' chips from
fold_in(key, M), expert e from fold_in(key, 7919 + e)); they are rebuilt
here from the same keys and handed to the port as x_cal / x_cal_shards /
x_cal_experts.

Tolerances: plans, partitions and index maps exactly; programmed tiles
equal and calibrated tensors to f32 rounding (`assert_chip_match`);
greedy tokens equal and logits within LOGIT_ATOL = 1e-4
(tests/test_torch_serve.py); a projection's loop output within one ADC
count per .5-boundary tile of the reference's loop (`boundary_hits`);
modeled chip energies equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_chip_match, boundary_hits,
                           reference_x_cal, to_numpy, to_torch)

from repro import configs as jconfigs
from repro.core.types import CoreSpec as JSpec
from repro.data import lm_tokens
from repro.launch.steps import arch_serving, make_decode_step
from repro.models import nn as jnn
from repro.obs.chipmeter import ChipMeter as JMeter
from repro_torch.convert import params_from_numpy
from repro_torch.core.quant import quantize_to_int
from repro_torch.core.types import CIMConfig, CoreSpec
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.launch import scheduler as S
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import Mesh
from repro_torch.models import nn as tnn
from repro_torch.obs.chipmeter import ChipMeter

B, S_LEN, GEN = 2, 8, 4
LOGIT_ATOL = 1e-4
GEMMA = "gemma2-9b"
VARIANTS = {
    "tp2": dict(arch=GEMMA, width=2),
    "tp4-dff255": dict(arch=GEMMA, width=4, cfg=dict(d_ff=255)),
    "tp2-merged": dict(arch=GEMMA, width=2, cores=4),
    "tp2-irdrop": dict(arch=GEMMA, width=2, cfg=dict(cim_ir_drop=2e-7)),
    "deepseek-tp2": dict(arch="deepseek-moe-16b", width=2,
                         cfg=dict(n_layers=1, n_experts=4, top_k=2)),
    "rwkv6-tp2": dict(arch="rwkv6-7b", width=2),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _expert_x_cal(key, expert_stacked, alpha):
    """The reference's expert chips' batches: expert e's stack at
    fold_in(key, 7919 + e), as a per-layer, per-expert list."""
    names = sorted(expert_stacked)
    n_layers, n_experts = expert_stacked[names[0]].shape[:2]
    out = [[None] * n_experts for _ in range(n_layers)]
    for e in range(n_experts):
        stack = {n: expert_stacked[n][:, e] for n in names}
        for li, b in enumerate(reference_x_cal(key, stack, alpha,
                                               n_shards=7919 + e)):
            out[li][e] = b
    return out


def shard_x_cal(key, stacked, alpha, width: int, kinds):
    """(x_cal, x_cal_shards) of a width-M deploy: the 'none' group's
    batches at fold_in(key, M), shard s's at fold_in(key, s) over its
    local slices, each group's names alone (the reference compiles each
    group on chips of its own)."""
    from repro_torch.distributed.sharding import param_pspecs, shard_shape
    specs = param_pspecs({"layers": {n: torch.empty(w.shape, device="meta")
                                     for n, w in stacked.items()}})["layers"]
    sharded = {n: w for n, w in stacked.items() if kinds[n] != "none"}
    none = {n: w for n, w in stacked.items() if kinds[n] == "none"}

    def alpha_of(group):
        return {n: alpha[n] for n in group} if isinstance(alpha, dict) \
            else alpha
    x_cal = reference_x_cal(key, none, alpha_of(none), width) \
        if none else None
    shards = None
    if sharded:
        local = {n: np.zeros(shard_shape(w.shape, specs[n],
                                         {"model": width}), np.float32)
                 for n, w in sharded.items()}
        shards = [reference_x_cal(key, local, alpha_of(local), s)
                  for s in range(width)]
    return x_cal, shards


def _kinds(ref_layers, names):
    return {n: ref_layers[n + "_cim"].partition for n in names}


_SERVED = {}


def _serve(name):
    """One variant served by both packages (memoized: the MoE variant
    feeds two fixtures of tests/test_torch_tp_archs.py)."""
    if name not in _SERVED:
        _SERVED[name] = _serve_variant(name)
    return _SERVED[name]


def _serve_variant(name):
    v = VARIANTS[name]
    arch, width = v["arch"], v["width"]
    cfg_kw = v.get("cfg", {})
    jc = jconfigs.get(arch, smoke=True).replace(
        dtype=jnp.float32, cim_mode="packed", cim_mesh=None, **cfg_kw)
    jspec = JSpec(n_cores=v["cores"]) if "cores" in v else None
    sv = arch_serving(jc)
    params = sv.init_params(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(7)
    deployed = sv.deploy_cim(key, params, mode="ideal", spec=jspec,
                             mesh_shape={"model": width})
    prompts = lm_tokens(jax.random.PRNGKey(1), B, S_LEN, jc.vocab)
    logits, cache = jax.jit(sv.prefill)(deployed,
                                        sv.init_state(B, S_LEN + GEN),
                                        prompts)
    decode = jax.jit(make_decode_step(jc))
    toks, ref_logits = [jnp.argmax(logits, -1)[:, None]], [logits]
    for _ in range(GEN - 1):
        logits, cache = decode(deployed, cache, {"tokens": toks[-1]})
        toks.append(jnp.argmax(logits, -1)[:, None])
        ref_logits.append(logits)

    pnp = jax.tree_util.tree_map(np.asarray, params)
    lay = pnp["layers"]
    recurrent = jnn.is_recurrent_arch(jc)
    names = jnn.recurrent_proj_keys(jc) if recurrent else \
        [n for n in tnn.PACKED_PROJ_KEYS if n in lay]
    alpha = {n: 9.0 if n == "cv" else 3.0 for n in names} if recurrent \
        else 3.0
    x_cal, x_shards = shard_x_cal(key, {n: lay[n] for n in names}, alpha,
                                  width, _kinds(deployed["layers"], names))
    kw = dict(x_cal=x_cal, x_cal_shards=x_shards)
    if jc.n_experts:
        kw["x_cal_experts"] = _expert_x_cal(
            key, {n: lay[n] for n in tnn.PACKED_EXPERT_KEYS}, 3.0)
    mesh = Mesh([["cpu"] * width])
    tcfg = tserve.serving_config(arch, smoke=True, cim=True).replace(
        cim_mesh=mesh, **cfg_kw)
    spec = CoreSpec(n_cores=v["cores"]) if "cores" in v else None
    launches = sum(K.LAUNCHES.values())
    tparams = tnn.deploy_cim(params_from_numpy(pnp), tcfg, mode="ideal",
                             spec=spec, mesh=mesh, **kw)
    out = tserve.greedy_decode(tparams, tcfg,
                               to_torch(np.asarray(prompts)).long(), GEN,
                               torch.device("cpu"))
    return {"name": name, "width": width, "names": names, "jc": jc,
            "tcfg": tcfg, "mesh": mesh,
            "ref_tokens": np.asarray(jnp.concatenate(toks, axis=1)),
            "ref_logits": [np.asarray(x) for x in ref_logits],
            "ref": deployed, "tparams": tparams, "out": out,
            "launches": sum(K.LAUNCHES.values()) - launches}


@pytest.fixture(scope="module", params=["tp2", "tp4-dff255", "tp2-merged"])
def served(request):
    """The gemma2-9b variants; tests/test_torch_tp_archs.py runs the same
    tests on the others."""
    return _serve(request.param)


def test_partitions_match(served):
    """Each projection's TP split kind and width as the reference's: a
    'none' projection is one replicated stack of bare chips."""
    ref, ours = served["ref"]["layers"], served["tparams"]["layers"]
    for n in served["names"]:
        spl = ref[n + "_cim"]
        for layer in ours[n + "_cim"]:
            if spl.partition == "none":
                assert spl.n_shards == 1
                assert isinstance(layer, tnn.cim_api.PackedCIMLayer), n
            else:
                assert (layer.partition, layer.n_shards) == \
                    (spl.partition, served["width"]), n
    if served["name"] == "tp4-dff255":
        assert {n: ref[n + "_cim"].partition for n in served["names"]} == {
            "wq": "col", "wk": "col", "wv": "col", "wo": "row",
            "w_g": "none", "w_i": "none", "w_o": "none"}


def test_shard_chips_match(served):
    """Every layer's every shard chip: plan and index maps equal, the
    programmed tiles equal, the calibrated tensors to f32 rounding."""
    ref, ours = served["ref"]["layers"], served["tparams"]["layers"]
    for n in served["names"]:
        spl = ref[n + "_cim"]
        for li, layer in enumerate(ours[n + "_cim"]):
            chips = layer.shards if hasattr(layer, "shards") else [layer]
            for s, pcl in enumerate(chips):
                pj = jax.tree_util.tree_map(
                    lambda a: np.asarray(a)[li, s], spl.shards)
                assert_chip_match(pcl, pj, f"{n} layer {li} shard {s}")


def test_greedy_tokens_equal(served):
    assert to_numpy(served["out"].tokens).tolist() == \
        served["ref_tokens"].tolist()


def test_logits_allclose(served):
    for step, (g, want) in enumerate(zip(served["out"].logits,
                                         served["ref_logits"])):
        np.testing.assert_allclose(to_numpy(g), want, rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"token {step}")


def test_cpu_serve_launches_no_kernel(served):
    assert served["launches"] == 0


def test_chip_meter_energy_equals_reference(served):
    """Entries (rows, cols, chips = layers x shards, partition) and the
    modeled energy of the same rows equal the reference's."""
    jc = served["jc"]
    mine = ChipMeter.from_params(served["tparams"], jc.cim_in_bits,
                                 jc.cim_out_bits)
    ref = JMeter.from_params(served["ref"], jc.cim_in_bits, jc.cim_out_bits)
    for m in (mine, ref):
        for n in (16, 2, 2, 2):
            m.count_rows(n)
    assert sorted(mine.entries) == sorted(ref.entries)
    for k, e in ref.entries.items():
        f = mine.entries[k]
        assert (f.rows, f.cols, f.n_stack, f.partition) == \
            (e.rows, e.cols, e.n_stack, e.partition), k
    assert mine.energy_pj() == ref.energy_pj()
    assert mine.mvm_dispatches() == ref.mvm_dispatches()


def counts_tol(pcl, x, ccfg):
    """One ADC count per .5-boundary tile of `pcl` on input x (numpy, the
    chip's rows), per output element: where two correct f32 executions of
    the chip may decide differently."""
    x_int, scale = quantize_to_int(to_torch(x), pcl.layer.in_alpha,
                                   ccfg.in_bits)
    hits = boundary_hits(to_numpy(x_int).astype(np.float32), pcl.packed,
                         ccfg.v_read)
    lsb = float(pcl.packed.denorm_tiles.max() * pcl.layer.w_max * scale
                / (ccfg.v_read * ccfg.device.g_max))
    return hits * lsb * 1.001


@pytest.mark.parametrize("kind", ["col", "row"])
def test_loop_matches_reference_loop_under_counts_rule(served, kind):
    """Layer 0's first projection of each kind: the port's
    `sharded_packed_loop` against the reference's on the same input, each
    output within one ADC count per .5-boundary tile of each shard."""
    ref, ours = served["ref"]["layers"], served["tparams"]["layers"]
    names = [n for n in served["names"]
             if ref[n + "_cim"].partition == kind]
    n = names[0]
    spl_j = ref[n + "_cim"]
    spl0_j = jnn.ShardedPackedLayer(
        jax.tree_util.tree_map(lambda a: a[0], spl_j.shards),
        spl_j.partition, spl_j.n_shards)
    spl = ours[n + "_cim"][0]
    rows = spl.shards[0].packed.n_rows * (spl.n_shards if kind == "row"
                                          else 1)
    x = np.random.default_rng(5).standard_normal((4, rows)).astype(
        np.float32)
    jccfg = jnn.arch_cim_config(served["jc"])
    want = np.asarray(jnn.sharded_packed_loop(spl0_j, jnp.asarray(x), jccfg))
    ccfg = tnn.arch_cim_config(served["tcfg"])
    got = to_numpy(tnn.sharded_packed_loop(spl, to_torch(x), ccfg))
    tol = np.zeros_like(want)
    r = rows // spl.n_shards if kind == "row" else rows
    for s, pcl in enumerate(spl.shards):
        xs = x[:, s * r:(s + 1) * r] if kind == "row" else x
        t = counts_tol(pcl, xs, ccfg)
        if kind == "row":
            tol += t
        else:
            c = pcl.packed.n_cols
            tol[:, s * c:(s + 1) * c] += t
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol + 1e-5 * np.abs(want).max())


def test_loop_combines_shards_in_order(served):
    """Layer 0 of every sharded projection: the executor equals its
    shards' own launches, each on its slice of x, concatenated in shard
    order ('col') or added left to right from shard 0 ('row'), bit for
    bit."""
    ccfg = tnn.arch_cim_config(served["tcfg"])
    rng = np.random.default_rng(9)
    for n in served["names"]:
        spl = served["tparams"]["layers"][n + "_cim"][0]
        if not hasattr(spl, "shards"):
            continue
        r = spl.shards[0].packed.n_rows
        rows = r * (spl.n_shards if spl.partition == "row" else 1)
        x = to_torch(rng.standard_normal((3, rows)).astype(np.float32))
        parts = [tnn.cim_api.packed_forward(
            c, x[:, s * r:(s + 1) * r] if spl.partition == "row" else x,
            ccfg) for s, c in enumerate(spl.shards)]
        if spl.partition == "col":
            want = torch.cat(parts, dim=-1)
        else:
            want = parts[0]
            for part in parts[1:]:
                want = want + part
        assert torch.equal(tnn.sharded_packed_loop(spl, x, ccfg), want), n


# ------------------------------------------------- the executor's contract

@pytest.fixture(scope="module")
def deployed2():
    cfg = tserve.serving_config(GEMMA, smoke=True, cim=True).replace(
        n_layers=1)
    from repro_torch.models import transformer as tT
    params = tT.init_params(cfg, seed=0, device="cpu")
    return cfg, params, tnn.deploy_transformer_cim(
        params, cfg, mesh_shape={"model": 2})


def test_mesh_placed_deploy_serves_as_unplaced(deployed2):
    """A deploy placed on a 'model'-width-2 mesh holds the same chips and
    serves bit for bit what the same deploy without a mesh serves."""
    cfg, params, p = deployed2
    mesh = Mesh([["cpu"] * 2])
    placed = tnn.deploy_transformer_cim(params, cfg.replace(cim_mesh=mesh),
                                        mesh_shape={"model": 2})
    ccfg = tnn.arch_cim_config(cfg)
    g = torch.Generator().manual_seed(1)
    for n in ("wq", "wo"):
        spl, spm = p["layers"][n + "_cim"][0], placed["layers"][n + "_cim"][0]
        for a, b in zip(spl.shards, spm.shards):
            assert torch.equal(a.packed.gd_tiles, b.packed.gd_tiles), n
        x = torch.randn(4, spl.shards[0].packed.n_rows * (
            2 if spl.partition == "row" else 1), generator=g)
        assert torch.equal(tnn.sharded_packed_loop(spl, x, ccfg),
                           tnn.sharded_packed_loop(spm, x, ccfg)), n


def test_mesh_and_mesh_shape_width_disagreement_raises():
    mesh = Mesh([["cpu"]])
    with pytest.raises(ValueError, match="disagrees with the serving"):
        tnn._resolve_mesh(object(), mesh, {"model": 2})
    m, ms = tnn._resolve_mesh(object(), mesh, {"model": 1})
    assert m is mesh and ms["model"] == 1
    m, ms = tnn._resolve_mesh(object(), Mesh([["cpu"], ["cpu"]]), None)
    assert ms == {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="axes"):
        tnn._resolve_mesh(object(), Mesh([[["cpu"]]], ("pod", "data",
                                                       "model")), None)


def test_pool_accepts_a_model_mesh_and_refuses_a_data_mesh():
    """A 'model'-only mesh leaves the pool whole on the device; a data
    mesh stripes it (the refusal is gone): stripe r holds slots r * S/D ..
    (r + 1) * S/D - 1 in the blocks `pool_pspecs` names."""
    from repro_torch.distributed.sharding import (pool_pspecs, shard_shape,
                                                  spec_devices)
    cfg = tserve.serving_config(GEMMA, smoke=True)
    pool = S.init_pool(cfg, 2, 8, mesh=Mesh([["cpu"] * 2]), device="cpu")
    assert pool["k"].device.type == "cpu"
    mesh = Mesh([["cpu"] * 2] * 2)
    striped = S.init_pool(cfg, 4, 8, mesh=mesh)
    specs = pool_pspecs(pool)
    for k, v in striped.items():
        assert v.spec == specs[k], k
        assert len(v.shards) == 2 and all(
            s.shape == shard_shape(v.shape, v.spec, mesh.shape)
            and s.device == d
            for s, d in zip(v.shards, spec_devices(mesh, v.spec))), k


def test_in_alpha_names_checked_through_sharded_deploy():
    """Each deploy group sees a subset of the names: a valid full dict
    passes, an unknown name raises."""
    g = torch.Generator().manual_seed(0)
    stacked = {"wq": 0.1 * torch.randn(1, 64, 32, generator=g),
               "wo": 0.1 * torch.randn(1, 32, 64, generator=g),
               "w_g": 0.1 * torch.randn(1, 64, 31, generator=g)}
    alphas = {"wq": 2.0, "wo": 3.0, "w_g": 1.5}
    ccfg = CIMConfig(in_bits=4, out_bits=8)
    out = tnn._deploy_sharded_stacks(
        stacked, ccfg, mode="ideal", in_alpha=alphas,
        mesh_shape={"model": 2}, spec=None, generator=g)
    assert out["wq"][0].partition == "col" and out["wo"][0].partition == \
        "row"
    assert isinstance(out["w_g"][0], tnn.cim_api.PackedCIMLayer)
    with pytest.raises(ValueError, match="nope"):
        tnn._deploy_sharded_stacks(
            stacked, ccfg, mode="ideal", in_alpha=dict(alphas, nope=9.0),
            mesh_shape={"model": 2}, spec=None, generator=g)


def test_serve_cli_reports_tensor_parallel_width(capsys):
    """--cim-mesh on the CPU: 'auto' and 'off' give one shard (one
    device), '1x1' the same; a shape the local devices cannot fill is
    refused."""
    for flag, mesh in (("auto", "1x1"), ("off", "off"), ("1x1", "1x1")):
        out = tserve.main(["--smoke", "--cim", "--device", "cpu", "--batch",
                           "2", "--prompt-len", "6", "--gen", "2",
                           "--cim-mesh", flag])
        assert tuple(out.shape) == (2, 2)
        assert f"tp=1, mesh={mesh})" in capsys.readouterr().out
    for bad in ("1x2", "bogus"):
        with pytest.raises(SystemExit):
            tserve.main(["--smoke", "--cim", "--device", "cpu",
                         "--cim-mesh", bad])


@pytest.mark.parametrize("n_cards", [1, 2, 3, 5, 6, 7, 8, 12])
def test_auto_mesh_is_model_only(monkeypatch, n_cards):
    """'auto' on any card count factors it as the reference does
    (`mesh_shape_for`: 12 cards 3 x 4, 6 cards 3 x 2, an odd count n x
    1) over every card, and the deploy takes it."""
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as mesh_mod
    monkeypatch.setattr(mesh_mod, "local_devices", lambda kind="cuda": [
        torch.device("cpu")] * n_cards)
    m = n_cards & -n_cards
    want = {"data": n_cards // m, "model": m}
    assert jmesh.mesh_shape_for(n_cards) == want
    mesh = mesh_mod.serving_mesh()
    assert mesh.shape == want and len(mesh.flat()) == n_cards
    assert tnn._resolve_mesh(object(), mesh, None)[1] == want
