"""Port parity, the slices as a whole: gemma2-9b SMOKE served with every
dense-block projection on its compiled chip, by the JAX reference and by
the port on the CPU, from the same params, calibration batches and
prompts (batch 2, prompt 8, 4 generated tokens), on three chips: the
default 48-core chip (single-pass plans, the packed kernel), a 4-core chip
(`--cim-cores 4`: merged cores, the scheduled kernel) and an IR-drop chip
(`--cim-ir-drop 2e-7`: 47-column tiles).

The reference runs as `serve.py --cim --cim-mesh off` does
(`cfg.cim_mesh=None`): on jax 0.9 the meshed path fails its cache update
(ROADMAP queue C). Its calibration batches come from jax.random inside its
deploy, which the port cannot replay, so they are rebuilt here from the
same keys and handed to the port's deploy as `x_cal`.

Tolerance on logits, LOGIT_ATOL = 1e-4: the smoke logits are O(1) and
pass through O(100) f32 roundings taken in another order by the two
packages (2^-24 * 100 * 1.3 ~ 1e-5), with a 10x margin. No ADC count may
flip: one flipped count moves a projection output by one LSB, about 1% of
its range, far above this bound — the greedy tokens must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reference_x_cal, to_numpy, to_torch

from repro import configs as jconfigs
from repro.data import lm_tokens
from repro.launch.steps import arch_serving, make_decode_step
from repro.models import nn as jnn
from repro.models import transformer as jT
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import nn as tnn
from repro_torch.models import transformer as tT

B, S, GEN = 2, 8, 4
LOGIT_ATOL = 1e-4


CHIPS = {"default": {}, "cim_cores=4": {"cim_cores": 4},
         "cim_ir_drop=2e-7": {"cim_ir_drop": 2e-7}}


@pytest.fixture(scope="module")
def served():
    return _serve("default")


@pytest.fixture(scope="module", params=["cim_cores=4", "cim_ir_drop=2e-7"])
def served_chip(request):
    return _serve(request.param)


def _serve(chip_name):
    chip = CHIPS[chip_name]
    from repro.core.types import CoreSpec as JSpec
    cfg = jconfigs.get("gemma2-9b", smoke=True).replace(
        cim_mode="packed", dtype=jnp.float32, cim_mesh=None,
        cim_ir_drop=chip.get("cim_ir_drop", 0.0))
    sv = arch_serving(cfg)
    params = sv.init_params(jax.random.PRNGKey(0))
    spec = JSpec(n_cores=chip["cim_cores"]) if "cim_cores" in chip else None
    deployed = jnn.deploy_transformer_cim(jax.random.PRNGKey(7), params, cfg,
                                          mode="ideal", spec=spec)
    prompts = lm_tokens(jax.random.PRNGKey(1), B, S, cfg.vocab)
    prefill = jax.jit(sv.prefill)
    decode = jax.jit(make_decode_step(cfg))
    logits, cache = prefill(deployed, sv.init_state(B, S + GEN), prompts)
    toks, ref_logits = [jnp.argmax(logits, -1)[:, None]], [logits]
    for _ in range(GEN - 1):
        logits, cache = decode(deployed, cache, {"tokens": toks[-1]})
        toks.append(jnp.argmax(logits, -1)[:, None])
        ref_logits.append(logits)

    pnp = jax.tree_util.tree_map(np.asarray, params)
    stacked = {n: pnp["layers"][n] for n in tnn.PACKED_PROJ_KEYS
               if n in pnp["layers"]}
    x_cal = reference_x_cal(jax.random.PRNGKey(7), stacked, 3.0)
    launches = sum(K.LAUNCHES.values())
    res = tserve.serve_static(
        "gemma2-9b", smoke=True, batch=B, prompt_len=S, gen=GEN, cim=True,
        device="cpu", params=params_from_numpy(pnp),
        prompts=to_torch(np.asarray(prompts)).long(), x_cal=x_cal, **chip)
    return {"ref_tokens": np.asarray(jnp.concatenate(toks, axis=1)),
            "ref_logits": [np.asarray(v) for v in ref_logits],
            "ref_deployed": deployed, "res": res, "pnp": pnp,
            "launches": sum(K.LAUNCHES.values()) - launches,
            "chip": chip_name}


def test_greedy_tokens_equal(served):
    _assert_tokens_equal(served)


def test_chip_greedy_tokens_equal(served_chip):
    _assert_tokens_equal(served_chip)


def _assert_tokens_equal(served):
    assert to_numpy(served["res"].out.tokens).tolist() == \
        served["ref_tokens"].tolist()


def test_logits_allclose(served):
    _assert_logits_allclose(served)


def test_chip_logits_allclose(served_chip):
    _assert_logits_allclose(served_chip)


def _assert_logits_allclose(served):
    got = served["res"].out.logits
    assert len(got) == GEN
    for step, (g, want) in enumerate(zip(got, served["ref_logits"])):
        assert g.shape == (B, 512)
        np.testing.assert_allclose(to_numpy(g), want, rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"token {step}")


@pytest.mark.parametrize("name", ["wq", "wk", "wv", "wo", "w_g", "w_i",
                                  "w_o"])
def test_deployed_chips_match(served, name):
    """Every layer's chip for this projection: index maps equal, the
    programmed tiles equal, the calibrated tensors to f32 rounding."""
    _assert_deployed_match(served, name)


@pytest.mark.parametrize("name", ["wq", "wk", "wv", "wo", "w_g", "w_i",
                                  "w_o"])
def test_chip_deployed_chips_match(served_chip, name):
    _assert_deployed_match(served_chip, name)


def _assert_deployed_match(served, name):
    spl = served["ref_deployed"]["layers"][name + "_cim"]
    ours = served["res"].params["layers"][name + "_cim"]
    assert len(ours) == 2
    for li, pcl in enumerate(ours):
        pj = jax.tree_util.tree_map(lambda a: np.asarray(a)[li, 0],
                                    spl.shards)
        for f in ("row_block", "col_block", "tile_slot", "out_slot",
                  "out_col", "n_passes"):
            assert getattr(pcl.packed, f) == getattr(pj.packed, f), f
        np.testing.assert_array_equal(to_numpy(pcl.packed.gd_tiles),
                                      pj.packed.gd_tiles)
        for f in ("inv_norm_tiles", "v_decr_tiles", "denorm_tiles"):
            np.testing.assert_allclose(to_numpy(getattr(pcl.packed, f)),
                                       getattr(pj.packed, f), rtol=1e-5)


def test_cpu_serve_launches_no_kernel(served):
    """On the CPU every projection took the plain version: no launch."""
    assert served["launches"] == 0


def test_chip_cpu_serve_launches_no_kernel(served_chip):
    assert served_chip["launches"] == 0


def test_chips_exercise_their_routes(served, served_chip):
    """The merged chip serves a multi-pass plan (the scheduled route), the
    IR-drop chip 47-column tiles."""
    from repro_torch.kernels.cim_mvm import ops
    for s in (served, served_chip):
        layers = s["res"].params["layers"]
        names = [n for n in tnn.PACKED_PROJ_KEYS if n + "_cim" in layers]
        assert len(names) == 7
        routes = {layers[n + "_cim"][0].packed.route() for n in names}
        if s["chip"] == "cim_cores=4":
            assert "cim_mvm_scheduled" in routes
        else:
            assert routes == {"cim_mvm_packed"}
        if s["chip"] == "cim_ir_drop=2e-7":
            assert {layers[n + "_cim"][0].packed.bn
                    for n in names} == {47}


def test_lm_forward_float_path_matches():
    """The dense model without the chip (cim_mode off), teacher-forced."""
    cfg = jconfigs.get("gemma2-9b", smoke=True).replace(dtype=jnp.float32)
    params = jT.init_params(jax.random.PRNGKey(2), cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
    want = np.asarray(jax.jit(lambda p, t: jT.lm_forward(p, t, cfg))(
        params, jnp.asarray(tokens, jnp.int32)))
    tcfg = tserve.serving_config("gemma2-9b", smoke=True)
    got = tT.lm_forward(
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params)),
        to_torch(tokens).long(), tcfg)
    np.testing.assert_allclose(to_numpy(got), want, rtol=0,
                               atol=LOGIT_ATOL)


def test_params_from_numpy_keeps_layout():
    pnp = {"embed": np.ones((4, 2), np.float64),
           "layers": {"wq": np.zeros((3, 2, 5), np.float32)}}
    t = params_from_numpy(pnp)
    assert t["embed"].dtype == torch.float32
    assert tuple(t["layers"]["wq"].shape) == (3, 2, 5)


def test_serve_cli_on_cpu():
    _serve_cli([])


@pytest.mark.parametrize("flags", [["--cim-cores", "4"],
                                   ["--cim-ir-drop", "2e-7"]],
                         ids=["merged", "ir-drop"])
def test_serve_cli_on_cpu_other_chips(flags):
    _serve_cli(flags)


def _serve_cli(flags):
    out = tserve.main(["--smoke", "--cim", "--device", "cpu", "--batch",
                       "2", "--prompt-len", "6", "--gen", "3", *flags])
    assert tuple(out.shape) == (2, 3)


def test_entry_point_raises_without_cuda():
    """Without CUDA and without an explicit CPU request the entry point
    raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.serve_static(smoke=True, gen=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--smoke"])


@pytest.mark.parametrize("entry", [
    lambda cfg: tsteps.arch_serving(cfg).init_params(),
    lambda cfg: tsteps.arch_serving(cfg).init_state(2, 8),
    lambda cfg: tT.init_params(cfg),
    lambda cfg: tT.init_cache(cfg, 2, 8),
], ids=["arch_serving.init_params", "arch_serving.init_state",
        "init_params", "init_cache"])
def test_library_entry_points_raise_without_cuda(entry):
    """The model and serving-table entry points default to CUDA as the
    driver does: without CUDA and without device="cpu" they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(tserve.serving_config("gemma2-9b", smoke=True))


def test_cpu_entry_points_build_on_cpu():
    cfg = tserve.serving_config("gemma2-9b", smoke=True)
    sv = tsteps.arch_serving(cfg, "cpu")
    assert sv.init_params(0)["embed"].device.type == "cpu"
    assert sv.init_state(2, 8)["k"].device.type == "cpu"


def test_deploy_rejects_tensor_parallel_width():
    """A tensor-parallel width the serving mesh does not have is refused;
    a mesh with two data rows deploys one chip set and gives each row a
    copy of it (on one device, the same tensors)."""
    from repro_torch.launch.mesh import Mesh
    cfg = tserve.serving_config("gemma2-9b", smoke=True, cim=True)
    params = tT.init_params(cfg.replace(n_layers=1), seed=0, device="cpu")
    with pytest.raises(ValueError, match="disagrees with the serving"):
        tnn.deploy_transformer_cim(params, cfg, mesh_shape={"model": 2},
                                   mesh=Mesh([["cpu"]]))
    dp = tnn.deploy_transformer_cim(params, cfg,
                                    mesh=Mesh([["cpu"], ["cpu"]]))
    rows = dp["cim_rows"]
    assert len(rows) == 2
    for row in rows:
        assert row["entries"][("layers", "wq_cim")][0].packed.gd_tiles \
            .data_ptr() == dp["layers"]["wq_cim"][0].packed.gd_tiles \
            .data_ptr()
