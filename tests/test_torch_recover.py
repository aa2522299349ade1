"""Port parity, the Bayesian image-recovery path: the RBM compiled onto one
bidirectional chip by `repro_torch.models.nn.deploy_rbm_cim` against
`repro.models.nn.deploy_rbm_cim` from the same params and calibration
visibles (numpy), with and without the pixel-interleaved mapping — equal
plans, index maps and permutations, packed tensors to f32 rounding — and
one Gibbs cycle's forward and transpose-direction launches under the
counts rule; then the port's own recover entry point through its smoke gate.

Tolerances: the calibrated per-tile ADC steps are quantiles of f32
partial sums taken in another order (5 * F32_RTOL, as the forward chip
tests). Served outputs agree up to one count per tile whose |q|/v_decr
sits on a .5 boundary (times that tile's output LSB), and stochastic bits
except where q plus the noise sits within rounding of 0; both sets are
computed from the inputs.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_parity import (F32_RTOL, assert_counts_match, boundary_hits,
                           to_numpy, to_torch)

from repro_torch.core import cim as tcim
from repro_torch.core.types import CIMConfig
from repro_torch.launch import recover as trecover
from repro_torch.models import nn as tnn
from repro_torch.models import rbm as trbm

PIX, LAB, HID, B = 128, 10, 32, 12
N_VIS = PIX + LAB
INDEX_MAPS = ("row_block", "col_block", "seq_slot", "n_passes", "transpose",
              "tile_slot", "out_slot", "out_col", "bk", "bn", "n_rows",
              "n_cols")
SEED = 5


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain-map", "interleave"])
def deployed(request):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import cim as jcim
    from repro.core.types import CIMConfig as JCfg
    from repro.models import nn as jnn
    interleave = request.param
    rng = np.random.default_rng(4)
    params = {"w": rng.normal(0, 0.3, (N_VIS, HID)).astype(np.float32),
              "a": rng.normal(0, 0.2, N_VIS).astype(np.float32),
              "b": rng.normal(0, 0.2, HID).astype(np.float32)}
    v_cal = (rng.uniform(size=(64, N_VIS)) < 0.4).astype(np.float32)
    cj = jnn.deploy_rbm_cim(jax.random.PRNGKey(3),
                            {k: jnp.asarray(v) for k, v in params.items()},
                            JCfg(in_bits=2), jnp.asarray(v_cal),
                            mode="ideal", interleave=interleave)
    ct = tnn.deploy_rbm_cim({k: to_torch(v) for k, v in params.items()},
                            CIMConfig(in_bits=2), to_torch(v_cal),
                            mode="ideal", interleave=interleave)
    # one Gibbs cycle's launches, driven by the same visibles and hiddens
    v = (rng.uniform(size=(B, N_VIS)) < 0.5).astype(np.float32)
    h = (rng.uniform(size=(B, HID)) < 0.5).astype(np.float32)
    x_f = np.concatenate([v, np.ones((B, 1), np.float32)], 1)
    x_f = np.pad(x_f, ((0, 0), (0, ct.n_pad - x_f.shape[1])))
    if ct.perm is not None:
        x_f = x_f[:, to_numpy(ct.perm)]
    x_b = np.concatenate([h, np.ones((B, 1), np.float32)], 1)
    jfwd, jbwd = cj.chip.layers["rbm"], cj.chip.layers_for("bwd")["rbm"]
    cfg_st = JCfg(in_bits=2, activation="stochastic")
    outs = {
        "fwd": np.asarray(jcim.packed_forward(jfwd, jnp.asarray(x_f),
                                              JCfg(in_bits=2), seed=SEED)),
        "bwd": np.asarray(jcim.packed_forward(jbwd, jnp.asarray(x_b),
                                              JCfg(in_bits=2), seed=SEED)),
        "bwd-stochastic": np.asarray(jcim.packed_forward(
            jbwd, jnp.asarray(x_b), cfg_st, seed=SEED))}
    return {"j": cj, "t": ct, "x": {"fwd": x_f, "bwd": x_b}, "outs": outs}


def test_deploy_geometry_and_permutation_equal(deployed):
    cj, ct = deployed["j"], deployed["t"]
    assert (ct.n_vis, ct.n_hid, ct.n_pad) == (cj.n_vis, cj.n_hid, cj.n_pad)
    for f in ("perm", "inv_perm"):
        want = getattr(cj, f)
        got = getattr(ct, f)
        assert (got is None) == (want is None), f
        if want is not None:
            assert to_numpy(got).tolist() == np.asarray(want).tolist(), f
    fields = ("layer", "row0", "col0", "rows", "cols", "core", "replica",
              "seq_slot")
    assert [tuple(getattr(t, f) for f in fields) for t in ct.chip.plan.tiles] \
        == [tuple(getattr(t, f) for f in fields) for t in cj.chip.plan.tiles]
    assert ct.chip.directions == ("fwd", "bwd")


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_deployed_packs_match(deployed, direction):
    lj = deployed["j"].chip.layers_for(direction)["rbm"]
    lt = deployed["t"].chip.layers_for(direction)["rbm"]
    for f in INDEX_MAPS:
        assert getattr(lt.packed, f) == getattr(lj.packed, f), f
    np.testing.assert_array_equal(to_numpy(lt.packed.gd_tiles),
                                  np.asarray(lj.packed.gd_tiles))
    for f in ("inv_norm_tiles", "v_decr_tiles", "denorm_tiles"):
        np.testing.assert_allclose(to_numpy(getattr(lt.packed, f)),
                                   np.asarray(getattr(lj.packed, f)),
                                   rtol=5 * F32_RTOL, err_msg=f)
    for f in ("norm", "v_decr", "in_alpha"):
        np.testing.assert_allclose(to_numpy(getattr(lt.layer, f)),
                                   np.asarray(getattr(lj.layer, f)),
                                   rtol=5 * F32_RTOL, err_msg=f)
    fwd_t = deployed["t"].chip.layers["rbm"].packed
    assert lt.packed.gd_tiles is fwd_t.gd_tiles     # one programmed array


@pytest.mark.parametrize("which", ["fwd", "bwd", "bwd-stochastic"])
def test_gibbs_cycle_launches_match(deployed, which):
    """The v->h launch (packed kernel) and the h->v launch (transposed
    kernel, digital and stochastic) on the same inputs: counts rule."""
    direction = which.split("-")[0]
    cfg = CIMConfig(in_bits=2, activation="stochastic"
                    if which.endswith("stochastic") else "none")
    pcl = deployed["t"].chip.layers_for(direction)["rbm"]
    x = deployed["x"][direction]
    got = to_numpy(tcim.packed_forward(pcl, to_torch(x), cfg, seed=SEED))
    want = deployed["outs"][which]
    # binary inputs at 2 bits with clip 1: x_int = x, scale 1
    hits = boundary_hits(x, pcl.packed, 0.5, cfg.activation, SEED)
    if cfg.activation == "stochastic":
        assert_counts_match(got, want, hits)
        return
    lsb = float(pcl.packed.denorm_tiles.max() * pcl.layer.w_max
                / (0.5 * 40.0))
    tol = hits * lsb * 1.001 + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol)


def test_stochastic_guard_refuses_split_inputs(deployed):
    """Comparator bits cannot be summed across input splits: the forward
    direction (138 visibles in two row blocks) refuses stochastic."""
    pcl = deployed["t"].chip.layers["rbm"]
    assert pcl.packed.n_row_blocks > 1
    with pytest.raises(ValueError, match="input splits"):
        tcim.packed_forward(pcl, to_torch(deployed["x"]["fwd"]),
                            CIMConfig(in_bits=2, activation="stochastic"))


def test_mutated_bwd_artifact_raises(deployed):
    """check_directions over the deployed chip: a transpose pack with its
    own copy of the conductance stack is refused."""
    from repro_torch.core import verify as tverify
    chip = deployed["t"].chip
    bwd = chip.bwd_layers["rbm"]
    copy = dataclasses.replace(bwd.packed,
                               gd_tiles=bwd.packed.gd_tiles.clone())
    bad = dataclasses.replace(chip, bwd_layers={
        "rbm": tcim.PackedCIMLayer(bwd.layer, copy)})
    with pytest.raises(tverify.ChipVerifyError) as e:
        tverify.verify_deployed(dataclasses.replace(deployed["t"], chip=bad))
    assert e.value.invariant == "shared-stack"


@pytest.mark.parametrize("flags", [[], ["--stochastic"], ["--interleave"]],
                         ids=["digital", "stochastic", "interleave"])
def test_recover_smoke_clears_gate(flags):
    """The port's recover entry point end to end on the CPU (plain versions of
    both kernels): at least a 50% L2-error reduction, as the reference's
    smoke gate demands."""
    assert trecover.main(["--smoke", "--device", "cpu", *flags]) >= 0.5


def test_plain_rerun_is_bitwise_equal():
    """Two Gibbs runs from the same generator seeds give the same
    trajectory (the chip-smoke rerun's premise)."""
    args = trecover.parse_args(["--smoke", "--device", "cpu",
                                "--train-steps", "50", "--cycles", "3"])
    setup = trecover.build(args, torch.device("cpu"))
    a = trecover.recover(setup, args)
    b = trecover.recover(setup, args, impl="plain")
    assert a.shape == (3, args.batch, N_VIS) and torch.equal(a, b)


def test_recover_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        trecover.main(["--smoke"])


def test_unported_programming_modes_raise():
    """relaxed and writeverify programming run (the smoke task's L2 check
    is not asked of a 20-step chip); a mode the reference does not have
    is refused."""
    for mode in ("relaxed", "writeverify"):
        args = trecover.parse_args(["--smoke", "--device", "cpu",
                                    "--train-steps", "20", "--cycles", "2",
                                    "--mode", mode])
        setup = trecover.build(args, torch.device("cpu"))
        assert setup.crbm.chip.mode == mode
        traj = trecover.recover(setup, args)
        assert bool(torch.isfinite(traj).all())
    with pytest.raises(SystemExit):
        trecover.parse_args(["--mode", "bogus"])


def test_software_gibbs_recover_shapes():
    gen = torch.Generator().manual_seed(0)
    params = trbm.init(gen, n_vis=20, n_hid=6)
    v = torch.bernoulli(torch.full((3, 20), 0.5), generator=gen)
    pv = trbm.gibbs_recover(gen, params, v, v > 0, n_cycles=2)
    assert pv.shape == (3, 20) and bool(((pv >= 0) & (pv <= 1)).all())


def test_recover_meter_matches_reference(deployed):
    """The recover entry point's per-direction meters (`meter_run`: batch
    x cycles rows each way) against the reference's ChipMeter on the
    reference's chip compiled from the same params: the same entries, the
    same pJ per MVM, TOPS/W and dispatches, the same export."""
    from repro.obs import MetricsRegistry as JRegistry
    from repro.obs.chipmeter import ChipMeter as JChipMeter
    from repro_torch.obs import MetricsRegistry
    args = trecover.parse_args(["--smoke", "--device", "cpu", "--batch",
                                str(B), "--cycles", "10"])
    got = trecover.meter_run(trecover.Setup(deployed["t"], None, None, None,
                                            0.0, 0.0), args)
    want = JChipMeter.from_chip(deployed["j"].chip, name="rbm")
    for d in ("fwd", "bwd"):
        want.count_rows(B * 10, direction=d)
    assert sorted(got.entries) == sorted(want.entries) == [
        ("rbm/rbm", "bwd"), ("rbm/rbm", "fwd")]
    for key in want.entries:
        cg, cw = got.entries[key].cost, want.entries[key].cost
        assert (cg.macs, cg.energy_pj, cg.latency_ns) == (
            cw.macs, cw.energy_pj, cw.latency_ns), key
        assert got.mvm_dispatches(*key) == want.mvm_dispatches(*key) \
            == B * 10
    assert got.energy_pj() == want.energy_pj() > 0
    rt, rj = MetricsRegistry(), JRegistry()
    got.export(rt)
    want.export(rj)
    assert json.loads(rt.to_json()) == json.loads(rj.to_json())


def test_recover_energy_lines_and_metrics_out(tmp_path, capsys):
    """recover prints the per-direction energy lines and writes
    --metrics-out: per direction pJ / MVM x dispatches = energy (positive,
    finite, batch x cycles dispatches) equal to the printed lines, and
    the Gibbs run's latency histogram."""
    path = tmp_path / "m.json"
    trecover.main(["--smoke", "--device", "cpu", "--train-steps", "50",
                   "--cycles", "3", "--batch", "8", "--metrics-out",
                   str(path)])
    out = capsys.readouterr().out
    doc = json.loads(path.read_text())
    vals = {(g["name"], g["labels"]["direction"]): g["value"]
            for g in doc["gauges"] + doc["counters"]}
    printed = out.split("energy/MVM: ")[1].splitlines()[0]
    for d, tag in (("fwd", "fwd (v->h, SL->BL)"),
                   ("bwd", "bwd (h->v, BL->SL)")):
        pj = vals[("chip_pj_per_mvm", d)]
        assert vals[("chip_mvm_dispatches", d)] == 8 * 3
        assert np.isfinite(pj) and pj > 0
        assert vals[("chip_energy_pj", d)] == pj * 24
        assert f"{tag} {pj:.0f} pJ @ " \
            f"{vals[('chip_tops_per_w', d)]:.1f} TOPS/W" in printed
    total = vals[("chip_energy_pj", "fwd")] + vals[("chip_energy_pj", "bwd")]
    assert f"batch of 8: {total / 1e6:.3f} uJ modeled" in out
    hist = [h for h in doc["histograms"] if h["name"] == "recover_gibbs_run_s"]
    assert len(hist) == 1 and hist[0]["count"] == 1
