"""Port parity, the whole chip compiler: `repro_torch.core.cim.compile_chip`
against `repro.core.cim.compile_chip` on the same weights and the same
explicit calibration batches — equal plans, schedules and index maps,
programmed and packed tensors to f32 rounding, served outputs within the
count rule — plus the port's chip-IR verifier on good and corrupted
artifacts."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (F32_RTOL, boundary_hits, to_numpy, to_torch)

from repro_torch.core import cim as tcim
from repro_torch.core import verify as tverify
from repro_torch.core.types import CIMConfig, CoreSpec
from repro_torch.kernels.cim_mvm import kernel as K

SHAPES = {"a": (300, 500), "b": (128, 64), "c": (200, 70)}
IN_ALPHA = 2.5
INDEX_MAPS = ("row_block", "col_block", "seq_slot", "n_passes", "tile_slot",
              "out_slot", "out_col", "bk", "bn", "n_rows", "n_cols")


@pytest.fixture(scope="module")
def chips():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import cim as jcim
    from repro.core.types import CIMConfig as JCfg, CoreSpec as JSpec
    rng = np.random.default_rng(0)
    w = {n: rng.normal(0, 0.1, s).astype(np.float32)
         for n, s in SHAPES.items()}
    x_cal = {n: (IN_ALPHA * rng.standard_normal((64, s[0]))
                 ).astype(np.float32) for n, s in SHAPES.items()}
    cj = jcim.compile_chip(jax.random.PRNGKey(3),
                           {n: jnp.asarray(v) for n, v in w.items()},
                           JCfg(), JSpec(), "ideal", in_alpha=IN_ALPHA,
                           x_cal={n: jnp.asarray(v) for n, v in x_cal.items()})
    ct = tcim.compile_chip({n: to_torch(v) for n, v in w.items()},
                           CIMConfig(), CoreSpec(), "ideal",
                           in_alpha=IN_ALPHA,
                           x_cal={n: to_torch(v) for n, v in x_cal.items()})
    x = {n: rng.normal(0, 1.2, (6, s[0])).astype(np.float32)
         for n, s in SHAPES.items()}
    y_ref = {n: np.asarray(jcim.packed_forward(cj.layers[n], jnp.asarray(v),
                                               JCfg()))
             for n, v in x.items()}
    return {"j": cj, "t": ct, "x": x, "y_ref": y_ref}


def test_plans_and_schedules_equal(chips):
    cj, ct = chips["j"], chips["t"]
    fields = ("layer", "row0", "col0", "rows", "cols", "core", "replica",
              "seq_slot")
    assert [tuple(getattr(t, f) for f in fields) for t in ct.plan.tiles] \
        == [tuple(getattr(t, f) for f in fields) for t in cj.plan.tiles]
    assert ct.schedules == {n: type(ct.schedules[n])(*dataclasses.astuple(s))
                            for n, s in cj.schedules.items()}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_packed_layers_match(chips, name):
    lj, lt = chips["j"].layers[name], chips["t"].layers[name]
    for f in INDEX_MAPS:
        assert getattr(lt.packed, f) == getattr(lj.packed, f), f
    for f in ("g_pos", "g_neg", "w_max", "in_alpha", "adc_offset"):
        np.testing.assert_array_equal(to_numpy(getattr(lt.layer, f)),
                                      np.asarray(getattr(lj.layer, f)), f)
    for f in ("norm", "v_decr"):
        np.testing.assert_allclose(to_numpy(getattr(lt.layer, f)),
                                   np.asarray(getattr(lj.layer, f)),
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_array_equal(to_numpy(lt.packed.gd_tiles),
                                  np.asarray(lj.packed.gd_tiles))
    # per-tile ADC steps are quantiles of f32 partial sums taken in another
    # order: a few roundings of the sum, then the interpolation
    for f in ("inv_norm_tiles", "v_decr_tiles", "denorm_tiles"):
        np.testing.assert_allclose(to_numpy(getattr(lt.packed, f)),
                                   np.asarray(getattr(lj.packed, f)),
                                   rtol=5 * F32_RTOL, err_msg=f)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_packed_forward_matches(chips, name):
    """Same activations through both chips: outputs agree up to one count
    per tile whose |q|/v_decr sits on a .5 boundary (times that tile's
    output LSB), plus f32 rounding of the rescale."""
    lt = chips["t"].layers[name]
    x = chips["x"][name]
    got = to_numpy(tcim.packed_forward(lt, to_torch(x), CIMConfig()))
    want = chips["y_ref"][name]
    from repro_torch.core.quant import quantize_to_int
    x_int, scale = quantize_to_int(to_torch(x), lt.layer.in_alpha, 4)
    hits = boundary_hits(to_numpy(x_int).astype(np.float32), lt.packed, 0.5)
    lsb = float(lt.packed.denorm_tiles.max() * lt.layer.w_max * scale
                / (0.5 * 40.0))
    tol = hits * lsb * 1.001 + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol)


def test_verify_chip_passes(chips):
    assert tverify.verify_chip(chips["t"]) is chips["t"]
    tverify.verify_deployed({"layers": {"a_cim": [chips["t"].layers["a"]]}})


def _mutants(p):
    """(name, invariant, mutated PackedPlan) for one artifact each."""
    rb = list(p.row_block)
    rb[1] = rb[0]
    yield "dup-block", "block-coverage", dataclasses.replace(
        p, row_block=tuple(rb))
    stale = dataclasses.replace(p)          # a corrupted kernel offset
    stale.col_start = stale.col_start.clone()
    stale.col_start[1] += 1
    yield "col-start", "col-offsets", stale
    stale = dataclasses.replace(p)
    stale.row_index = stale.row_index.clone()
    stale.row_index[0] = 1
    yield "row-index", "col-offsets", stale
    yield "gd-shape", "stack-shape", dataclasses.replace(
        p, gd_tiles=p.gd_tiles[:, :-1])
    yield "runs", "fused-runs", dataclasses.replace(
        p, out_slot=(1,) + p.out_slot[1:])
    yield "row-bounds", "index-bounds", dataclasses.replace(
        p, row_block=(99,) + p.row_block[1:])
    for name, value in (("gd-off-grid", 2.0 ** -30),
                        ("gd-too-large", 2.0 ** 24)):
        gd = p.gd_tiles.clone()
        gd[0, 0, 0] = value
        yield name, "exact-dot", dataclasses.replace(p, gd_tiles=gd)


@pytest.mark.parametrize("mutant", range(8))
def test_mutated_artifact_raises(chips, mutant):
    name, invariant, bad = list(_mutants(chips["t"].layers["a"].packed))[mutant]
    with pytest.raises(tverify.ChipVerifyError) as e:
        tverify.check_packed(bad)
    assert e.value.invariant == invariant and e.value.stage == "pack", name
    with pytest.raises(tverify.ChipVerifyError):
        tverify.verify_deployed({"layers": {"a_cim": [
            tcim.PackedCIMLayer(chips["t"].layers["a"].layer, bad)]}})


def test_shared_memory_invariant_matches_kernel_tiling(monkeypatch):
    """The verifier's shared-memory check uses the kernel's own tiling: at
    every batch the bytes fit Hopper's 232,448 (the packed and scheduled
    walk's geometry, the transposed kernel's walk over the stored tile's
    column axis, the single-matrix kernel's geometry), and a limit
    below the walk's need is reported as `shared-memory`. The chip
    compiles as a caller that leaves out `mode` gets it (relaxed)."""
    chip = tcim.compile_chip({"m": torch.randn(300, 500)}, CIMConfig(),
                             in_alpha=3.0, directions=("fwd", "bwd"))
    assert chip.mode == "relaxed"
    p = chip.layers["m"].packed
    pt = chip.bwd_layers["m"].packed
    assert pt.route() == "cim_mvm_transposed"
    for bm in (1, 4, 5, 32, 256, 4096):
        for kernel in K.KERNELS:
            if kernel == "cim_mvm":
                need = K.mvm_shared_bytes(K.mvm_geometry(
                    bm, 300, 500, occupancy=K.one_block, n_sm=K.H100_SMS),
                    300)
            elif kernel == "cim_mvm_transposed":
                # the BL->SL read of the same stack, the walk at every
                # batch: its p.bn stored columns contract into p.bk
                # outputs per forward row block
                need = K.walk_shared_bytes(K.walk_geometry(
                    bm, p.bn, p.bk, p.n_row_blocks, trans=True))
            else:
                need = K.walk_shared_bytes(K.walk_geometry(
                    bm, p.bk, p.bn, p.n_col_blocks))
            assert need <= K.SMEM_LIMIT
        tverify.check_packed(p, bm=bm)
        tverify.check_packed(pt, bm=bm)
    monkeypatch.setattr(tverify, "SMEM_LIMIT", K.walk_shared_bytes(
        K.walk_geometry(256, p.bk, p.bn, p.n_col_blocks)) - 1)
    with pytest.raises(tverify.ChipVerifyError) as e:
        tverify.check_packed(p, bm=256)
    assert e.value.invariant == "shared-memory"


def test_compile_chip_rejects_unported_modes():
    """Every programming mode of the reference compiles (relaxed and
    writeverify draw from the generator, deterministically, and pass the
    verifier's exact-dot); an unknown mode raises."""
    w = {"m": torch.randn(64, 32)}
    for mode in ("relaxed", "writeverify"):
        a = tcim.compile_chip(w, CIMConfig(), mode=mode,
                              generator=torch.Generator().manual_seed(1))
        b = tcim.compile_chip(w, CIMConfig(), mode=mode,
                              generator=torch.Generator().manual_seed(1))
        assert a.mode == mode and torch.equal(
            a.layers["m"].packed.gd_tiles, b.layers["m"].packed.gd_tiles)
    with pytest.raises(ValueError, match="mode"):
        tcim.compile_chip(w, CIMConfig(), mode="bogus")


def test_programming_mode_defaults_match_reference(monkeypatch):
    """Where a caller leaves out `mode`, the port programs the chip as the
    reference does: `program_chip`, `compile_chip` and `deploy_rbm_cim`
    take the reference's default (`inspect.signature` of both packages),
    and so does `recover --mode` (the reference's parser read by stopping
    its `main` right after it parses)."""
    import argparse
    import inspect
    pytest.importorskip("jax")
    from repro.core import cim as jcim
    from repro.launch import recover as jrecover
    from repro.models import nn as jnn
    from repro_torch.launch import recover as trecover
    from repro_torch.models import nn as tnn

    def default(fn):
        return inspect.signature(fn).parameters["mode"].default
    for ref, port in ((jcim.program_chip, tcim.program_chip),
                      (jcim.compile_chip, tcim.compile_chip),
                      (jnn.deploy_rbm_cim, tnn.deploy_rbm_cim)):
        assert default(port) == default(ref) == "relaxed", port.__name__

    class Parsed(Exception):
        pass
    parse = argparse.ArgumentParser.parse_args

    def stop_after_parse(self, args=None, namespace=None):
        raise Parsed(parse(self, args, namespace))
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        stop_after_parse)
    with pytest.raises(Parsed) as ref_args:
        jrecover.main([])
    monkeypatch.undo()
    assert trecover.parse_args([]).mode == ref_args.value.args[0].mode \
        == "relaxed"


# ------------------------------------------------- both directions, IR drop

@pytest.fixture(scope="module")
def bidir():
    """The same weights compiled by both packages with directions=("fwd",
    "bwd") from explicit calibration batches in each direction's input
    space, and an IR-drop chip (alpha 2e-7: 47-column tiles)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import cim as jcim
    from repro.core.types import (CIMConfig as JCfg, CoreSpec as JSpec,
                                  NonIdealityConfig as JNI)
    from repro_torch.core.types import NonIdealityConfig
    rng = np.random.default_rng(2)
    w = {n: rng.normal(0, 0.1, s).astype(np.float32)
         for n, s in SHAPES.items()}
    x_cal = {n: (IN_ALPHA * rng.standard_normal((64, s[0]))
                 ).astype(np.float32) for n, s in SHAPES.items()}
    x_bwd = {n: (1.5 * rng.standard_normal((64, s[1]))).astype(np.float32)
             for n, s in SHAPES.items()}
    jw = {n: jnp.asarray(v) for n, v in w.items()}
    tw = {n: to_torch(v) for n, v in w.items()}
    kw_j = dict(in_alpha=IN_ALPHA,
                x_cal={n: jnp.asarray(v) for n, v in x_cal.items()})
    kw_t = dict(in_alpha=IN_ALPHA,
                x_cal={n: to_torch(v) for n, v in x_cal.items()})
    cj = jcim.compile_chip(
        jax.random.PRNGKey(3), jw, JCfg(), JSpec(n_cores=5), "ideal",
        directions=("fwd", "bwd"), in_alpha_bwd=1.5,
        x_cal_bwd={n: jnp.asarray(v) for n, v in x_bwd.items()}, **kw_j)
    ct = tcim.compile_chip(
        tw, CIMConfig(), CoreSpec(n_cores=5), "ideal",
        directions=("fwd", "bwd"), in_alpha_bwd=1.5,
        x_cal_bwd={n: to_torch(v) for n, v in x_bwd.items()}, **kw_t)
    alpha = 2e-7
    ij = jcim.compile_chip(jax.random.PRNGKey(3), jw,
                           JCfg(nonideal=JNI(ir_drop_alpha=alpha)), JSpec(),
                           "ideal", **kw_j)
    it = tcim.compile_chip(tw, CIMConfig(nonideal=NonIdealityConfig(
        ir_drop_alpha=alpha)), CoreSpec(), "ideal", **kw_t)
    return {"j": cj, "t": ct, "ir_j": ij, "ir_t": it}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_bidirectional_chip_matches(bidir, name):
    """Both directions of a merged-core chip: index maps equal, the bwd
    pack sharing the fwd stack, per-tile bwd ADC steps and per-row
    tensors to f32 rounding."""
    for d in ("fwd", "bwd"):
        lj = bidir["j"].layers_for(d)[name]
        lt = bidir["t"].layers_for(d)[name]
        for f in INDEX_MAPS + ("transpose",):
            assert getattr(lt.packed, f) == getattr(lj.packed, f), (d, f)
        for f in ("inv_norm_tiles", "v_decr_tiles", "denorm_tiles"):
            np.testing.assert_allclose(to_numpy(getattr(lt.packed, f)),
                                       np.asarray(getattr(lj.packed, f)),
                                       rtol=5 * F32_RTOL, err_msg=(d, f))
    assert bidir["t"].bwd_layers[name].packed.gd_tiles \
        is bidir["t"].layers[name].packed.gd_tiles
    assert any(p.packed.n_passes > 1 for p in bidir["t"].layers.values())


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_ir_drop_chip_matches(bidir, name):
    """An IR-drop chip: the same 47-column plans, and the whole-matrix
    calibration through the oracle's droop (`calibrate_layer`) equal to
    the reference's v_decr to f32 rounding."""
    lj, lt = bidir["ir_j"].layers[name], bidir["ir_t"].layers[name]
    assert lt.packed.bn == lj.packed.bn <= 47
    for f in INDEX_MAPS:
        assert getattr(lt.packed, f) == getattr(lj.packed, f), f
    np.testing.assert_allclose(float(lt.layer.v_decr), float(lj.layer.v_decr),
                               rtol=1e-5)
    np.testing.assert_allclose(to_numpy(lt.packed.v_decr_tiles),
                               np.asarray(lj.packed.v_decr_tiles),
                               rtol=5 * F32_RTOL)


def test_ir_drop_oracle_droop_matches():
    """`cim_mvm_ref` with IR drop: the droop scales every row's drive by
    clip(1 - alpha * |x| @ gtot_row, 0.7, 1); charges to f32 rounding."""
    import jax.numpy as jnp
    from repro.core.types import CIMConfig as JCfg, NonIdealityConfig as JNI
    from repro.kernels.cim_mvm.ref import cim_mvm_ref as jref
    from repro_torch.core.types import NonIdealityConfig
    from repro_torch.kernels.cim_mvm.ref import cim_mvm_ref as tref
    rng = np.random.default_rng(3)
    gp = rng.uniform(1, 40, (128, 60)).astype(np.float32)
    gn = rng.uniform(1, 40, (128, 60)).astype(np.float32)
    x = rng.integers(-7, 8, (16, 128)).astype(np.int32)
    for alpha in (1e-6, 1e-4):            # partial droop, and the 0.7 clip
        qj = np.asarray(jref(jnp.asarray(x), jnp.asarray(gp), jnp.asarray(gn),
                             1.0, JCfg(nonideal=JNI(ir_drop_alpha=alpha)),
                             bit_serial=False).q_analog)
        qt = to_numpy(tref(to_torch(x), to_torch(gp), to_torch(gn), 1.0,
                           CIMConfig(nonideal=NonIdealityConfig(
                               ir_drop_alpha=alpha))).q_analog)
        np.testing.assert_allclose(qt, qj, rtol=1e-5,
                                   atol=1e-6 * np.abs(qj).max())


def test_stochastic_calibration_reads_charge_only():
    """A stochastic layer calibrates on the charge alone: `calibrate_layer`
    gives the reference's v_decr, while the oracle itself refuses the
    stochastic neuron, whose noise stream (jax.random) is not ported."""
    import jax
    import jax.numpy as jnp
    from repro.core.calibration import calibrate_layer as jcal
    from repro.core.types import CIMConfig as JCfg
    from repro_torch.core.calibration import calibrate_layer as tcal
    from repro_torch.kernels.cim_mvm.ref import cim_mvm_ref as tref
    rng = np.random.default_rng(4)
    gp = rng.uniform(1, 40, (128, 60)).astype(np.float32)
    gn = rng.uniform(1, 40, (128, 60)).astype(np.float32)
    x = rng.integers(-7, 8, (32, 128)).astype(np.int32)
    vj = jcal(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(gp),
              jnp.asarray(gn), JCfg(activation="stochastic")).v_decr
    cfg = CIMConfig(activation="stochastic")
    vt = tcal(to_torch(x), to_torch(gp), to_torch(gn), cfg).v_decr
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="stochastic"):
        tref(to_torch(x), to_torch(gp), to_torch(gn), 1.0, cfg)


def _bwd_mutants(chip):
    """(name, invariant, mutated chip) for the transpose direction."""
    name = "a"
    bwd = chip.bwd_layers[name]
    copy = dataclasses.replace(bwd.packed,
                               gd_tiles=bwd.packed.gd_tiles.clone())
    yield "own-stack", "shared-stack", dataclasses.replace(
        chip, bwd_layers={**chip.bwd_layers,
                          name: tcim.PackedCIMLayer(bwd.layer, copy)})
    ts = list(bwd.packed.tile_slot)
    ts[0], ts[1] = ts[1], ts[0]
    swapped = dataclasses.replace(bwd.packed, tile_slot=tuple(ts))
    yield "tile-slot", "direction-agreement", dataclasses.replace(
        chip, bwd_layers={**chip.bwd_layers,
                          name: tcim.PackedCIMLayer(bwd.layer, swapped)})
    stale = dataclasses.replace(bwd.packed)
    stale.col_runs = stale.col_runs.flip(0)
    yield "run-table", "run-offsets", dataclasses.replace(
        chip, bwd_layers={**chip.bwd_layers,
                          name: tcim.PackedCIMLayer(bwd.layer, stale)})
    yield "missing", "direction-keys", dataclasses.replace(
        chip, bwd_layers={n: p for n, p in chip.bwd_layers.items()
                          if n != name})


@pytest.mark.parametrize("mutant", range(4))
def test_mutated_bwd_artifact_raises(bidir, mutant):
    name, invariant, bad = list(_bwd_mutants(bidir["t"]))[mutant]
    with pytest.raises(tverify.ChipVerifyError) as e:
        tverify.verify_chip(bad)
    assert e.value.invariant == invariant, name
