"""Port parity, core: configs, quantization, conductance encoding, the
plain datapath model and calibration of `repro_torch.core` against
`repro.core` on the same numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32_RTOL, to_numpy, to_torch

import repro.core.calibration as jcal
import repro.core.conductance as jcond
import repro.core.mapping as jmap
import repro.core.quant as jquant
import repro.core.types as jtypes
import repro.kernels.cim_mvm.ref as jref
import repro_torch.core.calibration as tcal
import repro_torch.core.conductance as tcond
import repro_torch.core.mapping as tmap
import repro_torch.core.quant as tquant
import repro_torch.core.types as ttypes
import repro_torch.kernels.cim_mvm.ref as tref

ACTS = ("none", "relu", "tanh", "sigmoid")


# ------------------------------------------------------------------ types

@pytest.mark.parametrize("bits", range(1, 9))
def test_cim_config_levels_match(bits):
    j = jtypes.CIMConfig(in_bits=bits, out_bits=bits)
    t = ttypes.CIMConfig(in_bits=bits, out_bits=bits)
    assert (t.in_max, t.in_mag_bits, t.out_mag_levels) == \
        (j.in_max, j.in_mag_bits, j.out_mag_levels)


@pytest.mark.parametrize("field,value", [("in_bits", 0), ("in_bits", 9),
                                         ("out_bits", 0), ("out_bits", 9)])
def test_cim_config_rejects_out_of_range(field, value):
    with pytest.raises(ValueError):
        jtypes.CIMConfig(**{field: value})
    with pytest.raises(ValueError):
        ttypes.CIMConfig(**{field: value})


@pytest.mark.parametrize("name", ["DeviceConfig", "NonIdealityConfig",
                                  "CoreSpec", "CIMConfig"])
def test_config_defaults_match(name):
    """Every field the port keeps has the reference's default."""
    j, t = getattr(jtypes, name)(), getattr(ttypes, name)()
    for f in dataclasses.fields(t):
        want = getattr(j, f.name)
        got = getattr(t, f.name)
        if dataclasses.is_dataclass(got):
            assert all(getattr(got, g.name) == getattr(want, g.name)
                       for g in dataclasses.fields(got)), f.name
        else:
            assert got == want, f.name


# ------------------------------------------------------------------ quant

@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_to_int_matches_with_exact_ties(bits, signed):
    """Random values plus values exactly on .5 ties of the grid: both
    packages round half to even, to the same integers."""
    rng = np.random.default_rng(bits)
    n = max((1 << (bits - 1)) - 1, 1) if signed else (1 << bits) - 1
    alpha = np.float32(n * 0.25)               # scale = alpha / n = 0.25
    ties = (np.arange(-n - 1, n + 1) + 0.5).astype(np.float32) * 0.25
    x = np.concatenate([rng.normal(0, float(alpha), 500).astype(np.float32),
                        ties])
    xj, sj = jquant.quantize_to_int(jnp.asarray(x), alpha, bits, signed)
    xt, st = tquant.quantize_to_int(to_torch(x), float(alpha), bits, signed)
    np.testing.assert_array_equal(to_numpy(xt), np.asarray(xj))
    assert float(st) == float(sj) == 0.25
    lo = -n if signed else 0
    want_ties = np.clip(np.round(ties / np.float32(0.25)), lo, n)
    np.testing.assert_array_equal(to_numpy(xt)[-len(ties):], want_ties)


@pytest.mark.parametrize("signed", [True, False])
def test_pact_quantize_matches(signed):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, 400).astype(np.float32)
    for bits in (1, 3, 4):
        yj = jquant.pact_quantize(jnp.asarray(x), 2.5, bits, signed)
        yt = tquant.pact_quantize(to_torch(x), 2.5, bits, signed)
        np.testing.assert_allclose(to_numpy(yt), np.asarray(yj),
                                   rtol=F32_RTOL, atol=1e-6)


def test_int_bit_planes_match():
    x = np.arange(-7, 8, dtype=np.int32)
    pj = jquant.int_bit_planes(jnp.asarray(x), 3)
    pt = tquant.int_bit_planes(to_torch(x), 3)
    np.testing.assert_array_equal(to_numpy(pt), np.asarray(pj))


# ------------------------------------------------------------ conductance

def test_weights_to_conductances_match():
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.1, (300, 200)).astype(np.float32)
    cj = jcond.weights_to_conductances(jnp.asarray(w), jtypes.DeviceConfig())
    ct = tcond.weights_to_conductances(to_torch(w), ttypes.DeviceConfig())
    for f in ("g_pos", "g_neg", "w_max"):
        np.testing.assert_array_equal(to_numpy(getattr(ct, f)),
                                      np.asarray(getattr(cj, f)))
    np.testing.assert_allclose(to_numpy(ct.norm), np.asarray(cj.norm),
                               rtol=F32_RTOL)


# ------------------------------------------------------- datapath model

def _q_with_boundaries(rng, n=2000, vd=0.01):
    """Charges at random plus charges a hair off .5 count boundaries."""
    q = rng.normal(0, 0.3, n).astype(np.float32)
    k = rng.integers(-200, 200, 200)
    edge = ((k + 0.5) * vd).astype(np.float32)
    return np.concatenate([q, edge, np.nextafter(edge, np.float32(1)),
                           np.zeros(3, np.float32)])


@pytest.mark.parametrize("activation", ACTS)
def test_adc_convert_matches(activation):
    """Same charges in, same counts out — every activation, including
    charges on and next to the .5 boundaries."""
    rng = np.random.default_rng(5)
    q = _q_with_boundaries(rng)
    cj = jref.adc_convert(jnp.asarray(q),
                          jtypes.CIMConfig(activation=activation), 0.01)
    ct = tref.adc_convert(to_torch(q),
                          ttypes.CIMConfig(activation=activation), 0.01)
    np.testing.assert_array_equal(to_numpy(ct), np.asarray(cj))


def test_pwl_tanh_counts_match():
    steps = np.arange(0, 4 * 127 + 1, dtype=np.float32)
    for n_max in (1, 7, 63, 127):
        np.testing.assert_array_equal(
            to_numpy(tref.pwl_tanh_counts(to_torch(steps), n_max)),
            np.asarray(jref.pwl_tanh_counts(jnp.asarray(steps), n_max)))


def _layer(rng, r=260, c=90):
    w = rng.normal(0, 0.1, (r, c)).astype(np.float32)
    x = rng.integers(-7, 8, (48, r)).astype(np.int32)
    cj = jcond.weights_to_conductances(jnp.asarray(w), jtypes.DeviceConfig())
    return w, x, np.asarray(cj.g_pos), np.asarray(cj.g_neg)


def test_cim_mvm_ref_matches():
    """The algebraic (bit_serial=False) oracle: charges to f32 rounding,
    counts equal except where the charge sits on a .5 boundary."""
    rng = np.random.default_rng(6)
    _, x, gp, gn = _layer(rng)
    vd = 0.004
    oj = jref.cim_mvm_ref(jnp.asarray(x), jnp.asarray(gp), jnp.asarray(gn),
                          vd, jtypes.CIMConfig(), bit_serial=False)
    ot = tref.cim_mvm_ref(to_torch(x), to_torch(gp), to_torch(gn), vd,
                          ttypes.CIMConfig(), bit_serial=False)
    qj = np.asarray(oj.q_analog)
    np.testing.assert_allclose(to_numpy(ot.q_analog), qj, rtol=1e-5,
                               atol=1e-6 * np.abs(qj).max())
    v = np.abs(qj.astype(np.float64)) / vd
    near = np.abs(v - (np.floor(v) + 0.5)) < 1e-4 * np.maximum(v, 1)
    cj, ct = np.asarray(oj.counts), to_numpy(ot.counts)
    np.testing.assert_array_equal(ct[~near], cj[~near])
    assert np.all(np.abs(ct - cj) <= 1)


def test_dequantize_output_matches():
    rng = np.random.default_rng(7)
    counts = rng.integers(-127, 128, (8, 40)).astype(np.int32)
    norm = rng.uniform(100, 200, 40).astype(np.float32)
    for act in ("none", "tanh"):
        yj = jref.dequantize_output(jnp.asarray(counts), 0.01,
                                    jnp.asarray(norm), 0.3, 0.5,
                                    jtypes.CIMConfig(activation=act))
        yt = tref.dequantize_output(to_torch(counts), 0.01, to_torch(norm),
                                    0.3, 0.5, ttypes.CIMConfig(activation=act))
        np.testing.assert_allclose(to_numpy(yt), np.asarray(yj),
                                   rtol=F32_RTOL)


# ------------------------------------------------------------ calibration

@pytest.mark.parametrize("n", [1, 2, 999, 1000, 64 * 256])
def test_calibrate_v_decr_matches(n):
    rng = np.random.default_rng(n)
    q = rng.normal(0, 0.2, n).astype(np.float32)
    vj = jcal.calibrate_v_decr(jnp.asarray(q), jtypes.CIMConfig())
    vt = tcal.calibrate_v_decr(to_torch(q), ttypes.CIMConfig())
    np.testing.assert_allclose(float(vt), float(vj), rtol=F32_RTOL)


def test_quantile_linear_ragged_rows_match_jnp():
    """The batched sort-and-interpolate quantile with a valid count per
    row (the per-tile calibration of ragged tiles) equals jnp.quantile
    taken row by row over the valid entries."""
    rng = np.random.default_rng(8)
    a = rng.normal(0, 1, (5, 700)).astype(np.float32)
    n_valid = np.array([700, 699, 64, 3, 1])
    padded = a.copy()
    for i, n in enumerate(n_valid):
        padded[i, n:] = np.inf
    got = tcal.quantile_linear(to_torch(padded), 0.999, to_torch(n_valid))
    for i, n in enumerate(n_valid):
        want = float(jnp.quantile(jnp.asarray(a[i, :n]), 0.999))
        np.testing.assert_allclose(float(got[i]), want, rtol=F32_RTOL)


def test_tile_partial_sums_match():
    rng = np.random.default_rng(9)
    _, x, gp, gn = _layer(rng, 300, 500)
    tiles = jmap.plan_layers([jmap.MatrixReq("m", 300, 500)]).tiles_for("m")
    cfg_j, cfg_t = jtypes.CIMConfig(), ttypes.CIMConfig()
    for jt in tiles:
        tt = tmap.Tile(**{f: getattr(jt, f) for f in
                          ("layer", "row0", "col0", "rows", "cols")})
        qj = np.asarray(jcal.tile_partial_sums(
            jnp.asarray(x), jnp.asarray(gp), jnp.asarray(gn), jt, cfg_j))
        qt = to_numpy(tcal.tile_partial_sums(
            to_torch(x), to_torch(gp), to_torch(gn), tt, cfg_t))
        np.testing.assert_allclose(qt, qj, rtol=1e-5,
                                   atol=1e-6 * np.abs(qj).max())


def test_calibrate_layer_matches():
    rng = np.random.default_rng(10)
    _, x, gp, gn = _layer(rng)
    cj = jcal.calibrate_layer(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(gp), jnp.asarray(gn),
                              jtypes.CIMConfig())
    ct = tcal.calibrate_layer(to_torch(x), to_torch(gp), to_torch(gn),
                              ttypes.CIMConfig())
    np.testing.assert_allclose(float(ct.v_decr), float(cj.v_decr),
                               rtol=1e-5)
    np.testing.assert_array_equal(to_numpy(ct.adc_offset),
                                  np.asarray(cj.adc_offset))
