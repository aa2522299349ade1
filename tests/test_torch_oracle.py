"""Port parity, the bit-serial oracle (`kernels/cim_mvm/ref.py`) and what
reaches it: the per-phase non-idealities, the ADC offsets of
calibration, the read-voltage search, and `core.cim.forward`'s route to
the oracle (the reference's `_needs_ref`), against the JAX reference.

Rules. Deterministic configurations (IR drop, wire R, a given offset)
run on the same numpy inputs in both packages: the charge `q_analog`
within F32_RTOL of the reference's (relative to its largest, as a sum of
terms in another order), counts equal except where the reference's
|q| / v_decr lies within rounding of a .5 boundary (one count there, the
counts rule of `tests/_torch_parity.py`). Draws (coupling noise, the
offset spread, the stochastic neuron) come from a jax.random key in one
package and a torch.Generator in the other: they are held by their
statistics against the same statistics of the reference, and to one
result per generator state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32_RTOL, to_numpy, to_torch

import repro.core.calibration as jcal
import repro.core.cim as jcim
import repro.core.conductance as jcond
import repro.core.types as jtypes
import repro.kernels.cim_mvm.ref as jref
import repro.models.nn as jnn
import repro_torch.core.calibration as tcal
import repro_torch.core.cim as tcim
import repro_torch.core.noise as tnoise
import repro_torch.core.types as ttypes
import repro_torch.kernels.cim_mvm.ref as tref
from repro_torch.convert import chip_states_from_numpy, layer_from_numpy
from repro_torch.core.quant import quantize_to_int
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.models import nn as tnn

# (name, NonIdealityConfig fields, given offset): the deterministic
# configurations, the Fig. 3f chip's IR drop with a given offset among them
DETERMINISTIC = [
    ("ideal", {}, False),
    ("ir-drop", {"ir_drop_alpha": 4e-5}, False),
    ("ir-drop-clip", {"ir_drop_alpha": 1e-3}, False),
    ("wire-r", {"wire_r_alpha": 0.05}, False),
    ("fig3f-offset", {"ir_drop_alpha": 4e-5, "adc_offset_sigma": 0.004},
     True),
    ("all", {"ir_drop_alpha": 2e-5, "wire_r_alpha": 0.03,
             "adc_offset_sigma": 0.004}, True),
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's long loops of small eager
    ops: the suite runs in several processes at once, and more threads
    per process only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(fields, **kw):
    return (jtypes.CIMConfig(nonideal=jtypes.NonIdealityConfig(**fields),
                             **kw),
            ttypes.CIMConfig(nonideal=ttypes.NonIdealityConfig(**fields),
                             **kw))


def _layer(rng, r=260, c=90, b=48):
    w = rng.normal(0, 0.1, (r, c)).astype(np.float32)
    x = rng.integers(-7, 8, (b, r)).astype(np.int32)
    cj = jcond.weights_to_conductances(jnp.asarray(w), jtypes.DeviceConfig())
    return x, np.asarray(cj.g_pos), np.asarray(cj.g_neg)


def _near_half(q, v_decr):
    """Where |q| / v_decr lies within rounding of a .5 boundary."""
    v = np.abs(np.asarray(q, np.float64)) / v_decr
    return np.abs(v - (np.floor(v) + 0.5)) < 1e-4 * np.maximum(v, 1)


def _counts_rule(got, want, q_ref, v_decr):
    got, want = np.asarray(got), np.asarray(want)
    near = _near_half(q_ref, v_decr)
    np.testing.assert_array_equal(got[~near], want[~near])
    assert np.all(np.abs(got.astype(np.int64) - want) <= 1)


def _assert_charge(got, want):
    np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(want).max())


@pytest.mark.parametrize("act", ["none", "relu", "tanh"])
@pytest.mark.parametrize("name,fields,given", DETERMINISTIC,
                         ids=[d[0] for d in DETERMINISTIC])
def test_bit_serial_oracle_matches_reference(name, fields, given, act):
    """The pulse-phase walk with IR droop per phase, wire attenuation and
    a given offset: charges to F32_RTOL, counts under the counts rule."""
    rng = np.random.default_rng(11)
    x, gp, gn = _layer(rng)
    offs = (rng.normal(0, 0.004, gp.shape[1]).astype(np.float32)
            if given else None)
    jc, tc = _cfgs(fields, activation=act)
    vd = 0.004
    oj = jref.cim_mvm_ref(jnp.asarray(x), jnp.asarray(gp), jnp.asarray(gn),
                          vd, jc, adc_offset=None if offs is None
                          else jnp.asarray(offs), bit_serial=True)
    ot = tref.cim_mvm_ref(to_torch(x), to_torch(gp), to_torch(gn), vd, tc,
                          adc_offset=None if offs is None else to_torch(offs),
                          bit_serial=True)
    qj = np.asarray(oj.q_analog)
    _assert_charge(to_numpy(ot.q_analog), qj)
    _counts_rule(to_numpy(ot.counts), np.asarray(oj.counts), qj, vd)


def test_bit_serial_differs_from_algebraic_under_ir_drop():
    """Each phase droops by its own load, so under IR drop the walk is not
    the algebraic identity (without it, it is, to rounding)."""
    x, gp, gn = _layer(np.random.default_rng(12))
    args = (to_torch(x), to_torch(gp), to_torch(gn), 0.004)
    for alpha, same in ((0.0, True), (1e-6, False)):
        tc = _cfgs({"ir_drop_alpha": alpha})[1]
        a = tref.cim_mvm_ref(*args, tc, bit_serial=True).q_analog
        b = tref.cim_mvm_ref(*args, tc, bit_serial=False).q_analog
        close = torch.allclose(a, b, rtol=1e-5,
                               atol=1e-6 * float(b.abs().max()))
        assert close == same


def _draw_stats(q_noisy, q_clean, scale):
    z = (q_noisy - q_clean) / scale
    return float(np.mean(z)), float(np.std(z))


def test_coupling_noise_statistics():
    """Coupling noise: N(0, (sigma sqrt(active pulses + 1))^2) per output,
    standardized mean and std as the reference's (0 and 1 within 0.05
    over ~4000 draws); one result per generator state; no generator
    raises."""
    x, gp, gn = _layer(np.random.default_rng(13))
    sigma = 0.002
    jc, tc = _cfgs({"coupling_sigma": sigma})
    jc0, tc0 = _cfgs({})
    planes = np.stack([(np.abs(x) >> k) & 1 for k in (2, 1, 0)])
    scale = sigma * np.sqrt(planes.sum(axis=(0, 2)) + 1.0)[:, None]
    args = (to_torch(x), to_torch(gp), to_torch(gn), 0.004)
    q0 = to_numpy(tref.cim_mvm_ref(*args, tc0).q_analog)
    gen = torch.Generator().manual_seed(1)
    q1 = to_numpy(tref.cim_mvm_ref(*args, tc, generator=gen).q_analog)
    gen.manual_seed(1)
    assert np.array_equal(
        q1, to_numpy(tref.cim_mvm_ref(*args, tc, generator=gen).q_analog))
    jargs = (jnp.asarray(x), jnp.asarray(gp), jnp.asarray(gn), 0.004)
    qj0 = np.asarray(jref.cim_mvm_ref(*jargs, jc0).q_analog)
    qj1 = np.asarray(jref.cim_mvm_ref(*jargs, jc,
                                      key=jax.random.PRNGKey(1)).q_analog)
    for m, s in (_draw_stats(q1, q0, scale), _draw_stats(qj1, qj0, scale)):
        assert abs(m) < 0.05 and abs(s - 1.0) < 0.05
    with pytest.raises(ValueError, match="generator"):
        tref.cim_mvm_ref(*args, tc)


def test_offset_spread_statistics():
    """With no offset given, the spread draws one N(0, sigma^2) offset per
    column, shared by every row (std within 15% of sigma over 2000
    columns, as the reference's)."""
    rng = np.random.default_rng(14)
    x, gp, gn = _layer(rng, r=64, c=2000, b=4)
    sigma = 0.004
    jc, tc = _cfgs({"adc_offset_sigma": sigma})
    jc0, tc0 = _cfgs({})
    args = (to_torch(x), to_torch(gp), to_torch(gn), 0.004)
    d = to_numpy(tref.cim_mvm_ref(*args, tc,
                                  generator=torch.Generator().manual_seed(2))
                 .q_analog - tref.cim_mvm_ref(*args, tc0).q_analog)
    jargs = (jnp.asarray(x), jnp.asarray(gp), jnp.asarray(gn), 0.004)
    dj = np.asarray(jref.cim_mvm_ref(*jargs, jc, key=jax.random.PRNGKey(2))
                    .q_analog - jref.cim_mvm_ref(*jargs, jc0).q_analog)
    for dd in (d, dj):
        np.testing.assert_allclose(dd, dd[:1].repeat(len(dd), 0),
                                   atol=1e-6)
        assert abs(dd[0].std() / sigma - 1.0) < 0.15
        assert abs(dd[0].mean()) < 0.15 * sigma


def test_stochastic_neuron_statistics():
    """The oracle's stochastic neuron: bit = q + U(-s, s) > 0 with s =
    v_decr * N_max, so P(1) = clip((q + s) / 2s, 0, 1); over 400 draws the
    mean bit lies within 5 binomial sigmas of it everywhere (0.125), and
    within 0.01 on average, as the reference's."""
    rng = np.random.default_rng(15)
    x, gp, gn = _layer(rng, r=64, c=32, b=8)
    jc, tc = _cfgs({}, activation="stochastic")
    args = (to_torch(x), to_torch(gp), to_torch(gn))
    q = to_numpy(tref.cim_mvm_ref(*args, 1.0, _cfgs({})[1]).q_analog)
    vd = float(np.abs(q).max()) / tc.out_mag_levels
    s = vd * tc.out_mag_levels
    p = np.clip((q + s) / (2 * s), 0, 1)
    n = 400
    gen = torch.Generator().manual_seed(3)
    bits = np.mean([to_numpy(tref.cim_mvm_ref(*args, vd, tc,
                                              generator=gen).counts)
                    for _ in range(n)], axis=0)
    draw = jax.jit(lambda k: jref.cim_mvm_ref(
        jnp.asarray(x), jnp.asarray(gp), jnp.asarray(gn), vd, jc,
        key=k).counts)
    jbits = np.mean([np.asarray(draw(jax.random.PRNGKey(i)))
                     for i in range(n)], axis=0)
    for b in (bits, jbits):
        assert np.abs(b - p).max() < 5 * 0.5 / n ** 0.5
        assert abs(float(np.mean(b - p))) < 0.01
    assert set(np.unique(to_numpy(tref.cim_mvm_ref(
        *args, vd, tc, generator=gen).counts))) <= {0, 1}


def test_lfsr_noise_is_uniform():
    g = torch.Generator().manual_seed(4)
    u = tnoise.lfsr_noise(g, (200, 100), 0.3)
    assert float(u.min()) >= -0.3 and float(u.max()) <= 0.3
    assert abs(float(u.mean())) < 0.01
    assert abs(float(u.std()) - 0.3 / 3 ** 0.5) < 0.01
    g.manual_seed(4)
    assert torch.equal(u, tnoise.lfsr_noise(g, (200, 100), 0.3))


# ------------------------------------------------------------ calibration

def test_measure_adc_offsets():
    """Zeros without a spread; N(0, sigma^2) per column from the
    generator with one (std within 10% over 4000); a spread with no
    generator raises."""
    _, tc0 = _cfgs({})
    assert torch.equal(tcal.measure_adc_offsets(None, 5, tc0),
                       torch.zeros(5))
    _, tc = _cfgs({"adc_offset_sigma": 0.004})
    o = tcal.measure_adc_offsets(torch.Generator().manual_seed(5), 4000, tc)
    assert abs(float(o.std()) / 0.004 - 1) < 0.1
    with pytest.raises(ValueError, match="generator"):
        tcal.measure_adc_offsets(None, 5, tc)


@pytest.mark.parametrize("fields", [{"adc_offset_sigma": 0.004},
                                    {"ir_drop_alpha": 4e-5,
                                     "adc_offset_sigma": 0.004,
                                     "wire_r_alpha": 0.03}])
def test_calibrate_layer_with_offsets_matches_reference(fields, monkeypatch):
    """The analog pass runs with the measured offsets present: given the
    reference's offsets, the port's v_decr is the reference's to f32
    rounding, and the offsets are returned as measured."""
    x, gp, gn = _layer(np.random.default_rng(16))
    jc, tc = _cfgs(fields)
    cj = jcal.calibrate_layer(jax.random.PRNGKey(7), jnp.asarray(x),
                              jnp.asarray(gp), jnp.asarray(gn), jc)
    offs = to_torch(np.asarray(cj.adc_offset))
    monkeypatch.setattr(tcal, "measure_adc_offsets",
                        lambda *a, **kw: offs)
    ct = tcal.calibrate_layer(to_torch(x), to_torch(gp), to_torch(gn), tc)
    np.testing.assert_allclose(float(ct.v_decr), float(cj.v_decr),
                               rtol=1e-5)
    assert torch.equal(ct.adc_offset, offs)


@pytest.mark.parametrize("fields", [{"adc_offset_sigma": 0.004},
                                    {"ir_drop_alpha": 4e-5,
                                     "adc_offset_sigma": 0.004}])
def test_search_v_read_matches_reference(fields):
    """The read-voltage grid search: under an offset spread the offset's
    share of q / V_read falls as 1 / V_read, and both packages pick the
    largest candidate, from their own draws. (The reference's droop does
    not depend on V_read, so without offsets every candidate scores the
    same to rounding, and which one wins is rounding's choice.)"""
    x, gp, gn = _layer(np.random.default_rng(17))
    jc, tc = _cfgs(fields)
    vj = float(jcal.search_v_read(jax.random.PRNGKey(8), jnp.asarray(x),
                                  jnp.asarray(gp), jnp.asarray(gn), jc))
    vt = tcal.search_v_read(to_torch(x), to_torch(gp), to_torch(gn), tc,
                            generator=torch.Generator().manual_seed(8))
    assert vt == pytest.approx(vj) == 0.6
    assert tcal.search_v_read(to_torch(x), to_torch(gp), to_torch(gn),
                              _cfgs({})[1]) in (0.2, 0.3, 0.4, 0.5, 0.6)


# ----------------------------------------------------- forward's route

RULE_CASES = [({}, "none"), ({}, "relu"), ({}, "stochastic"),
              ({"ir_drop_alpha": 1e-6}, "none"),
              ({"wire_r_alpha": 0.01}, "none"),
              ({"coupling_sigma": 0.01}, "relu"),
              ({"adc_offset_sigma": 0.004}, "none"),
              ({"ir_drop_alpha": 4e-5, "adc_offset_sigma": 0.004}, "none")]


@pytest.mark.parametrize("fields,act", RULE_CASES)
def test_forward_takes_the_oracle_where_the_reference_does(fields, act,
                                                          monkeypatch):
    """`forward` launches the kernel exactly where the reference's
    `_needs_ref` is false, and the oracle elsewhere."""
    jc, tc = _cfgs(fields, activation=act)
    lay = tcim.program(torch.randn(10, 6), tc, mode="ideal",
                       generator=torch.Generator().manual_seed(0))
    calls = []
    real = K.cim_forward

    def count(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(K, "cim_forward", count)
    y = tcim.forward(lay, torch.randn(3, 10), tc,
                     generator=torch.Generator().manual_seed(1))
    assert y.shape == (3, 6) and bool(torch.isfinite(y).all())
    assert tcim._needs_ref(tc) == jcim._needs_ref(jc)
    assert bool(calls) == (not jcim._needs_ref(jc))


@pytest.fixture(scope="module")
def fig3f_layer():
    """A reference chip layer on the Fig. 3f chip (IR drop 4e-5, offset
    spread 0.004, relaxed), its bias rows, and its outputs on a batch."""
    jc, _ = _cfgs({"ir_drop_alpha": 4e-5, "adc_offset_sigma": 0.004},
                  in_bits=4, out_bits=8)
    rng = np.random.default_rng(18)
    p = {"w": rng.normal(0, 0.2, (90, 40)).astype(np.float32),
         "b": rng.normal(0, 0.5, 40).astype(np.float32)}
    x_cal = rng.uniform(0, 2, (64, 90)).astype(np.float32)
    x = rng.uniform(0, 2, (32, 90)).astype(np.float32)
    cl = jnn.deploy_linear(jax.random.PRNGKey(9), p, jc, 2.0, x_cal=x_cal)
    y = np.asarray(jnn.chip_linear(cl, x, jc))
    return jax.tree_util.tree_map(np.asarray, cl), x, y


def test_chip_linear_oracle_route_matches_reference(fig3f_layer):
    """The reference's Fig. 3f layer carried across (its measured offsets
    included): `chip_linear` on the oracle route gives the reference's
    dequantized outputs, except one count's step where the charge sits on
    a .5 boundary."""
    cl_j, x, want = fig3f_layer
    cl = chip_states_from_numpy({"l": cl_j})["l"]
    assert float(cl.layer.adc_offset.abs().max()) > 0
    _, tc = _cfgs({"ir_drop_alpha": 4e-5, "adc_offset_sigma": 0.004},
                  in_bits=4, out_bits=8)
    got = to_numpy(tnn.chip_linear(cl, to_torch(x), tc))
    lay = cl.layer
    xa = torch.cat([to_torch(x), cl.alpha.expand(len(x), cl.bias_rows)], -1)
    x_int, scale = quantize_to_int(xa, lay.in_alpha, 4, signed=True)
    q = to_numpy(tref.cim_mvm_ref(x_int, lay.g_pos, lay.g_neg, lay.v_decr,
                                  tc, adc_offset=lay.adc_offset).q_analog)
    near = _near_half(q, float(lay.v_decr))
    step = to_numpy(lay.v_decr * lay.norm * lay.w_max * scale
                    / (tc.v_read * tc.device.g_max))
    np.testing.assert_allclose(got[~near], want[~near], rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    assert np.all(np.abs(got - want) <= near * step[None, :] * 1.001
                  + 1e-6 * np.abs(want).max())


def test_layer_from_numpy_keeps_the_offsets(fig3f_layer):
    cl_j, _, _ = fig3f_layer
    lay = layer_from_numpy(cl_j.layer)
    np.testing.assert_array_equal(to_numpy(lay.adc_offset),
                                  np.asarray(cl_j.layer.adc_offset))
    assert torch.equal(lay.off_counts,
                       torch.round(lay.adc_offset / lay.v_decr))


def test_program_draws_offsets_under_a_spread():
    """Programming on a chip with an offset spread measures offsets from
    the generator: one result per generator state, nonzero spread."""
    _, tc = _cfgs({"adc_offset_sigma": 0.004})
    w = torch.randn(30, 200, generator=torch.Generator().manual_seed(1))
    a, b = (tcim.program(w, tc, mode="ideal",
                         generator=torch.Generator().manual_seed(6))
            for _ in range(2))
    assert torch.equal(a.adc_offset, b.adc_offset)
    assert 0.5 < float(a.adc_offset.std()) / 0.004 < 1.5
