"""Port parity, the per-matrix chip path: the single-matrix CIM MVM
(`cim_mvm`, the port's plain version against the reference's
`cim_mvm_pallas` in interpret mode), the programming models (relaxation,
write-verify), `core.cim.forward` of a carried-across relaxed layer and
the verifier's per-matrix `exact-dot`; where a CUDA device is present,
the CUDA kernel against its plain version.

Rule (ROADMAP north star): ADC counts agree exactly except where the
reference |q|/v_decr lies within f32 rounding of a .5 boundary, and
stochastic bits except where q plus the noise lies within rounding of 0
(`matrix_boundary_counts`: the reference sums the dot in f32 over K
blocks, the port exactly in FP64); the raw-charge (identity) mode agrees
to the f32 rounding of the sums. Random programming and write-verify
draws cannot be replayed across the two packages: they are compared in
distribution, and exactly where the port is fed the reference's
programmed arrays.

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_chip_linear.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch

from repro_torch.core import cim as tcim
from repro_torch.core import noise as tnoise
from repro_torch.core import verify as tverify
from repro_torch.core import writeverify as twv
from repro_torch.core.conductance import (conductances_to_weights,
                                          program_conductances)
from repro_torch.core.types import CIMConfig, DeviceConfig
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.kernels.cim_mvm import ops

ACTS = ("none", "relu", "tanh", "sigmoid", "identity", "stochastic")
SEED = 41
# (R, C, B, block): the shapes and blocks of the reference's
# tests/test_kernels.py, and a padded case over several row and column
# blocks for the stochastic neuron's hash coordinates
SHAPES = [(64, 48, 8, (32, 32, 32)), (100, 60, 5, (32, 64, 32)),
          (256, 256, 16, (128, 128, 128)), (16, 16, 1, (16, 16, 16)),
          (100, 60, 40, (16, 64, 32))]
ALL_ACTS = {1, 4}                  # shape indices run in every activation


def _matrix_case(i):
    r, c, b, _ = SHAPES[i]
    rng = np.random.default_rng(i)
    w = rng.normal(0, 0.1, (r, c)).astype(np.float32)
    x = rng.integers(-7, 8, (b, r)).astype(np.float32)
    return w, x


@pytest.fixture(scope="module")
def mvm():
    """The reference's cim_mvm (interpret mode) on relaxed-programmed
    conductances: every shape in 'none', two in every activation."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.conductance import program_conductances as jprog
    from repro.core.types import CIMConfig as JCfg
    from repro.kernels.cim_mvm.ops import cim_mvm as jmvm

    cases = []
    for i, (r, c, b, blk) in enumerate(SHAPES):
        w, x = _matrix_case(i)
        cond = jprog(jax.random.PRNGKey(i), jnp.asarray(w), JCfg().device)
        gp, gn = np.asarray(cond.g_pos), np.asarray(cond.g_neg)
        q = x.astype(np.float64) @ (gp - gn).astype(np.float64) * 0.5 \
            / (gp + gn).sum(0)
        vd = np.float32(np.abs(q).max() / 127 * 0.8)
        outs = {}
        for act in (ACTS if i in ALL_ACTS else ("none",)):
            outs[act] = np.asarray(jmvm(
                jnp.asarray(x), cond.g_pos, cond.g_neg, vd,
                JCfg(activation=act), seed=SEED, block=blk))
        cases.append({"x": x, "gp": gp, "gn": gn, "vd": vd, "blk": blk,
                      "outs": outs})
    return cases


def _run(case, act, impl="auto"):
    return ops.cim_mvm(to_torch(case["x"]), to_torch(case["gp"]),
                       to_torch(case["gn"]), torch.tensor(case["vd"]),
                       CIMConfig(activation=act), seed=SEED,
                       block=case["blk"], impl=impl)


def _assert_matrix_match(case, act, got):
    want = case["outs"][act]
    if act == "identity":
        # f32 sums of <= 256 products per block in another order
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=2e-5 * np.abs(want).max())
        return
    gp, gn = to_torch(case["gp"]), to_torch(case["gn"])
    m, n = case["x"].shape[0], gp.shape[1]
    hits = to_numpy(K.matrix_boundary_counts(
        to_torch(case["x"]), gp - gn, 1.0 / (gp + gn).sum(0),
        torch.tensor(case["vd"]), v_read=0.5, activation=act, seed=SEED,
        bm_ref=min(case["blk"][0], m), bn_ref=min(case["blk"][2], n)))
    clean = hits == 0
    assert np.array_equal(got[clean], want[clean]), (
        f"{int((got[clean] != want[clean]).sum())} outputs off the "
        "boundaries differ")
    assert np.all(np.abs(got - want) <= hits)


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_plain_matches_reference_none(mvm, i):
    """Every shape and block of the reference's kernel tests, padding
    included: counts equal off the .5 boundaries."""
    _assert_matrix_match(mvm[i], "none", to_numpy(_run(mvm[i], "none")))


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("i", sorted(ALL_ACTS))
def test_plain_matches_reference_activations(mvm, i, activation):
    """Every activation, the stochastic neuron's bits hashed at the
    reference's block-local coordinates of its (bm, bn) blocks."""
    got = to_numpy(_run(mvm[i], activation))
    _assert_matrix_match(mvm[i], activation, got)


def test_plain_forced_equals_auto_on_cpu(mvm):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    before = dict(K.LAUNCHES)
    for act in ACTS:
        assert torch.equal(_run(mvm[4], act), _run(mvm[4], act, "plain"))
    assert K.LAUNCHES == before


def test_wrapper_rejects_bad_arguments():
    x, g = torch.zeros(2, 3), torch.ones(3, 4)
    with pytest.raises(ValueError, match="features"):
        K.cim_mvm(torch.zeros(2, 5), g, torch.ones(4), torch.tensor(1.0))
    with pytest.raises(ValueError, match="activation"):
        K.cim_mvm(x, g, torch.ones(4), torch.tensor(1.0), activation="x")
    with pytest.raises(ValueError, match="impl"):
        K.cim_mvm(x, g, torch.ones(4), torch.tensor(1.0), impl="cuda")
    with pytest.raises(ValueError, match="device"):
        K.cim_mvm(x.to("meta"), g.to("meta"), torch.ones(4, device="meta"),
                  torch.tensor(1.0, device="meta"))


# ------------------------------------------------ programming models

def test_relaxation_sigma_matches_reference():
    """Deterministic: equal to f32 rounding over the conductance range
    and 1..3 programming iterations."""
    from repro.core.noise import relaxation_sigma as jsig
    from repro.core.types import DeviceConfig as JDev
    g = np.linspace(0.5, 45.0, 1001).astype(np.float32)
    g[:3] = [1.0, 1.0 + 1e-6, 12.0]
    for it in (1, 2, 3):
        want = np.asarray(jsig(g, JDev(), it))
        got = to_numpy(tnoise.relaxation_sigma(to_torch(g), DeviceConfig(),
                                               it))
        np.testing.assert_allclose(got, want, rtol=4e-7, atol=0)


def test_apply_relaxation_statistics():
    """Mean-zero drift of std relaxation_sigma(g), clipped to [g_min,
    g_max]; deterministic in the generator."""
    dev = DeviceConfig()
    g = torch.full((256, 256), 12.0)
    a = tnoise.apply_relaxation(torch.Generator().manual_seed(0), g, dev)
    b = tnoise.apply_relaxation(torch.Generator().manual_seed(0), g, dev)
    assert torch.equal(a, b)
    sigma = float(tnoise.relaxation_sigma(12.0, dev, 3))
    d = (a - g).double()
    assert abs(float(d.mean())) < 0.02 and \
        abs(float(d.std()) / sigma - 1) < 0.02
    low = tnoise.apply_relaxation(torch.Generator().manual_seed(1),
                                  torch.full((64, 64), dev.g_min), dev)
    assert float(low.min()) == dev.g_min and float(low.max()) <= dev.g_max


def test_program_conductances_decode():
    """Relaxed programming keeps the ideal encoding's w_max, recomputes
    the normalizer from the drawn cells, and decodes near the weight
    (`effective_weight` of the layer decodes the same)."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(128, 64, generator=gen) * 0.1
    c = program_conductances(gen, w, DeviceConfig())
    assert torch.equal(c.norm, torch.sum(c.g_pos + c.g_neg, dim=0))
    assert float(c.w_max) == float(w.abs().max())
    err = conductances_to_weights(c, DeviceConfig()) - w
    assert float(err.std()) < 0.3 * float(w.std())
    assert float(torch.minimum(c.g_pos, c.g_neg).min()) >= 1.0
    lay = tcim.CIMLayer(c.g_pos, c.g_neg, c.w_max, c.norm, torch.tensor(1.0),
                        torch.zeros(64), torch.tensor(1.0))
    assert torch.equal(tcim.effective_weight(lay, CIMConfig()),
                       conductances_to_weights(c, DeviceConfig()))


@pytest.fixture(scope="module")
def wv_targets():
    rng = np.random.default_rng(0)
    return rng.uniform(1.0, 40.0, (128, 128)).astype(np.float32)


def test_write_verify_convergence_matches_reference(wv_targets):
    """The paper measures 99% of cells converging at 8.52 pulses per cell:
    the port converges at least 99% of the same targets, and its mean
    pulse count is within 10% of the reference's."""
    import jax
    from repro.core.types import DeviceConfig as JDev
    from repro.core.writeverify import write_verify as jwv
    want = jwv(jax.random.PRNGKey(1), wv_targets, JDev())
    got = twv.write_verify(torch.Generator().manual_seed(1),
                           to_torch(wv_targets), DeviceConfig())
    assert float(got.converged.float().mean()) >= 0.99
    p_ref = float(np.asarray(want.n_pulses).mean())
    p_got = float(got.n_pulses.double().mean())
    assert abs(p_got / p_ref - 1) < 0.1, (p_got, p_ref)
    ok = got.converged
    assert bool(((got.g - to_torch(wv_targets)).abs()[ok] <= 1.0).all())


def test_iterative_programming_narrows_relaxation():
    """More iterations, a tighter final distribution (paper Ext. Data Fig.
    3e), and every cell inside [g_min, g_max]."""
    dev = DeviceConfig()
    tgt = torch.full((64, 64), 20.0)
    g1 = twv.iterative_program(torch.Generator().manual_seed(0), tgt, dev,
                               iterations=1)
    g3 = twv.iterative_program(torch.Generator().manual_seed(0), tgt, dev,
                               iterations=3)
    assert float((g3 - tgt).std()) < float((g1 - tgt).std())
    assert float(g3.min()) >= dev.g_min and float(g3.max()) <= dev.g_max


@pytest.mark.parametrize("mode", ["ideal", "relaxed", "writeverify"])
def test_program_modes(mode):
    """All three fidelities program, calibrate and pass `exact-dot`;
    deterministic in the generator; 'ideal' draws nothing."""
    w = torch.randn(40, 24, generator=torch.Generator().manual_seed(3))
    x_cal = torch.randn(16, 40, generator=torch.Generator().manual_seed(4))
    a = tcim.program(w, CIMConfig(), 2.0, x_cal, mode,
                     torch.Generator().manual_seed(5))
    b = tcim.program(w, CIMConfig(), 2.0, x_cal, mode,
                     torch.Generator().manual_seed(5))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert float(torch.minimum(a.g_pos, a.g_neg).min()) >= 1.0
    if mode == "ideal":
        c = tcim.program(w, CIMConfig(), 2.0, x_cal, mode,
                         torch.Generator().manual_seed(6))
        assert torch.equal(a.g_pos, c.g_pos)
    with pytest.raises(ValueError, match="mode"):
        tcim.program(w, CIMConfig(), mode="bogus")


# ------------------------------------------------------ core.cim.forward

@pytest.fixture(scope="module")
def relaxed_layer():
    """A relaxed layer programmed and calibrated by the reference, its
    forward through the reference's kernel (interpret mode)."""
    import jax
    import jax.numpy as jnp
    from repro.core import cim as jcim
    from repro.core.types import CIMConfig as JCfg
    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.1, (300, 70)).astype(np.float32)
    x_cal = rng.normal(0, 1.0, (64, 300)).astype(np.float32)
    x = rng.normal(0, 1.0, (37, 300)).astype(np.float32)
    cfg = JCfg(in_bits=4, out_bits=8)
    lay = jcim.program(jax.random.PRNGKey(3), jnp.asarray(w), cfg,
                       in_alpha=2.0, x_cal=jnp.asarray(x_cal),
                       mode="relaxed")
    y = np.asarray(jcim.forward(lay, jnp.asarray(x), cfg))
    return {"layer": jax.tree_util.tree_map(np.asarray, lay), "x": x,
            "y": y}


def test_forward_matches_reference(relaxed_layer):
    """The reference's relaxed conductances, normalizers and ADC step
    carried across: the port's forward equals the reference's except
    where a count sits on a .5 boundary (one ADC step there)."""
    from repro_torch.core.quant import quantize_to_int
    lay = tcim.prepare(tcim.CIMLayer(*(to_torch(np.asarray(a, np.float32))
                                       for a in relaxed_layer["layer"])))
    x = to_torch(relaxed_layer["x"])
    cfg = CIMConfig(in_bits=4, out_bits=8)
    got = to_numpy(tcim.forward(lay, x, cfg))
    want = relaxed_layer["y"]
    x_int, scale = quantize_to_int(x, lay.in_alpha, 4, signed=True)
    gd = lay.g_pos - lay.g_neg
    hits = to_numpy(K.matrix_boundary_counts(
        x_int.float(), gd, 1.0 / lay.norm, lay.v_decr, v_read=0.5))
    step = to_numpy(lay.v_decr * lay.norm * lay.w_max * scale / 20.0)
    clean = hits == 0
    np.testing.assert_allclose(got[clean], want[clean], rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    assert np.all(np.abs(got - want) <= hits * step[None, :] * 1.001
                  + 1e-6 * np.abs(want).max())


def test_forward_needs_the_oracle_for_what_it_models():
    """Per-phase non-idealities and the oracle's stochastic neuron need
    the bit-serial oracle (not ported): forward raises."""
    from repro_torch.core.types import NonIdealityConfig
    lay = tcim.program(torch.randn(8, 4), CIMConfig(), mode="ideal")
    for cfg in (CIMConfig(activation="stochastic"),
                CIMConfig(nonideal=NonIdealityConfig(coupling_sigma=0.1))):
        with pytest.raises(NotImplementedError, match="oracle"):
            tcim.forward(lay, torch.randn(2, 8), cfg)


# ----------------------------------------------------- verifier: exact-dot

def test_exact_dot_rejects_conductances_below_one_microsiemens():
    """A device whose g_min is below 1 uS puts G+ - G- off the 2^-23 grid:
    `program` refuses it (stage 'program', invariant 'exact-dot')."""
    cfg = CIMConfig(device=DeviceConfig(g_min=0.5))
    with pytest.raises(tverify.ChipVerifyError) as e:
        tcim.program(torch.randn(32, 8), cfg, mode="ideal")
    assert (e.value.stage, e.value.invariant) == ("program", "exact-dot")
    g = torch.full((4, 3), 2.0)
    tverify.check_layer(g, g)
    g_low = g.clone()
    g_low[1, 2] = 0.999
    with pytest.raises(tverify.ChipVerifyError, match="below"):
        tverify.check_layer(g_low, g)


def test_exact_dot_rejects_sums_that_could_round():
    """K rows of inputs up to 127 against |G+ - G-| must stay below 2^30."""
    k = 1 << 16
    g_hi = torch.full((k, 1), 200.0)
    with pytest.raises(tverify.ChipVerifyError, match="2\\^30"):
        tverify.check_layer(g_hi, torch.ones((k, 1)))
    tverify.check_layer(torch.full((k, 1), 40.0), torch.ones((k, 1)))


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTS)
def test_kernel_matches_plain_on_card(activation):
    """The single-matrix CUDA kernel against its plain version on relaxed
    conductances, at a ragged shape, the 7-layer CNN's fc and conv5 at
    batch 256, and M across several hash row blocks: bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for (m, k, n) in ((5, 300, 500), (256, 577, 10), (12544, 577, 64),
                      (600, 145, 16)):
        w = torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
        lay = tcim.program(w, CIMConfig(), 3.0, mode="relaxed",
                           generator=gen)
        x = torch.randint(-7, 8, (m, k), generator=gen,
                          device=dev).to(torch.float32)
        cfg = CIMConfig(activation=activation)
        before = K.LAUNCHES["cim_mvm"]
        got = ops.cim_mvm(x, lay.g_pos, lay.g_neg, lay.v_decr, cfg,
                          seed=SEED, norm=lay.norm)
        want = ops.cim_mvm(x, lay.g_pos, lay.g_neg, lay.v_decr, cfg,
                           seed=SEED, norm=lay.norm, impl="plain")
        torch.cuda.synchronize()
        assert K.LAUNCHES["cim_mvm"] == before + 1
        assert torch.equal(got, want), (m, k, n)
