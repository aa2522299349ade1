"""Port parity, the LSTM keyword model (`models/lstm.py`, paper Fig. 4d)
and its data (`data.keyword_mfcc`): the synthetic MFCC composition on
the reference's draws; at 2 cells, hidden 24, T 6, 10 features and 4
classes the software `apply`, `deploy` in `ideal` mode, and `chip_apply`
on the reference's relaxed states carried across; the chip path's
single-matrix launches (n_cells * (2 T + 1)); then the reference's
behavioural test (`tests/test_models.py`: T 20, f 10, hidden 24, 2 cells:
software > 0.6, chip > software - 0.25).

Rules as `tests/test_torch_cnn.py`: a chip layer, given the reference's
input, returns its output except at an ADC .5 boundary (one count's
step); between steps the chip inputs agree after quantization except a
value on a quantizer tie (one level); with no such move the logits are
equal to f32 rounding (1e-6). The software path is float: rtol 1e-5.
"""
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch

from repro_torch.convert import chip_states_from_numpy, params_from_numpy
from repro_torch.core.quant import quantize_to_int
from repro_torch.core.types import CIMConfig
from repro_torch.data import compose_mfcc, keyword_mfcc
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.models import lstm, nn
from repro_torch.train.noisy import accuracy, train

CFG = CIMConfig(in_bits=4, out_bits=8)
GEOM = dict(n_cells=2, hidden=24)
T, F, CLASSES = 6, 10, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's long loops of small eager
    ops: the suite runs in several processes at once, and more threads
    per process only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_keyword_mfcc_compose_matches_reference():
    """The reference's frequencies, amplitudes, labels, phases and noise
    (its jax.random draws, exported) composed by the port: the same
    series, to the f32 rounding of sin (1e-5)."""
    import jax
    from repro.data import keyword_mfcc as jkw
    key, n, t, f, c = jax.random.PRNGKey(5), 7, 9, 6, 5
    kl, kn, kph = jax.random.split(key, 3)
    kp = jax.random.PRNGKey(11)
    freq = jax.random.uniform(kp, (c, f), minval=0.3, maxval=3.0)
    amp = jax.random.uniform(jax.random.fold_in(kp, 1), (c, f), minval=0.5,
                             maxval=2.0)
    labels = jax.random.randint(kl, (n,), 0, c)
    phase = jax.random.uniform(kph, (n, 1, f), maxval=2 * np.pi)
    eps = jax.random.normal(kn, (n, t, f))
    want, want_lab = jkw(key, n, t=t, f=f, classes=c)
    got = compose_mfcc(*(to_torch(np.asarray(a)) for a in
                         (freq, amp, labels, phase, eps)))
    np.testing.assert_array_equal(np.asarray(labels), np.asarray(want_lab))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_keyword_mfcc_port():
    """Shapes and labels; deterministic in the generator; the class
    frequencies and amplitudes shared across generators (a noise-free
    series of one class and phase is the same from any generator)."""
    a, la = keyword_mfcc(torch.Generator().manual_seed(0), 5)
    b, lb = keyword_mfcc(torch.Generator().manual_seed(0), 5)
    assert a.shape == (5, 50, 40) and la.shape == (5,)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert int(la.min()) >= 0 and int(la.max()) < 12
    x1, l1 = keyword_mfcc(torch.Generator().manual_seed(1), 40, noise=0.0)
    x2, l2 = keyword_mfcc(torch.Generator().manual_seed(2), 40, noise=0.0)
    i = int(torch.nonzero(l1 == l1[0])[0])
    j = int(torch.nonzero(l2 == l1[0])[0])
    assert torch.allclose(x1[i].abs().amax(0), x2[j].abs().amax(0),
                          rtol=0.3)


@pytest.fixture(scope="module")
def ref_lstm():
    """The reference's 2-cell LSTM: params, 2 calibration and 4 test
    series, software logits, relaxed and ideal deploy states, chip logits
    and every chip layer's (input, output) of its chip_apply in call
    order."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.types import CIMConfig as JCfg
    from repro.data import keyword_mfcc as jkw
    from repro.models import lstm as jl, nn as jnn
    jcfg = JCfg(in_bits=4, out_bits=8)
    xs, _ = jkw(jax.random.PRNGKey(0), 6, t=T, f=F, classes=CLASSES)
    params = jl.init(jax.random.PRNGKey(1), in_dim=F, n_classes=CLASSES,
                     **GEOM)
    states = jl.deploy(jax.random.PRNGKey(2), params, jcfg, xs[:2], **GEOM)
    ideal = jl.deploy(jax.random.PRNGKey(2), params, jcfg, xs[:2], **GEOM,
                      mode="ideal")
    chip = np.asarray(jl.chip_apply(states, params, xs[2:], jcfg, **GEOM))
    # the same inference unrolled (chip_apply scans over time, where its
    # chip layers' values are traced): every chip call's (name, input,
    # output), in call order
    calls, logits = [], 0.0
    b, hidden = xs.shape[0] - 2, GEOM["hidden"]

    def call(name, x, seed):
        y = jnn.chip_linear(states[name], x, jcfg, seed=seed)
        calls.append((name, np.asarray(x), np.asarray(y)))
        return y
    for c in range(GEOM["n_cells"]):
        h, cst = jnp.zeros((b, hidden)), jnp.zeros((b, hidden))
        for t in range(T):
            z = call(f"cell{c}_ih", xs[2:, t], 3 * c) \
                + call(f"cell{c}_hh", h, 3 * c + 1)
            h, cst = jl._gates_to_state(z, cst, hidden)
        logits = logits + call(f"cell{c}_ho", h, 3 * c + 2)
    np.testing.assert_allclose(np.asarray(logits), chip, rtol=1e-6,
                               atol=1e-6)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"params": tree(params), "x_cal": np.asarray(xs[:2]),
            "x": np.asarray(xs[2:]), "states": tree(states),
            "ideal": tree(ideal), "chip": chip,
            "soft": np.asarray(jl.apply(params, xs[2:], **GEOM)),
            "calls": calls}


def test_apply_matches_reference(ref_lstm):
    params = params_from_numpy(ref_lstm["params"])
    got = lstm.apply(params, to_torch(ref_lstm["x"]), **GEOM)
    np.testing.assert_allclose(to_numpy(got), ref_lstm["soft"], rtol=1e-5,
                               atol=1e-5)


def test_deploy_ideal_matches_reference(ref_lstm):
    """`ideal` programming on the software rollout's calibration inputs:
    the same bias rows, conductances, and ADC steps to f32 rounding."""
    params = params_from_numpy(ref_lstm["params"])
    got = lstm.deploy(params, CFG, to_torch(ref_lstm["x_cal"]), **GEOM,
                      mode="ideal")
    want = ref_lstm["ideal"]
    assert sorted(got) == sorted(want)
    for n, s in got.items():
        assert s.bias_rows == int(want[n].bias_rows), n
        np.testing.assert_allclose(to_numpy(s.layer.g_pos),
                                   np.asarray(want[n].layer.g_pos),
                                   rtol=1e-6, err_msg=n)
        np.testing.assert_allclose(float(s.layer.v_decr),
                                   float(want[n].layer.v_decr), rtol=1e-5,
                                   err_msg=n)


def test_chip_layers_match_reference(ref_lstm):
    """Every chip call of the reference's inference (ih and hh at every
    step, ho at the end, per cell), given its input: the counts rule."""
    states = chip_states_from_numpy(ref_lstm["states"])
    assert len(ref_lstm["calls"]) == GEOM["n_cells"] * (2 * T + 1)
    for lname, x, want in ref_lstm["calls"]:
        cl, xt = states[lname], to_torch(x)
        got = to_numpy(nn.chip_linear(cl, xt, CFG))
        lay = cl.layer
        ones = cl.alpha.expand(xt.shape[0], cl.bias_rows)
        x_int, scale = quantize_to_int(torch.cat([xt, ones], -1),
                                       lay.in_alpha, CFG.in_bits,
                                       signed=True)
        hits = to_numpy(K.matrix_boundary_counts(
            x_int.float(), lay.g_pos - lay.g_neg, 1.0 / lay.norm,
            lay.v_decr, v_read=CFG.v_read))
        step = to_numpy(lay.v_decr * lay.norm * lay.w_max * scale
                        / (CFG.v_read * CFG.device.g_max))
        clean = hits == 0
        np.testing.assert_allclose(got[clean], want[clean], rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        assert np.all(np.abs(got - want) <= hits * step[None, :] * 1.001
                      + 1e-6 * np.abs(want).max())


def test_chip_apply_matches_reference(ref_lstm, monkeypatch):
    """End to end on the carried-across relaxed chip: every chip input
    equals the reference's after quantization but for one-level moves of
    values on a tie; with none the logits are equal; the top-1 class is
    equal."""
    params = params_from_numpy(ref_lstm["params"])
    states = chip_states_from_numpy(ref_lstm["states"])
    seen = []
    real = nn.chip_linear

    def record(cl, x, cfg, seed=0, impl="auto", generator=None):
        seen.append(x)
        return real(cl, x, cfg, seed=seed, impl=impl, generator=generator)
    monkeypatch.setattr(nn, "chip_linear", record)
    got = to_numpy(lstm.chip_apply(states, params, to_torch(ref_lstm["x"]),
                                   CFG, **GEOM))
    moved = 0
    for x, (lname, x_ref, _) in zip(seen, ref_lstm["calls"]):
        alpha = states[lname].layer.in_alpha
        q, _ = quantize_to_int(x, alpha, CFG.in_bits, signed=True)
        q_ref, scale = quantize_to_int(to_torch(x_ref), alpha, CFG.in_bits,
                                       signed=True)
        diff = q != q_ref
        if bool(diff.any()):
            r = to_torch(x_ref)[diff] / scale
            assert bool(((r - torch.floor(r) - 0.5).abs() < 1e-4).all())
            assert int((q - q_ref).abs().max()) == 1, lname
            moved += int(diff.sum())
    assert len(seen) == len(ref_lstm["calls"])
    assert np.array_equal(got.argmax(-1), ref_lstm["chip"].argmax(-1))
    if moved == 0:
        np.testing.assert_allclose(got, ref_lstm["chip"], rtol=1e-5,
                                   atol=1e-5)


def test_chip_path_launches(monkeypatch):
    """Deploy runs no chip layer (calibration takes the oracle's analog
    pass); an inference makes n_cells * (2 T + 1) single-matrix calls,
    finite logits of the right shape."""
    gen = torch.Generator().manual_seed(0)
    x, _ = keyword_mfcc(gen, 5, t=T, f=F, classes=CLASSES)
    params = lstm.init(gen, in_dim=F, n_classes=CLASSES, **GEOM)
    n = [0]
    real = K.cim_forward

    def count(*a, **kw):
        n[0] += 1
        return real(*a, **kw)
    monkeypatch.setattr(K, "cim_forward", count)
    states = lstm.deploy(params, CFG, x[:2], **GEOM, generator=gen)
    assert n[0] == 0 and len(states) == 3 * GEOM["n_cells"]
    y = lstm.chip_apply(states, params, x[2:], CFG, **GEOM)
    assert n[0] == GEOM["n_cells"] * (2 * T + 1)
    assert y.shape == (3, CLASSES) and bool(torch.isfinite(y).all())


def test_paper_geometry_shapes():
    """The paper's cell: 40 x 448 input, 112 x 448 recurrent and 112 x 12
    output matrices, 4 cells."""
    p = lstm.init(torch.Generator().manual_seed(0))
    assert sum(k.startswith("cell") for k in p) == 3 * lstm.N_CELLS
    assert p["cell0_ih"]["w"].shape == (40, 448)
    assert p["cell3_hh"]["w"].shape == (112, 448)
    assert p["cell2_ho"]["w"].shape == (112, 12)


@pytest.mark.slow
def test_lstm_learns_keywords():
    """The reference's test at its sizes (256 training series of T 20, f
    10, 4 classes; 150 steps of 64 at lr 3e-3, noise 0.1 after a clean
    half), then the relaxed chip on 64 test series."""
    x, y = keyword_mfcc(torch.Generator().manual_seed(0), 256, t=20, f=10,
                        classes=4)
    xt, yt = keyword_mfcc(torch.Generator().manual_seed(9), 128, t=20, f=10,
                          classes=4)
    params = lstm.init(torch.Generator().manual_seed(1), in_dim=10,
                       n_classes=4, **GEOM)

    def apply_fn(p, xx, generator=None, noise_frac=0.0, train=False):
        return lstm.apply(p, xx, generator=generator, noise_frac=noise_frac,
                          **GEOM)
    params, losses = train(torch.Generator().manual_seed(2), params,
                           apply_fn, (x, y), steps=150, batch=64,
                           noise_frac=0.1, lr=3e-3)
    with torch.no_grad():
        acc = float(accuracy(apply_fn(params, xt), yt))
        states = lstm.deploy(params, CFG, x[:16], **GEOM,
                             generator=torch.Generator().manual_seed(3))
        chip = float(accuracy(lstm.chip_apply(states, params, xt[:64], CFG,
                                              **GEOM), yt[:64]))
    assert losses[-1] < losses[0]
    assert acc > 0.6
    assert chip > acc - 0.25


@pytest.mark.cuda
def test_chip_apply_kernel_matches_plain_on_card():
    """The paper-geometry LSTM at T 8 on the card: a relaxed deploy, then
    chip inference through the kernel (n_cells (2 T + 1) launches) equal
    to the plain rerun bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    x, _ = keyword_mfcc(gen, 40, t=8)
    params = lstm.init(gen)
    states = lstm.deploy(params, CFG, x[:8], generator=gen)
    before = K.LAUNCHES["cim_mvm"]
    y = lstm.chip_apply(states, params, x[8:], CFG)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cim_mvm"] == before + lstm.N_CELLS * (2 * 8 + 1)
    assert torch.equal(y, lstm.chip_apply(states, params, x[8:], CFG,
                                          impl="plain"))
