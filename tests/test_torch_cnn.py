"""Port parity, the CNN chip path: `im2col` (channel-major patches, XLA's
SAME padding), pooling, batch-norm folding and the cluster images against
the JAX reference; the 7-layer CNN and ResNet-20 at hw 8, batch 2 —
software `apply`, `deploy` in `ideal` mode, and `chip_apply` on the
reference's own relaxed-programmed states carried across
(`convert.chip_states_from_numpy`); and, where a CUDA device is present,
`chip_apply` through the single-matrix kernel against its plain version.

Rule: every chip layer, given the reference's input, returns the
reference's output except where an ADC count sits on a .5 boundary (one
count there, `matrix_boundary_counts`). Between layers the two packages
quantize the same activations, except that an average pool sums in
another order, which can move a value that sits exactly on a quantizer
tie by one level: every such difference must sit on a tie. Where no input
moved, the logits are equal; the top-1 class is equal throughout.

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cnn.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch

from repro_torch.convert import chip_states_from_numpy, params_from_numpy
from repro_torch.core.quant import quantize_to_int
from repro_torch.core.types import CIMConfig
from repro_torch.data import cluster_images, compose_images
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.models import cnn7, nn, resnet20

HW, BATCH = 8, 2
CFG = CIMConfig(in_bits=4, out_bits=8)
MODELS = {"cnn7": (cnn7, 1), "resnet20": (resnet20, 3)}


# ---------------------------------------------------------------- im2col

IM2COL = [((2, 7, 7, 3), 3, 1, "SAME"), ((2, 8, 8, 3), 3, 2, "SAME"),
          ((2, 8, 8, 16), 1, 2, "SAME"), ((1, 5, 6, 2), 2, 1, "VALID"),
          ((2, 9, 9, 4), 3, 2, "SAME"), ((1, 3, 3, 2), 2, 1, "VALID")]


@pytest.mark.parametrize("shape,k,stride,padding", IM2COL)
def test_im2col_matches_reference(shape, k, stride, padding):
    """Equal element for element, channel-major (C, kh, kw) patches
    included (cin > 1), and XLA's asymmetric SAME padding at stride 2."""
    from repro.models import nn as jnn
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jnn.im2col(x, k, k, stride, padding))
    got = to_numpy(nn.im2col(to_torch(x), k, k, stride, padding))
    np.testing.assert_array_equal(got, want)


def test_im2col_patch_order_is_channel_major():
    """A 2x2 patch of a 2-channel 3x3 image: channel 0's four pixels,
    then channel 1's."""
    x = torch.arange(18, dtype=torch.float32).reshape(1, 3, 3, 2)
    assert nn.im2col(x, 2, 2, 1, "VALID")[0, 0, 0].tolist() == \
        [0, 2, 6, 8, 1, 3, 7, 9]


def test_pooling_and_batch_norm_match_reference():
    from repro.models import nn as jnn
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 6, 5)).astype(np.float32)
    np.testing.assert_array_equal(to_numpy(nn.max_pool(to_torch(x))),
                                  np.asarray(jnn.max_pool(x)))
    np.testing.assert_allclose(to_numpy(nn.avg_pool_global(to_torch(x))),
                               np.asarray(jnn.avg_pool_global(x)),
                               rtol=1e-6, atol=1e-7)
    p = {k: rng.uniform(0.5, 1.5, 5).astype(np.float32)
         for k in ("gamma", "beta", "mean", "var")}
    conv = {"w": rng.normal(size=(3, 3, 4, 5)).astype(np.float32),
            "b": rng.normal(size=5).astype(np.float32)}
    tp, tconv = params_from_numpy(p), params_from_numpy(conv)
    for got, want in zip(nn.fold_bn(tconv, tp).values(),
                         jnn.fold_bn(conv, p).values()):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    for train in (False, True):
        yg, pg = nn.batch_norm(tp, to_torch(x), train)
        yw, pw = jnn.batch_norm(p, x, train)
        np.testing.assert_allclose(to_numpy(yg), np.asarray(yw), rtol=1e-5,
                                   atol=1e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(to_numpy(pg[k]), np.asarray(pw[k]),
                                       rtol=1e-5, atol=1e-6)


def test_cluster_images_compose_matches_reference():
    """The reference's prototypes, labels and pixel noise (its jax.random
    draws, exported) composed by the port: the same images, to the f32
    rounding of the 3x3 box filter's sums."""
    import jax
    from repro.data import cluster_images as jci
    key, n, hw, c = jax.random.PRNGKey(5), 6, 9, 3
    kl, kn = jax.random.split(key, 2)
    protos = np.asarray(jax.random.uniform(jax.random.PRNGKey(7),
                                           (10, hw, hw, c)))
    labels = np.asarray(jax.random.randint(kl, (n,), 0, 10))
    eps = np.asarray(jax.random.normal(kn, (n, hw, hw, c)))
    want, want_lab = jci(key, n, hw=hw, channels=c)
    got = compose_images(to_torch(protos), to_torch(labels).long(),
                         to_torch(eps))
    np.testing.assert_array_equal(labels, np.asarray(want_lab))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_cluster_images_port():
    """Shapes, range and labels; deterministic in the generator; the
    class structure is shared across generators."""
    a, la = cluster_images(torch.Generator().manual_seed(0), 5, hw=28)
    b, lb = cluster_images(torch.Generator().manual_seed(0), 5, hw=28)
    assert a.shape == (5, 28, 28, 1) and la.shape == (5,)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    c, lc = cluster_images(torch.Generator().manual_seed(1), 400, hw=8,
                           channels=3, noise=0.0)
    first = {int(l): c[i] for i, l in reversed(list(enumerate(lc)))}
    assert all(torch.equal(c[i], first[int(l)]) for i, l in enumerate(lc))


# --------------------------------------------------------- both models

@pytest.fixture(scope="module")
def ref_models():
    """Per model: the reference's params, images, relaxed deploy states,
    software and chip logits, and every chip layer's (input, output) of
    its chip_apply, recorded in call order."""
    jax = pytest.importorskip("jax")
    from repro.core.types import CIMConfig as JCfg
    from repro.data import cluster_images as jci
    from repro.models import cnn7 as jcnn7, nn as jnn, resnet20 as jres
    jcfg = JCfg(in_bits=4, out_bits=8)
    out = {}
    for name, jm in (("cnn7", jcnn7), ("resnet20", jres)):
        ch = MODELS[name][1]
        xs, _ = jci(jax.random.PRNGKey(0), 2 * BATCH, hw=HW, channels=ch)
        params = (jm.init_full(jax.random.PRNGKey(1), xs[:BATCH])
                  if name == "cnn7" else jm.init(jax.random.PRNGKey(1)))
        states = jm.deploy(jax.random.PRNGKey(4), params, jcfg, xs[:BATCH])
        calls = []
        real = jnn.chip_linear

        def record(cl, x, cfg, key=None, seed=0):
            y = real(cl, x, cfg, key=key, seed=seed)
            calls.append((id(cl), np.asarray(x), np.asarray(y)))
            return y
        jnn.chip_linear = record
        try:
            chip = np.asarray(jm.chip_apply(states, params, xs[BATCH:],
                                            jcfg))
        finally:
            jnn.chip_linear = real
        names = {id(s): n for n, s in states.items()}
        soft = jm.apply(params, xs[BATCH:])
        soft = soft[0] if name == "resnet20" else soft
        np_states = jax.tree_util.tree_map(np.asarray, states)
        out[name] = {
            "params": jax.tree_util.tree_map(np.asarray, params),
            "x_cal": np.asarray(xs[:BATCH]), "x": np.asarray(xs[BATCH:]),
            "states": np_states, "chip": chip, "soft": np.asarray(soft),
            "calls": [(names[i], x, y) for i, x, y in calls]}
        if name == "cnn7":
            out[name]["ideal"] = jax.tree_util.tree_map(
                np.asarray, jm.deploy(jax.random.PRNGKey(4), params, jcfg,
                                      xs[:BATCH], mode="ideal"))
    return out


def _port(ref, name):
    return (params_from_numpy(ref[name]["params"]),
            chip_states_from_numpy(ref[name]["states"]))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_apply_matches_reference(ref_models, name):
    """The software path (eval batch norm for ResNet-20)."""
    model = MODELS[name][0]
    params, _ = _port(ref_models, name)
    got = model.apply(params, to_torch(ref_models[name]["x"]))
    got = got[0] if name == "resnet20" else got
    np.testing.assert_allclose(to_numpy(got), ref_models[name]["soft"],
                               rtol=1e-5, atol=1e-5)


def _layer_counts_match(cl, x, got, want):
    """One chip layer on one input: equal except at ADC .5 boundaries,
    where the output moves by one count's dequantized step."""
    lay = cl.layer
    ones = cl.alpha.expand(x.shape[0], cl.bias_rows)
    x_int, scale = quantize_to_int(torch.cat([x, ones], -1), lay.in_alpha,
                                   CFG.in_bits, signed=True)
    hits = to_numpy(K.matrix_boundary_counts(
        x_int.float(), lay.g_pos - lay.g_neg, 1.0 / lay.norm, lay.v_decr,
        v_read=CFG.v_read))
    step = to_numpy(lay.v_decr * lay.norm * lay.w_max * scale
                    / (CFG.v_read * CFG.device.g_max))
    got, want = to_numpy(got), np.asarray(want)
    clean = hits == 0
    np.testing.assert_array_equal(got[clean], want[clean])
    assert np.all(np.abs(got - want) <= hits * step[None, :] * 1.001)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_chip_layers_match_reference(ref_models, name):
    """Every chip layer of the relaxed chip, carried across, given the
    reference's own input at that layer, in call order."""
    _, states = _port(ref_models, name)
    calls = ref_models[name]["calls"]
    assert len(calls) == len(states)
    for lname, x, want in calls:
        got = nn.chip_linear(states[lname], to_torch(x), CFG)
        _layer_counts_match(states[lname], to_torch(x), got, want)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_chip_apply_matches_reference(ref_models, name, monkeypatch):
    """End to end on the carried-across relaxed chip: every chip layer's
    input equals the reference's after input quantization, except values
    on a quantizer tie (one level); with no such difference the logits
    are equal; the top-1 class is equal."""
    model = MODELS[name][0]
    params, states = _port(ref_models, name)
    calls = []
    real = nn.chip_linear

    def record(cl, x, cfg, seed=0, impl="auto"):
        calls.append(x)
        return real(cl, x, cfg, seed=seed, impl=impl)
    monkeypatch.setattr(nn, "chip_linear", record)
    got = to_numpy(model.chip_apply(states, params,
                                    to_torch(ref_models[name]["x"]), CFG))
    want = ref_models[name]["chip"]
    moved = 0
    for x, (lname, x_ref, _) in zip(calls, ref_models[name]["calls"]):
        alpha = states[lname].layer.in_alpha
        q, _ = quantize_to_int(x, alpha, CFG.in_bits, signed=True)
        q_ref, scale = quantize_to_int(to_torch(x_ref), alpha, CFG.in_bits,
                                       signed=True)
        diff = (q != q_ref)
        if bool(diff.any()):
            r = to_torch(x_ref)[diff] / scale
            on_tie = (r - torch.floor(r) - 0.5).abs() < 1e-4
            assert bool(on_tie.all()) and \
                int((q - q_ref).abs().max()) == 1, lname
            moved += int(diff.sum())
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    if moved == 0:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_deploy_ideal_matches_reference(ref_models):
    """cnn7's deploy in `ideal` mode (no random draw) in both packages:
    the same bias rows and conductances, and every layer's ADC step,
    calibrated on the chip outputs of the layers before it, to f32
    rounding of the calibration sums."""
    params = params_from_numpy(ref_models["cnn7"]["params"])
    got = cnn7.deploy(params, CFG, to_torch(ref_models["cnn7"]["x_cal"]),
                      mode="ideal")
    want = ref_models["cnn7"]["ideal"]
    assert sorted(got) == sorted(want)
    for n, s in got.items():
        w = want[n]
        assert s.bias_rows == int(w.bias_rows)
        np.testing.assert_allclose(to_numpy(s.layer.g_pos),
                                   np.asarray(w.layer.g_pos), rtol=1e-6)
        np.testing.assert_allclose(float(s.layer.v_decr),
                                   float(w.layer.v_decr), rtol=1e-5)


@pytest.mark.parametrize("name,deploy_n,infer_n", [("cnn7", 6, 7),
                                                   ("resnet20", 21, 22)])
def test_single_matrix_launches_per_path(name, deploy_n, infer_n,
                                         monkeypatch):
    """The per-matrix path's kernel calls (the fused forward): deploy runs a
    chip layer after each convolution it programs (not after the fc;
    calibration runs the oracle), inference one per layer."""
    model, ch = MODELS[name]
    gen = torch.Generator().manual_seed(0)
    x, _ = cluster_images(gen, 2 * BATCH, hw=HW, channels=ch)
    params = (cnn7.init_full(gen, x[:BATCH]) if name == "cnn7"
              else resnet20.init(gen))
    n = [0]
    real = K.cim_forward

    def count(*a, **kw):
        n[0] += 1
        return real(*a, **kw)
    monkeypatch.setattr(K, "cim_forward", count)
    states = model.deploy(params, CFG, x[:BATCH], generator=gen)
    assert n[0] == deploy_n and len(states) == infer_n
    n[0] = 0
    y = model.chip_apply(states, params, x[BATCH:], CFG)
    assert n[0] == infer_n and y.shape == (BATCH, 10)
    assert bool(torch.isfinite(y).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["relaxed", "writeverify"])
def test_chip_apply_kernel_matches_plain_on_card(mode):
    """cnn7 at 28x28 on the card: deploy and chip inference through the
    kernel, then the plain rerun: equal logits, 6 + 7 launches."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    x, _ = cluster_images(gen, 40, hw=28)
    params = cnn7.init_full(gen, x[:2])
    before = K.LAUNCHES["cim_mvm"]
    states = cnn7.deploy(params, CFG, x[:8], mode=mode, generator=gen)
    y = cnn7.chip_apply(states, params, x[8:], CFG)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cim_mvm"] == before + 13
    assert torch.equal(y, cnn7.chip_apply(states, params, x[8:], CFG,
                                          impl="plain"))
