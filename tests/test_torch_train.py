"""Port parity, noise-resilient training (`repro_torch/train`): PACT's
gradients at the clip's ties, the optimizers, the loss, and three train
steps of cnn7, ResNet-20 (BN state) and the LSTM against the JAX
reference on the same batches at noise 0; then the port's own trainer
and the reference's behavioural thresholds (`tests/test_models.py`:
cnn7 learns at hw 16, survives 10% weight noise, and its relaxed chip
stays near the software accuracy).

Tolerances: one optimizer update in float32, rtol 1e-6; three train steps
(forward, autograd, clipping and AdamW: sums in another order in each),
loss and params within rtol 1e-4 / atol 1e-5. Noise streams differ
between the packages (jax.random keys, torch generators), so noisy steps
are held by their statistics only.
"""
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch

from repro_torch.convert import params_from_numpy
from repro_torch.core.quant import pact_quantize
from repro_torch.core.types import CIMConfig
from repro_torch.data import cluster_images
from repro_torch.models import cnn7, lstm, resnet20
from repro_torch.train import optimizer as topt
from repro_torch.train.noisy import (accuracy, eval_under_noise,
                                     make_train_step, train, value_and_grad,
                                     xent)

STEP_RTOL, STEP_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's long loops of small eager
    ops: the suite runs in several processes at once, and more threads
    per process only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- PACT gradients

@pytest.mark.parametrize("signed,bits", [(False, 3), (True, 4),
                                         (False, 1), (True, 2)])
def test_pact_gradients_match_jax(signed, bits):
    """Values and x's gradient equal jax.grad's at x = -alpha, 0, alpha
    (the clip's ties), outside the clip and inside it; alpha's gradient to
    the rounding of its sum over the elements."""
    import jax
    import jax.numpy as jnp
    from repro.core.quant import pact_quantize as jpact
    alpha = 1.5
    x = np.array([-alpha, 0.0, alpha, 2.0, -3.0, 0.4, -0.7, 1.1, 0.75],
                 np.float32)
    w = np.arange(1, x.size + 1, dtype=np.float32)   # a distinct cotangent

    def jloss(xx, a):
        return jnp.sum(jpact(xx, a, bits, signed) * w)
    jv = np.asarray(jpact(jnp.asarray(x), jnp.float32(alpha), bits, signed))
    jgx, jga = jax.grad(jloss, (0, 1))(jnp.asarray(x), jnp.float32(alpha))
    xt = to_torch(x).requires_grad_(True)
    at = torch.tensor(alpha).requires_grad_(True)
    v = pact_quantize(xt, at, bits, signed)
    (v * to_torch(w)).sum().backward()
    np.testing.assert_array_equal(to_numpy(v), jv)
    np.testing.assert_array_equal(to_numpy(xt.grad), np.asarray(jgx))
    # alpha's gradient sums the elements' terms, in another order
    np.testing.assert_allclose(float(at.grad), float(jga), rtol=1e-5)


def test_pact_tie_split_is_not_clamps():
    """The repaired clip: at x = alpha the gradient splits evenly between
    x and alpha, as jnp.clip's does (torch.clamp would give x all of
    it)."""
    x = torch.tensor([1.0], requires_grad=True)
    a = torch.tensor(1.0, requires_grad=True)
    pact_quantize(x, a, 3).sum().backward()
    assert float(x.grad) == 0.5 and float(a.grad) == 0.5


# -------------------------------------------------------------- optimizers

def _tree(rng):
    return {"a": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                  "b": rng.normal(size=3).astype(np.float32)},
            "alpha": np.float32(rng.normal()),
            "z": rng.normal(size=(4,)).astype(np.float32)}


@pytest.mark.parametrize("opt", ["adamw", "adamw-decay", "sgdm",
                                 "sgdm-decay"])
def test_optimizers_match_reference(opt):
    """Four updates on the same trees and gradients, rtol 1e-6."""
    import jax
    from repro.train import optimizer as jopt
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(4)]
    wd = 1e-2 if opt.endswith("decay") else 0.0
    kind = opt.split("-")[0]
    init_j, upd_j = getattr(jopt, f"{kind}_init"), getattr(jopt,
                                                           f"{kind}_update")
    init_t, upd_t = getattr(topt, f"{kind}_init"), getattr(topt,
                                                           f"{kind}_update")
    pj, sj = params, init_j(params)
    pt = params_from_numpy(params)
    st = init_t(pt)
    for g in grads:
        pj, sj = upd_j(g, sj, pj, 3e-3, weight_decay=wd)
        pt, st = upd_t(params_from_numpy(g), st, pt, 3e-3, weight_decay=wd)
    got = topt.tree_leaves(pt)
    want = jax.tree_util.tree_leaves(pj)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_grads_matches_reference(max_norm):
    """Global norm over every leaf; scaled when above max_norm, untouched
    below."""
    import jax
    from repro.train.optimizer import clip_grads as jclip
    g = _tree(np.random.default_rng(4))
    cj, nj = jclip(g, max_norm)
    ct, nt = topt.clip_grads(params_from_numpy(g), max_norm)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    for a, b in zip(topt.tree_leaves(ct), jax.tree_util.tree_leaves(cj)):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-6)


def test_cosine_lr_matches_reference():
    """The schedule, to the reference's float32 rounding of its O(1)
    factor (the port takes it in double): within 1e-6 of base_lr."""
    from repro.train.optimizer import cosine_lr as jcos
    for step in (0, 1, 5, 10, 50, 99, 100, 150):
        np.testing.assert_allclose(topt.cosine_lr(1e-3, step, 100, 10),
                                   float(jcos(1e-3, step, 100, 10)),
                                   rtol=0, atol=1e-9)


def test_xent_and_accuracy_match_reference():
    from repro.train.noisy import accuracy as jacc, xent as jxent
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(16, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 16).astype(np.int32)
    np.testing.assert_allclose(float(xent(to_torch(logits), to_torch(labels))),
                               float(jxent(logits, labels)), rtol=1e-6)
    assert float(accuracy(to_torch(logits), to_torch(labels))) == \
        float(jacc(logits, labels))


# ----------------------------------------------------- train steps vs JAX

LSTM_GEOM = dict(n_cells=2, hidden=24)
B = 8                                  # batch of a parity step


def _lstm_apply(mod, key_name):
    def fn(p, x, noise_frac=0.0, train=False, **kw):
        return mod.apply(p, x, noise_frac=noise_frac, **LSTM_GEOM,
                         **{key_name: kw.get(key_name)})
    return fn


@pytest.fixture(scope="module")
def step_refs():
    """Per model: params, three batches, the reference's gradient of the
    loss at the params each step starts from, and its (loss, params)
    after each of three noise-0 steps."""
    jax = pytest.importorskip("jax")
    from repro.data import cluster_images as jci, keyword_mfcc as jkw
    from repro.models import cnn7 as jc, lstm as jl, resnet20 as jr
    from repro.train.noisy import make_train_step as jstep, xent as jxent
    from repro.train.optimizer import adamw_init as jinit
    out = {}
    for name in ("cnn7", "resnet20", "lstm"):
        if name == "lstm":
            x, y = jkw(jax.random.PRNGKey(0), 3 * B, t=6, f=10, classes=4)
            params = jl.init(jax.random.PRNGKey(1), in_dim=10, n_classes=4,
                             **LSTM_GEOM)
            fn, bn = _lstm_apply(jl, "key"), False
        else:
            x, y = jci(jax.random.PRNGKey(0), 3 * B, hw=8,
                       channels=1 if name == "cnn7" else 3)
            params = (jc.init_full(jax.random.PRNGKey(1), x[:2])
                      if name == "cnn7" else jr.init(jax.random.PRNGKey(1)))
            fn = jc.apply if name == "cnn7" else jr.apply
            bn = name == "resnet20"
        step = jstep(fn, 0.0, 1e-3, has_bn_state=bn)

        def loss(pp, xb, yb, fn=fn, bn=bn):
            out = fn(pp, xb, key=jax.random.PRNGKey(9), noise_frac=0.0,
                     train=True)
            return jxent(out[0] if bn else out, yb)
        grad = jax.jit(jax.grad(loss))
        p, o = params, jinit(params)
        batches, grads, trail = [], [], []
        for i in range(3):
            xb, yb = x[B * i:B * (i + 1)], y[B * i:B * (i + 1)]
            grads.append(jax.tree_util.tree_map(np.asarray, grad(p, xb, yb)))
            p, o, loss_i, _ = step(p, o, xb, yb, jax.random.PRNGKey(9), i)
            batches.append((np.asarray(xb), np.asarray(yb)))
            trail.append((float(loss_i),
                          jax.tree_util.tree_map(np.asarray, p)))
        out[name] = {"params": jax.tree_util.tree_map(np.asarray, params),
                     "batches": batches, "grads": grads, "trail": trail,
                     "bn": bn}
    return out


@pytest.mark.parametrize("name", ["cnn7", "resnet20", "lstm"])
def test_train_steps_match_reference(step_refs, name):
    """Three AdamW steps at noise 0 on the reference's batches: first each
    step's gradient, every leaf at the params the reference's step starts
    from, equal to the reference's (rtol 1e-4, atol 1e-6 of its global
    norm); then the loss and every param (BN running stats included)
    after each step.

    Where the reference's gradient lies within rounding of zero (below
    1e-6 of its global norm: a conv bias ahead of a train-mode batch norm,
    whose gradient is zero in exact arithmetic; a weight whose terms
    cancel), AdamW's division by sqrt(v) + 1e-8 turns that rounding into
    a step of up to lr either way, in both packages; there both are held
    to lr per step instead. The gradient check before it keeps a leaf
    whose gradient the port lost out of that allowance. A BN running mean
    averages its conv's output, bias included, so it carries 0.1 of each
    such bias difference (decayed by 0.9 a step): that predicted share is
    taken off before comparing."""
    ref = step_refs[name]
    fn = {"cnn7": cnn7.apply, "resnet20": resnet20.apply,
          "lstm": _lstm_apply(lstm, "generator")}[name]
    lr = 1e-3
    step = make_train_step(fn, 0.0, lr, has_bn_state=ref["bn"])
    p = params_from_numpy(ref["params"])
    o = topt.adamw_init(p)
    tiny = [torch.zeros_like(t, dtype=torch.bool)
            for t in topt.tree_leaves(p)]
    dmean, p_prev = {}, None
    for i, ((xb, yb), g_ref, (loss_ref, p_ref)) in enumerate(
            zip(ref["batches"], ref["grads"], ref["trail"])):
        xb, yb = to_torch(xb), to_torch(yb).long()

        def loss_fn(pp):
            out = fn(pp, xb, generator=None, noise_frac=0.0, train=True)
            return xent(out[0] if ref["bn"] else out, yb), None
        start = p_prev if i else params_from_numpy(ref["params"])
        grads = value_and_grad(loss_fn, start)[2]
        g_ref = topt.tree_leaves(params_from_numpy(g_ref))
        gnorm = float(torch.sqrt(sum(torch.sum(g ** 2) for g in g_ref)))
        for (k, g), gr in zip(_named_leaves(grads), g_ref):
            np.testing.assert_allclose(to_numpy(g), to_numpy(gr), rtol=1e-4,
                                       atol=1e-6 * gnorm,
                                       err_msg=f"step {i} grad {k}")
        tiny = [t | (g.abs() < 1e-6 * gnorm) for t, g in zip(tiny, g_ref)]
        # the biases this step's forward passes ran with, per package
        db = {k: to_numpy(p[k]["b"]) - to_numpy(p_prev[k]["b"])
              for k in p if isinstance(p[k], dict) and "b" in p[k]} \
            if i else {}
        p, o, loss, _ = step(p, o, xb, yb)
        np.testing.assert_allclose(float(loss), loss_ref, rtol=STEP_RTOL)
        p_prev = params_from_numpy(p_ref)
        for k, conv in _bn_convs(p).items():
            dmean[k] = 0.9 * dmean.get(k, 0.0) + 0.1 * db.get(conv, 0.0)
        want = topt.tree_leaves(p_prev)
        for (k, a), b, t in zip(_named_leaves(p), want, tiny):
            a, b, t = to_numpy(a), to_numpy(b), to_numpy(t)
            if k.endswith("/mean") or k.endswith("/var"):
                t = np.zeros_like(t)             # statistics, not stepped
                if k.endswith("/mean"):
                    b = b + dmean[k.split("/")[1]]
            np.testing.assert_allclose(a[~t], b[~t], rtol=STEP_RTOL,
                                       atol=STEP_ATOL, err_msg=k)
            assert np.all(np.abs(a[t] - b[t]) <= 2 * lr * (i + 1)), k


def _bn_convs(params):
    """ResNet-20's batch norms -> the conv each normalizes."""
    out = {}
    for k in params:
        if k == "stem_bn":
            out[k] = "stem"
        elif k[-3:] in ("bn1", "bn2", "bnp"):
            out[k] = k[:-3] + {"1": "c1", "2": "c2", "p": "proj"}[k[-1]]
    return out


def _named_leaves(tree, pre=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _named_leaves(tree[k], f"{pre}/{k}")]
    return [(pre, tree)]


def test_bn_running_stats_come_from_the_forward_pass():
    """ResNet-20 with BN state: after a step the running mean / var are
    the forward pass's, moved from init, and carry no autograd history;
    every other leaf is a plain tensor too."""
    gen = torch.Generator().manual_seed(0)
    x, y = cluster_images(gen, 4, hw=8, channels=3)
    params = resnet20.init(gen)
    step = make_train_step(resnet20.apply, 0.0, 1e-3, has_bn_state=True)
    p2, _, _, _ = step(params, topt.adamw_init(params), x, y)
    _, new_p = resnet20.apply(params, x, train=True)
    for k in ("stem_bn", "s1b0bnp"):
        assert torch.equal(p2[k]["mean"], new_p[k]["mean"])
        assert torch.equal(p2[k]["var"], new_p[k]["var"])
        assert float((p2[k]["mean"] - params[k]["mean"]).abs().max()) > 0
    assert all(not t.requires_grad and t.grad_fn is None
               for t in topt.tree_leaves(p2))


def test_train_recipe_and_determinism():
    """The trainer: one loss per step, the same generator state the same
    params, another seed other batches; noise after the clean half."""
    gen = torch.Generator().manual_seed(0)
    x, y = cluster_images(gen, 32, hw=8)
    params = cnn7.init_full(gen, x[:2])
    runs = [train(torch.Generator().manual_seed(s), params, cnn7.apply,
                  (x, y), steps=4, batch=8, noise_frac=0.2)
            for s in (1, 1, 2)]
    assert len(runs[0][1]) == 4
    a, b, c = (topt.tree_leaves(r[0]) for r in runs)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not all(torch.equal(u, v) for u, v in zip(a, c))


def test_eval_under_noise_port():
    """Noise 0 is the clean accuracy in every trial; noisy trials differ
    from it and repeat per generator state."""
    gen = torch.Generator().manual_seed(0)
    x, y = cluster_images(gen, 64, hw=8)
    params = cnn7.init_full(gen, x[:2])
    clean = float(accuracy(cnn7.apply(params, x), y))
    runs = [eval_under_noise(torch.Generator().manual_seed(5), params,
                             cnn7.apply, (x, y), [0.0, 0.5], n_trials=2)
            for _ in range(2)]
    assert runs[0] == runs[1] and runs[0][0.0] == clean


# -------------------------------------- the reference's behavioural tests

@pytest.fixture(scope="module")
def cnn_setup():
    """cnn7 trained as `tests/test_models.py`'s fixture trains it: 448
    cluster images at hw 16, 240 steps of 64, noise 0.15 after a clean
    half."""
    x, y = cluster_images(torch.Generator().manual_seed(0), 448, hw=16)
    xt, yt = cluster_images(torch.Generator().manual_seed(99), 128, hw=16)
    params = cnn7.init_full(torch.Generator().manual_seed(1), x[:2])
    params, losses = train(torch.Generator().manual_seed(2), params,
                           cnn7.apply, (x, y), steps=240, batch=64,
                           noise_frac=0.15)
    return params, losses, (x, y), (xt, yt)


@pytest.mark.slow
def test_cnn7_learns_and_is_noise_resilient(cnn_setup):
    params, losses, _, (xt, yt) = cnn_setup
    assert losses[-1] < losses[0]
    with torch.no_grad():
        acc = float(accuracy(cnn7.apply(params, xt), yt))
    assert acc > 0.7
    sweep = eval_under_noise(torch.Generator().manual_seed(3), params,
                             cnn7.apply, (xt, yt), [0.0, 0.1])
    assert sweep[0.1] > 0.55          # paper Fig. 3e structure


@pytest.mark.slow
def test_cnn7_chip_accuracy_close_to_software(cnn_setup):
    params, _, (x, _), (xt, yt) = cnn_setup
    cfg = CIMConfig(in_bits=4, out_bits=8)
    with torch.no_grad():
        states = cnn7.deploy(params, cfg, x[:24],
                             generator=torch.Generator().manual_seed(4))
        soft = float(accuracy(cnn7.apply(params, xt[:96]), yt[:96]))
        chip = float(accuracy(cnn7.chip_apply(states, params, xt[:96], cfg),
                              yt[:96]))
    assert chip > soft - 0.3
    assert chip > 0.4
