"""Port parity, chip-in-the-loop training: cnn7's staged interface
(`deploy_upto`, `chip_prefix`, `soft_suffix`), ResNet-20's partial
deploy (`deploy(upto=)`), and `train/chip_in_loop.progressive_finetune`,
against the JAX reference at hw 8; then the reference's behavioural test
(`tests/test_chip_in_loop.py`: on the Fig. 3f chip, IR drop 4e-5 and
ADC offset spread 0.004, fine-tuning does not lose accuracy).

Rules: `ideal` programming draws nothing, so deploys agree to f32
rounding of the calibration sums (conductances rtol 1e-6, ADC steps
1e-5). A chip layer, given the reference's input, returns the
reference's output except where an ADC count sits on a .5 boundary (one
count's step there, `matrix_boundary_counts`); a stage's activation is
equal wherever no layer before it had such a boundary. The software
suffix is float: rtol 1e-5.
"""
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch

from repro_torch.convert import chip_states_from_numpy, params_from_numpy
from repro_torch.core.quant import quantize_to_int
from repro_torch.core.types import CIMConfig, NonIdealityConfig
from repro_torch.data import cluster_images
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.models import cnn7, nn, resnet20
from repro_torch.train.chip_in_loop import (progressive_finetune,
                                            stage_generator)
from repro_torch.train.noisy import accuracy, train

HW = 8
CFG = CIMConfig(in_bits=4, out_bits=8)
FIG3F = CIMConfig(in_bits=4, out_bits=8,
                  nonideal=NonIdealityConfig(ir_drop_alpha=4e-5,
                                             adc_offset_sigma=0.004))
RES_UPTO = 10                  # stem, stage 0, s1b0's c1, c2 and proj


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's long loops of small eager
    ops: the suite runs in several processes at once, and more threads
    per process only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_staged():
    """The reference's cnn7 (hw 8) deployed `ideal` up to every stage on 2
    calibration images, each stage's chip activation and software suffix
    on 2 more, the chip layers' (input, output) in call order, and
    ResNet-20's ideal deploy up to RES_UPTO layers."""
    jax = pytest.importorskip("jax")
    from repro.core.types import CIMConfig as JCfg
    from repro.data import cluster_images as jci
    from repro.models import cnn7 as jc, nn as jnn, resnet20 as jr
    jcfg = JCfg(in_bits=4, out_bits=8)
    xs, _ = jci(jax.random.PRNGKey(0), 4, hw=HW)
    params = jc.init_full(jax.random.PRNGKey(1), xs[:2])
    states = jc.deploy_upto(jax.random.PRNGKey(2), params, jcfg, xs[:2],
                            jc.N_STAGES, mode="ideal")
    calls = []
    real = jnn.chip_linear

    def record(cl, x, cfg, key=None, seed=0):
        y = real(cl, x, cfg, key=key, seed=seed)
        calls.append((id(cl), np.asarray(x), np.asarray(y)))
        return y
    jnn.chip_linear = record
    try:
        prefix = [np.asarray(jc.chip_prefix(states, params, xs[2:], k, jcfg))
                  for k in range(1, jc.N_STAGES + 1)]
    finally:
        jnn.chip_linear = real
    names = {id(s): n for n, s in states.items()}
    suffix = [np.asarray(jc.soft_suffix(params, h, k))
              for k, h in enumerate(prefix, 1)]
    xr, _ = jci(jax.random.PRNGKey(3), 2, hw=HW, channels=3)
    rparams = jr.init(jax.random.PRNGKey(4))
    rstates = jr.deploy(jax.random.PRNGKey(5), rparams, jcfg, xr,
                        mode="ideal", upto=RES_UPTO)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"params": tree(params), "x_cal": np.asarray(xs[:2]),
            "x": np.asarray(xs[2:]), "states": tree(states),
            "prefix": prefix, "suffix": suffix,
            "calls": [(names[i], x, y) for i, x, y in calls],
            "rparams": tree(rparams), "rx": np.asarray(xr),
            "rstates": tree(rstates), "rnames": jr.conv_layers(rparams)}


def _hits(cl, x):
    """Per output, the ADC .5-boundary hits of chip layer `cl` on x."""
    lay = cl.layer
    ones = cl.alpha.expand(x.shape[0], cl.bias_rows)
    x_int, scale = quantize_to_int(torch.cat([x, ones], -1), lay.in_alpha,
                                   CFG.in_bits, signed=True)
    hits = to_numpy(K.matrix_boundary_counts(
        x_int.float(), lay.g_pos - lay.g_neg, 1.0 / lay.norm, lay.v_decr,
        v_read=CFG.v_read))
    step = to_numpy(lay.v_decr * lay.norm * lay.w_max * scale
                    / (CFG.v_read * CFG.device.g_max))
    return hits, step


def _assert_same_states(got, want):
    assert sorted(got) == sorted(want)
    for n, s in got.items():
        w = want[n]
        assert s.bias_rows == int(w.bias_rows), n
        np.testing.assert_allclose(to_numpy(s.layer.g_pos),
                                   np.asarray(w.layer.g_pos), rtol=1e-6,
                                   err_msg=n)
        np.testing.assert_allclose(float(s.layer.v_decr),
                                   float(w.layer.v_decr), rtol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("upto", [1, 3, 6, 7])
def test_deploy_upto_ideal_matches_reference(ref_staged, upto):
    """The first `upto` stages (the fc only at 7), each calibrated on the
    chip outputs before it: the reference's full deploy's first stages."""
    params = params_from_numpy(ref_staged["params"])
    got = cnn7.deploy_upto(params, CFG, to_torch(ref_staged["x_cal"]), upto,
                           mode="ideal")
    names = [f"conv{i}" for i in range(min(upto, 6))] + \
        (["fc"] if upto >= 7 else [])
    _assert_same_states(got, {n: ref_staged["states"][n] for n in names})


def test_chip_layers_match_reference(ref_staged):
    """Every stage's chip layer on the carried-across ideal states, given
    the reference's input at that layer: the counts rule."""
    states = chip_states_from_numpy(ref_staged["states"])
    for lname, x, want in ref_staged["calls"]:
        cl, xt = states[lname], to_torch(x)
        got = to_numpy(nn.chip_linear(cl, xt, CFG))
        hits, step = _hits(cl, xt)
        clean = hits == 0
        np.testing.assert_array_equal(got[clean], want[clean])
        assert np.all(np.abs(got - want) <= hits * step[None, :] * 1.001)


@pytest.mark.parametrize("stage", range(1, 8))
def test_chip_prefix_and_soft_suffix_match_reference(ref_staged, stage,
                                                     monkeypatch):
    """chip_prefix at every stage on the carried-across states: every
    chip layer's input equals the reference's after input quantization,
    except a value on a quantizer tie (one level, after a boundary count
    upstream); with no such move the stage's activation is the
    reference's. soft_suffix from the reference's activation at that
    stage to the logits: rtol 1e-5."""
    params = params_from_numpy(ref_staged["params"])
    states = chip_states_from_numpy(ref_staged["states"])
    seen = []
    real = nn.chip_linear

    def record(cl, x, cfg, seed=0, impl="auto", generator=None):
        seen.append(x)
        return real(cl, x, cfg, seed=seed, impl=impl, generator=generator)
    monkeypatch.setattr(nn, "chip_linear", record)
    got = to_numpy(cnn7.chip_prefix(states, params,
                                    to_torch(ref_staged["x"]), stage, CFG))
    want = ref_staged["prefix"][stage - 1]
    assert got.shape == want.shape
    first = stage * (stage - 1) // 2      # the reference's calls, stage k
    moved = 0
    for x, (lname, x_ref, _) in zip(seen, ref_staged["calls"][first:]):
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
    assert len(seen) == stage
    if moved == 0:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if stage == 7:
        assert np.array_equal(got.argmax(-1), want.argmax(-1))
    logits = cnn7.soft_suffix(params, to_torch(want), stage)
    np.testing.assert_allclose(to_numpy(logits),
                               ref_staged["suffix"][stage - 1], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("upto", [1, 8, 9, RES_UPTO])
def test_resnet20_deploy_upto_ideal_matches_reference(ref_staged, upto):
    """ResNet-20's partial deploy stops at the first layer past `upto`, in
    conv_layers order (upto 9 stops before s1b0's projection, which the
    walk touches after c2): the reference's deploy's first layers."""
    params = params_from_numpy(ref_staged["rparams"])
    got = resnet20.deploy(params, CFG, to_torch(ref_staged["rx"]),
                          mode="ideal", upto=upto)
    names = ref_staged["rnames"][:upto]
    assert list(got) == names
    _assert_same_states(got, {n: ref_staged["rstates"][n] for n in names})


def test_resnet20_deploy_upto_covers_every_cut():
    """At every cut the states are the first layers of conv_layers, and
    the first ones equal the full deploy's (one generator, drawn in
    order)."""
    gen = torch.Generator().manual_seed(0)
    x, _ = cluster_images(gen, 2, hw=HW, channels=3)
    params = resnet20.init(gen)
    names = resnet20.conv_layers(params)
    full = resnet20.deploy(params, CFG, x,
                           generator=torch.Generator().manual_seed(1))
    for upto in range(len(names) + 1):
        got = resnet20.deploy(params, CFG, x, upto=upto,
                              generator=torch.Generator().manual_seed(1))
        assert list(got) == names[:upto]
        for n in got:
            assert torch.equal(got[n].layer.g_pos, full[n].layer.g_pos)


# -------------------------------------------------- progressive fine-tuning

def _finetune(params, x, y, cfg, n_stages=7, ft_steps=2, seed=0,
              record=None):
    def deploy(g, p, c, xc, upto):
        if record is not None:
            record.append((g.get_state(), p, xc, upto))
        return cnn7.deploy_upto(p, c, xc, upto, generator=g)
    return progressive_finetune(
        torch.Generator().manual_seed(seed), params, cfg, x, y,
        deploy_upto=deploy,
        chip_prefix=lambda s, p, xx, upto: cnn7.chip_prefix(s, p, xx, upto,
                                                            cfg),
        soft_suffix=cnn7.soft_suffix, n_stages=n_stages, noise_frac=0.1,
        ft_steps=ft_steps, lr=5e-4, batch=8)


def test_each_stage_reprograms_the_prefix():
    """The reference's per-stage re-split key, kept: every stage programs
    the prefix with its own generator, so conv0's relaxed conductances
    differ between stages; one stage generator gives one result."""
    gen = torch.Generator().manual_seed(0)
    x, y = cluster_images(gen, 16, hw=HW)
    params = cnn7.init_full(gen, x[:2])
    record = []
    _finetune(params, x, y, CFG, n_stages=3, record=record)
    conv0 = []
    for state, p, xc, upto in record:
        g = torch.Generator()
        g.set_state(state)
        a = cnn7.deploy_upto(p, CFG, xc, upto, generator=g)
        g.set_state(state)
        b = cnn7.deploy_upto(p, CFG, xc, upto, generator=g)
        assert all(torch.equal(a[n].layer.g_pos, b[n].layer.g_pos)
                   for n in a)
        conv0.append(a["conv0"].layer.g_pos)
    assert not torch.equal(conv0[0], conv0[1])
    assert not torch.equal(conv0[1], conv0[2])


def test_finetune_never_touches_programmed_stages():
    """Stage k's fine-tuning steps only the suffix: the weights and PACT
    clips of stages before k are those stage k programmed; the suffix
    moves; a run repeats per generator seed."""
    gen = torch.Generator().manual_seed(1)
    x, y = cluster_images(gen, 16, hw=HW)
    params = cnn7.init_full(gen, x[:2])
    record = []
    _, p3, accs = _finetune(params, x, y, CFG, n_stages=3, record=record)
    assert len(accs) == 3
    seen = [r[1] for r in record] + [p3]      # params at each deploy, final
    for k in range(1, 4):
        before, after = seen[k - 1], seen[k]
        for i in range(k):
            assert torch.equal(after[f"conv{i}"]["w"],
                               before[f"conv{i}"]["w"])
        assert torch.equal(after["alpha"][:k], before["alpha"][:k])
        assert not torch.equal(after["fc"]["w"], before["fc"]["w"])
    states, p7, _ = _finetune(params, x, y, CFG, seed=2)
    assert sorted(states) == [f"conv{i}" for i in range(6)] + ["fc"]
    _, p7b, _ = _finetune(params, x, y, CFG, seed=2)
    assert all(torch.equal(p7[k]["w"], p7b[k]["w"]) for k in ("conv5", "fc"))


def test_stage_generator_is_a_fresh_draw():
    g = torch.Generator().manual_seed(3)
    a, b = stage_generator(g), stage_generator(g)
    assert a.initial_seed() != b.initial_seed()


def finetune_gains(seeds):
    """The reference's chip-in-the-loop test at its sizes (hw 12, 256
    training images, 120 noisy steps, 192 images over 7 stages of 25
    steps at lr 5e-4) in the port: per chip seed, the Fig. 3f chip's test
    accuracy deployed without and with progressive fine-tuning."""
    x, y = cluster_images(torch.Generator().manual_seed(0), 256, hw=12)
    xt, yt = cluster_images(torch.Generator().manual_seed(99), 128, hw=12)
    params = cnn7.init_full(torch.Generator().manual_seed(1), x[:2])
    params, _ = train(torch.Generator().manual_seed(2), params, cnn7.apply,
                      (x, y), steps=120, batch=64, noise_frac=0.1)
    out = []
    for seed in seeds:
        with torch.no_grad():
            states0 = cnn7.deploy_upto(
                params, FIG3F, x[:24], cnn7.N_STAGES,
                generator=torch.Generator().manual_seed(seed))
            no_ft = float(accuracy(cnn7.chip_prefix(
                states0, params, xt, cnn7.N_STAGES, FIG3F), yt))
        states, ft_params, accs = progressive_finetune(
            torch.Generator().manual_seed(seed), dict(params), FIG3F,
            x[:192], y[:192],
            deploy_upto=lambda g, p, c, xc, upto: cnn7.deploy_upto(
                p, c, xc, upto, generator=g),
            chip_prefix=lambda s, p, xx, upto: cnn7.chip_prefix(
                s, p, xx, upto, FIG3F),
            soft_suffix=cnn7.soft_suffix, n_stages=cnn7.N_STAGES,
            noise_frac=0.1, ft_steps=25, lr=5e-4)
        assert len(accs) == cnn7.N_STAGES
        with torch.no_grad():
            ft = float(accuracy(cnn7.chip_prefix(
                states, ft_params, xt, cnn7.N_STAGES, FIG3F), yt))
        out.append((no_ft, ft))
    return out


def reference_finetune_gains(seeds):
    """`finetune_gains` in the JAX package, as its own test runs it (the
    chip of seed s: `PRNGKey(s)`)."""
    import jax
    from repro.core.types import CIMConfig as JCfg, NonIdealityConfig as JNi
    from repro.data import cluster_images as jci
    from repro.models import cnn7 as jc
    from repro.train.chip_in_loop import progressive_finetune as jft
    from repro.train.noisy import accuracy as jacc, train as jtrain
    cfg = JCfg(in_bits=4, out_bits=8,
               nonideal=JNi(ir_drop_alpha=4e-5, adc_offset_sigma=0.004))
    x, y = jci(jax.random.PRNGKey(0), 256, hw=12)
    xt, yt = jci(jax.random.PRNGKey(99), 128, hw=12)
    params = jc.init_full(jax.random.PRNGKey(1), x[:2])
    params, _ = jtrain(jax.random.PRNGKey(2), params, jc.apply, (x, y),
                       steps=120, batch=64, noise_frac=0.1)
    out = []
    for seed in seeds:
        key = jax.random.PRNGKey(seed)
        states0 = jc.deploy_upto(jax.random.fold_in(key, 0), params, cfg,
                                 x[:24], jc.N_STAGES)
        no_ft = float(jacc(jc.chip_prefix(states0, params, xt, jc.N_STAGES,
                                          cfg), yt))
        states, ft_params, _ = jft(
            key, dict(params), cfg, x[:192], y[:192],
            deploy_upto=lambda k, p, c, xc, upto: jc.deploy_upto(
                k, p, c, xc, upto),
            chip_prefix=lambda s, p, xx, upto: jc.chip_prefix(s, p, xx, upto,
                                                              cfg),
            soft_suffix=jc.soft_suffix, n_stages=jc.N_STAGES,
            noise_frac=0.1, ft_steps=25, lr=5e-4)
        out.append((no_ft, float(jacc(jc.chip_prefix(
            states, ft_params, xt, jc.N_STAGES, cfg), yt))))
    return out


@pytest.mark.slow
def test_progressive_finetune_recovers_accuracy():
    """The reference's test at its sizes on the Fig. 3f chip, through the
    bit-serial oracle: fine-tuned >= not. The gain varies from chip to
    chip (each draws its own relaxation and offsets) in both packages
    (`python tests/test_torch_chip_in_loop.py` prints it per chip seed
    for each), so the claim is held on the mean over three chips."""
    no_ft, ft = zip(*finetune_gains((5, 6, 7)))
    assert sum(ft) >= sum(no_ft), (no_ft, ft)


@pytest.mark.cuda
def test_deploy_upto_kernel_matches_plain_on_card():
    """cnn7 at 28x28 on the card: every stage's relaxed deploy and chip
    prefix through the kernel equal their plain reruns from the same
    generator state."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    x, _ = cluster_images(gen, 24, hw=28)
    params = cnn7.init_full(gen, x[:2])
    for upto in range(1, cnn7.N_STAGES + 1):
        state = gen.get_state()
        a = cnn7.deploy_upto(params, CFG, x[:8], upto, generator=gen)
        gen.set_state(state)
        b = cnn7.deploy_upto(params, CFG, x[:8], upto, generator=gen,
                             impl="plain")
        assert all(torch.equal(a[n].layer.v_decr, b[n].layer.v_decr)
                   for n in a)
        assert torch.equal(cnn7.chip_prefix(a, params, x[8:], upto, CFG),
                           cnn7.chip_prefix(a, params, x[8:], upto, CFG,
                                            impl="plain"))


if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(
        description="Per chip seed: the Fig. 3f chip's test accuracy "
        "without and with progressive fine-tuning, at the reference "
        "test's sizes, in the port and the JAX package (CPU).")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(5, 15)))
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    args = ap.parse_args()
    torch.set_num_threads(1)
    run = finetune_gains if args.package == "torch" \
        else reference_finetune_gains
    for seed, (no_ft, ft) in zip(args.seeds, run(args.seeds)):
        print(json.dumps({"package": args.package, "seed": seed,
                          "no_ft": no_ft, "ft": ft, "gain": ft - no_ft}))
