"""Port parity, the transformer's training modes (`repro_torch/models/
transformer.cim_linear`'s "noisy" and "chipsim" branches, `weight_noise`,
`noisy_weight`): the JAX reference and the port on the CPU, from the same
numpy params and tokens, at the f32 SMOKE configs.

noisy: eps is hash_normal at the weight's global (row, column)
coordinates, salts (seed, out); the port draws it in row blocks
(`NOISE_BLOCK_ELEMS`, patched small here so the blocks are exercised) and
gets the bits of one draw. The two packages' log and cos may round
differently: eps within EPS_ATOL = 1e-6 (4.8e-7 measured, a few f32 ulps
of values up to 4.5). The whole model teacher-forced (`lm_forward`) under
noisy within FLOAT_ATOL = 1e-5 (dense, MoE: `tests/test_torch_archs.py`'s
bound; MoE router near-ties left out as in `tests/test_torch_moe.py`) and
LOGIT_ATOL = 1e-4 (the recurrent archs: `tests/test_torch_recurrent.py`'s
bound); the gradient of lm_loss under noisy as `test_torch_lm_loss.py`
holds the float one.

chipsim: every call of `cim_linear` that the port's chipsim `lm_forward`
makes (each call site's seed, each layer's weight) is recorded and run
through the reference's `cim_linear` on the same input. The input grid is
the same IEEE arithmetic in both packages; the product is an f32 sum in
another order over a weight whose eps may differ by EPS_ATOL. So an
output agrees to the f32 rounding of its grid step, except where the
reference's level y / ymax * n_out lies within that error of a .5
boundary (computed from the inputs in float64: `_boundary`), where it may
move by one level. A level flip changes the next layer's input, so the
whole chipsim model is not compared end to end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch
from test_torch_moe import _lm_ties

from repro import configs as jconfigs
from repro.kernels.prng import hash_normal as jhash_normal
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tT

EPS_ATOL = 1e-6
FLOAT_ATOL = 1e-5
LOGIT_ATOL = 1e-4
MODE_ARCHS = ("gemma2-9b", "deepseek-moe-16b", "rwkv6-7b", "zamba2-7b")
B, S = 2, 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the recurrent scans are loops of small eager ops,
    and the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def small_noise_blocks(monkeypatch):
    """Draw eps in blocks of 1000 elements: a smoke weight spans several."""
    monkeypatch.setattr(tT, "NOISE_BLOCK_ELEMS", 1000)


def _configs(arch, mode):
    jc = jconfigs.get(arch, smoke=True).replace(dtype=jnp.float32,
                                                cim_mode=mode)
    tc = tconfigs.get(arch, smoke=True).replace(dtype=torch.float32,
                                                cim_mode=mode)
    return jc, tc


def _params(jc, seed=2):
    params = jT.init_params(jax.random.PRNGKey(seed), jc)
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            params))


@pytest.mark.parametrize("shape,seed", [((128, 256), 5), ((256, 128), 7),
                                        ((128, 552), 11), ((3, 2000), 1)])
def test_weight_noise_matches_reference(shape, seed):
    """eps against the reference's hash_normal(shape, seed, shape[-1]);
    the row-blocked draw equals the draw in one block bit for bit."""
    want = np.asarray(jhash_normal(shape, seed, shape[-1]))
    w = torch.zeros(shape)
    got = tT.weight_noise(w, seed)
    np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=EPS_ATOL)
    whole = tT.NOISE_BLOCK_ELEMS
    tT.NOISE_BLOCK_ELEMS = 1 << 30
    try:
        assert torch.equal(tT.weight_noise(w, seed), got)
    finally:
        tT.NOISE_BLOCK_ELEMS = whole
    assert tT.weight_noise(w.to(torch.bfloat16), seed).dtype == torch.bfloat16


def test_noisy_cim_linear_matches_reference():
    """noisy cim_linear is x @ (w + cim_noise * max|w| * eps) as the
    reference forms it: the weight within cim_noise * max|w| * EPS_ATOL
    (plus its f32 rounding), the product within the f32 rounding of a
    128-term dot; the same matrix at every call (the reference's quirk:
    eps depends on the call site's seed and the shape only)."""
    jc, tc = _configs("qwen2-72b", "noisy")
    rng = np.random.default_rng(0)
    w = (0.3 * rng.standard_normal((128, 256))).astype(np.float32)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    noise = tc.cim_noise * float(np.abs(w).max())
    wn = tT.noisy_weight(to_torch(w), tc, 5)
    want_wn = w + jc.cim_noise * np.abs(w).max() * np.asarray(
        jhash_normal(w.shape, 5, w.shape[-1]))
    np.testing.assert_allclose(to_numpy(wn), want_wn, rtol=2.0 ** -23,
                               atol=noise * EPS_ATOL)
    got = tT.cim_linear(to_torch(x), to_torch(w), tc, seed=5)
    assert torch.equal(got, to_torch(x) @ wn)
    want = np.asarray(jT.cim_linear(jnp.asarray(x), jnp.asarray(w), jc,
                                    seed=5))
    bound = 132 * 2.0 ** -23 * (np.abs(x) @ np.abs(want_wn)) \
        + noise * EPS_ATOL * np.abs(x).sum(1, keepdims=True)
    assert np.all(np.abs(to_numpy(got) - want) <= bound)
    assert torch.equal(wn, tT.noisy_weight(to_torch(w), tc, 5))
    assert not torch.equal(wn, tT.noisy_weight(to_torch(w), tc, 6))
    assert tc.cim_noise == jc.cim_noise == 0.1


@pytest.mark.parametrize("arch", MODE_ARCHS)
def test_noisy_lm_forward_matches_reference(arch):
    """The whole model teacher-forced under noisy: every dense, rwkv6 and
    mamba2 projection on its noisy weight (the routed and shared experts
    and the unembed float, as in the reference)."""
    jc, tc = _configs(arch, "noisy")
    params, tparams = _params(jc)
    tokens = np.random.default_rng(1).integers(0, jc.vocab, (B, S))
    want = np.asarray(jax.jit(lambda p, t: jT.lm_forward(p, t, jc))(
        params, jnp.asarray(tokens, jnp.int32)))
    ttok = to_torch(tokens).long()
    got = to_numpy(tT.lm_forward(tparams, ttok, tc))
    off = np.asarray(jax.jit(lambda p, t: jT.lm_forward(
        p, t, jc.replace(cim_mode="off")))(params,
                                          jnp.asarray(tokens, jnp.int32)))
    assert np.abs(want - off).max() > 100 * LOGIT_ATOL   # the noise is on
    keep = np.ones((B, S), bool)
    if tc.n_experts:
        keep = _lm_ties(tc, tparams, ttok, tc.moe_dropless)
        assert keep.mean() >= 0.75
    atol = LOGIT_ATOL if tc.rwkv or tc.ssm_state else FLOAT_ATOL
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=atol)


def test_moe_experts_stay_float_under_noisy():
    """moe_ffn under noisy equals moe_ffn off, in both packages: the
    routed and the shared experts keep their float matmuls."""
    jc, tc = _configs("deepseek-moe-16b", "noisy")
    params, tparams = _params(jc, 3)
    p = {k: v[0] for k, v in jax.tree_util.tree_map(
        np.asarray, params)["layers"].items()}
    x = np.random.default_rng(0).standard_normal(
        (2, 8, jc.d_model)).astype(np.float32)
    tp = params_from_numpy(p)
    got = tmoe.moe_ffn(tp, to_torch(x), tc)
    assert torch.equal(got, tmoe.moe_ffn(tp, to_torch(x),
                                         tc.replace(cim_mode="off")))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    want = np.asarray(jmoe.moe_ffn(jp, jnp.asarray(x), jc))
    assert np.array_equal(want, np.asarray(jmoe.moe_ffn(
        jp, jnp.asarray(x), jc.replace(cim_mode="off"))))


def test_noisy_lm_loss_grads_match_reference():
    """The gradient of lm_loss under noisy (through max|w| too) against
    jax.value_and_grad, qwen2-72b smoke: rtol 1e-4, atol 1e-6 of the
    global norm, as the float gradients."""
    jc, tc = _configs("qwen2-72b", "noisy")
    params, tparams = _params(jc)
    tokens = np.random.default_rng(2).integers(0, jc.vocab, (B, S + 1))
    want_l, want_g = jax.jit(jax.value_and_grad(jT.lm_loss),
                             static_argnums=2)(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)}, jc)
    got_l, got_g = tsteps.loss_and_grads(
        tparams, {"tokens": to_torch(tokens).long()}, tc)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    want = jax.tree_util.tree_map(np.asarray, want_g)
    gnorm = np.sqrt(sum(float(np.sum(np.square(w.astype(np.float64))))
                        for w in jax.tree_util.tree_leaves(want)))
    for k in sorted(want["layers"]):
        np.testing.assert_allclose(to_numpy(got_g["layers"][k]),
                                   want["layers"][k], rtol=1e-4,
                                   atol=1e-6 * gnorm, err_msg=k)
    for k in ("embed", "unembed", "ln_f"):
        np.testing.assert_allclose(to_numpy(got_g[k]), want[k], rtol=1e-4,
                                   atol=1e-6 * gnorm, err_msg=k)


def _boundary(x, w, cfg, seed):
    """(M, N) bool: outputs of chipsim cim_linear(x, w) whose reference
    level y / ymax * n_out lies within the two packages' f32 error of a .5
    boundary, in float64 from the inputs (the input grid is exact in both;
    the product's terms are summed in another order, over weights whose
    eps may differ by EPS_ATOL); the grid step ymax / n_out; and the
    bound, in grid steps, of an output off the boundaries (its level times
    the f32 error of ymax)."""
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    xmax = max(np.abs(x).max(), 1e-6)
    n_in = max((1 << (cfg.cim_in_bits - 1)) - 1, 1)
    xq = np.round(np.clip(x / np.float32(xmax), -1, 1) * n_in).astype(
        np.float64) * (np.float64(np.float32(xmax)) / n_in)
    wmax = np.abs(w64).max()
    eps = np.asarray(jhash_normal(w.shape, seed, w.shape[-1]), np.float64)
    wn = w64 + cfg.cim_noise * wmax * eps
    y = xq @ wn
    ymax = max(np.abs(y).max(), 1e-6)
    n_out = max((1 << (cfg.cim_out_bits - 1)) - 1, 1)
    lvl = np.abs(y) / ymax * n_out
    k = x.shape[-1]
    rel = 2 * (k + 4) * 2.0 ** -23       # of y, of ymax: f32 sums of k terms
    err = (k + 4) * 2.0 ** -23 * (np.abs(xq) @ np.abs(wn)) \
        + (np.abs(xq) @ np.full(w.shape, cfg.cim_noise * wmax * EPS_ATOL))
    tol = err / ymax * n_out + rel * lvl
    return np.abs(lvl - np.floor(lvl) - 0.5) <= tol, ymax / n_out, \
        n_out * rel


@pytest.mark.parametrize("arch", MODE_ARCHS)
def test_chipsim_calls_match_reference(arch, monkeypatch):
    """Every chipsim cim_linear call of the port's lm_forward against the
    reference's cim_linear on the same input: equal to the f32 rounding
    of the grid step off the boundaries, within one level on them; the
    model's logits finite."""
    _, tc = _configs(arch, "chipsim")
    jc = jconfigs.get(arch, smoke=True).replace(dtype=jnp.float32,
                                                cim_mode="chipsim")
    _, tparams = _params(jc)
    calls = []
    orig = tT.cim_linear

    def spy(x, w, cfg, *, seed=0, packed=None):
        y = orig(x, w, cfg, seed=seed, packed=packed)
        calls.append((to_numpy(x.reshape(-1, x.shape[-1])), to_numpy(w),
                      seed, to_numpy(y.reshape(-1, y.shape[-1]))))
        return y
    monkeypatch.setattr(tT, "cim_linear", spy)
    tokens = np.random.default_rng(4).integers(0, jc.vocab, (B, S))
    logits = tT.lm_forward(tparams, to_torch(tokens).long(), tc)
    assert logits.shape == (B, S, jc.vocab)
    assert bool(torch.isfinite(logits).all())
    assert len({c[2] for c in calls}) >= 3
    hits = 0
    for x, w, seed, got in calls:
        want = np.asarray(jT.cim_linear(jnp.asarray(x), jnp.asarray(w), jc,
                                        seed=seed))
        near, step, rel = _boundary(x, w, jc, seed)
        diff = np.abs(got.astype(np.float64) - want)
        assert np.all(diff[~near] <= rel * step), \
            (seed, float(diff[~near].max()), step)
        assert np.all(diff[near] <= step * (1 + 1e-5)), seed
        hits += int(near.sum())
    assert hits <= 0.01 * sum(c[3].size for c in calls)
