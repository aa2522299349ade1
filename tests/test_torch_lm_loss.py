"""Port parity, the LM loss and its gradients (`repro_torch/models/
transformer.lm_loss`, autograd through every family's `lm_forward`,
`launch/steps.loss_and_grads`): `jax.value_and_grad(T.lm_loss)` of the
reference and the port on the CPU, from the same numpy params
(`params_from_numpy`; the qwen family's and internvl2's QKV biases made
nonzero, `with_biases`), tokens and stub frontend embeddings, at the
SMOKE config of each of the ten archs in float32.

Tolerances: the loss within LOSS_RTOL = 1e-5 (one f32 log-softmax mean
taken in another order); every gradient leaf within rtol GRAD_RTOL = 1e-4
and atol GRAD_ATOL = 1e-6 of the reference's global gradient norm
(`tests/test_torch_train.py`'s bound), except zamba2-7b's at 1e-5 of it:
its six Mamba-2 layers amplify f32 rounding, and its gradients move by up
to 8e-5 of a leaf's largest entry between the port's own float32 and
float64 runs (the reference's f32 ones by up to 9e-5 from the port's
float64; measured on a CPU).

MoE routing near-ties (`test_torch_moe.near_ties`): a token whose k-th and
(k+1)-th router logits lie within f32 rounding may be routed to another
expert by each package. Such positions, and the rest of their sequence,
are computed from the port's router inputs and left out: the loss is then
the mean NLL over the kept positions in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import frontend_inputs, to_numpy, to_torch, with_biases
from test_torch_moe import _lm_ties

from repro import configs as jconfigs
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tT
from repro_torch.train.noisy import value_and_grad

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = {"zamba2-7b": 1e-5}           # of the global norm; default 1e-6
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the recurrent scans are loops of small eager ops,
    and the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def named_leaves(tree, pre=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in named_leaves(tree[k], f"{pre}/{k}")]
    return [(pre, tree)]


def _inputs(arch, seed=0):
    """The reference's f32 smoke config and params, the port's config, and
    one batch as numpy: tokens (B, S + 1) and the frontend embeddings."""
    jc = jconfigs.get(arch, smoke=True).replace(dtype=jnp.float32)
    tc = tconfigs.get(arch, smoke=True).replace(dtype=torch.float32)
    params = with_biases(jT.init_params(jax.random.PRNGKey(2), jc))
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jc.vocab, (B, S + 1)),
             **frontend_inputs(jc, B, S)}
    return jc, tc, params, batch


def _masked_nll(logits, targets, keep, xp):
    """Mean NLL over the kept positions (numpy bool mask), in `xp`'s
    arithmetic (jnp or torch), as lm_loss takes it."""
    if xp is jnp:
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
        return jnp.sum(jnp.where(keep, nll, 0.0)) / keep.sum()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return torch.sum(torch.where(torch.from_numpy(keep), nll, 0.0)) \
        / int(keep.sum())


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_lm_loss_and_grads_match_reference(arch):
    """lm_loss and the gradient of every param leaf: dense (QKV bias,
    MQA, gemma2's softcaps and local windows), MoE (sort dispatch at the
    smoke capacity; llama4's interleave), rwkv6, zamba2's Mamba-2 layers
    and shared block, internvl2's vision prefix (its logits dropped;
    vis_proj unread, a zero gradient in both) and seamless's encoder and
    cross-attention."""
    jc, tc, params, batch = _inputs(arch)
    jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
          for k, v in batch.items()}
    tb = {k: to_torch(v).long() if k == "tokens" else to_torch(v)
          for k, v in batch.items()}
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    keep = np.ones((B, S), bool)
    if tc.n_experts:
        keep = _lm_ties(tc, tparams, tb["tokens"][:, :-1], tc.moe_dropless)
        assert keep.mean() >= 0.75
    if keep.all():
        want_l, want_g = jax.jit(jax.value_and_grad(jT.lm_loss),
                                 static_argnums=2)(params, jb, jc)
        got_l, got_g = tsteps.loss_and_grads(tparams, tb, tc)
    else:
        extra = {k: v for k, v in jb.items() if k != "tokens"}

        def jloss(p):
            logits = jT.lm_forward(p, jb["tokens"][:, :-1], jc, **extra)
            return _masked_nll(logits, jb["tokens"][:, 1:], keep, jnp)

        def tloss(p):
            logits = tT.lm_forward(p, tb["tokens"][:, :-1], tc,
                                   **{k: v for k, v in tb.items()
                                      if k != "tokens"})
            return _masked_nll(logits, tb["tokens"][:, 1:], keep, torch), \
                None
        want_l, want_g = jax.jit(jax.value_and_grad(jloss))(params)
        got_l, _, got_g = value_and_grad(tloss, tparams)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=LOSS_RTOL)
    want = named_leaves(jax.tree_util.tree_map(np.asarray, want_g))
    got = named_leaves(got_g)
    assert [k for k, _ in got] == [k for k, _ in want]
    gnorm = np.sqrt(sum(float(np.sum(np.square(w.astype(np.float64))))
                        for _, w in want))
    atol = GRAD_ATOL.get(arch, 1e-6) * gnorm
    for (k, g), (_, w) in zip(got, want):
        assert g.dtype == torch.float32, k
        np.testing.assert_allclose(to_numpy(g), w, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"{arch} grad {k}")


def test_lm_loss_is_mean_nll_of_the_log_softmax():
    """lm_loss against its definition on the port's own logits: the mean
    over (B, S) of -log softmax(logits)[next token], taken in float64."""
    _, tc, params, batch = _inputs("qwen2-72b", seed=3)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    toks = to_torch(batch["tokens"]).long()
    logits = tT.lm_forward(tparams, toks[:, :-1], tc).to(torch.float64)
    want = -torch.gather(torch.log_softmax(logits, -1), -1,
                         toks[:, 1:, None]).mean()
    got = tT.lm_loss(tparams, {"tokens": toks}, tc)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
