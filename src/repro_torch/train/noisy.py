"""Noise-resilient NN training (PyTorch port of `repro/train/noisy.py`;
paper Fig. 3c, Extended Data Fig. 6).

Train with float weights while injecting Gaussian noise, a fraction of
each layer's max |w| (`core.noise.weight_noise`), into every CIM-bound
weight matrix on each forward pass; the train-time noise is higher than
the ~10% test-time level (paper: 20% for CNNs, 15% for the LSTM).

A generic trainer for any (init, apply) model of `repro_torch.models`:
`apply_fn(params, x, generator=, noise_frac=, train=)` returns logits, or
(logits, params with updated BN statistics) when `has_bn_state`. Params
are nested dicts of tensors; a step takes the gradient of every leaf by
autograd, clips the global norm to 1 and takes one AdamW step. The
noise, and the batches of `train`, come from an explicit
`torch.Generator` where the reference splits keys.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from .optimizer import (adamw_init, adamw_update, clip_grads, tree_leaves,
                        tree_unflatten)


def xent(logits, labels):
    """Mean cross-entropy of integer labels."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None].long()))


def accuracy(logits, labels):
    """Top-1 accuracy (a 0-d float32 tensor)."""
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))


def value_and_grad(loss_fn: Callable, params):
    """(loss, aux, grads) of `loss_fn(params) -> (loss, aux)`: gradients
    of every leaf of `params` (zero for a leaf the loss does not reach),
    taken on detached copies, so nothing outside keeps a graph."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, leaves))
        if loss.requires_grad:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        else:
            grads = (None,) * len(leaves)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), aux, tree_unflatten(params, grads)


def make_train_step(apply_fn: Callable, noise_frac: float, lr: float = 1e-3,
                    has_bn_state: bool = False, weight_decay: float = 1e-4):
    """step(params, opt_state, x, y, generator) -> (params, opt_state,
    loss, accuracy): one AdamW step on the clipped gradients. With BN
    state, the running mean / var the forward pass computed replace the
    optimizer's (they are statistics, not trained)."""

    def step(params, opt_state, x, y, generator=None):
        def loss_fn(p):
            out = apply_fn(p, x, generator=generator, noise_frac=noise_frac,
                           train=True)
            logits, new_p = out if has_bn_state else (out, None)
            return xent(logits, y), (logits.detach(), new_p)

        loss, (logits, new_p), grads = value_and_grad(loss_fn, params)
        with torch.no_grad():
            grads, _ = clip_grads(grads, 1.0)
            params2, opt_state = adamw_update(grads, opt_state, params, lr,
                                              weight_decay=weight_decay)
        if has_bn_state:
            # BN running stats come from the forward pass, not the gradients
            for k in params2:
                if isinstance(params2[k], dict) and "mean" in params2[k]:
                    params2[k] = dict(params2[k],
                                      mean=new_p[k]["mean"].detach(),
                                      var=new_p[k]["var"].detach())
        return params2, opt_state, loss, accuracy(logits, y)

    return step


def train(generator: torch.Generator, params, apply_fn: Callable,
          data: Tuple, steps: int, batch: int, noise_frac: float,
          lr: float = 1e-3, has_bn_state: bool = False,
          clean_warmup_frac: float = 0.5):
    """Epoch-free trainer over an in-memory dataset (x, y) on the
    generator's device; batch indices drawn with replacement.

    Noise-resilient recipe: the first `clean_warmup_frac` of the steps
    train clean at the full lr; the rest inject weight noise at 0.3 lr.
    Returns (params, per-step losses as floats)."""
    x, y = data
    n = x.shape[0]
    opt_state = adamw_init(params)
    warm = int(steps * clean_warmup_frac) if noise_frac > 0 else steps
    step_clean = make_train_step(apply_fn, 0.0, lr, has_bn_state)
    step_noisy = make_train_step(apply_fn, noise_frac, lr * 0.3,
                                 has_bn_state)
    losses = []
    for i in range(steps):
        idx = torch.randint(0, n, (batch,), generator=generator,
                            device=generator.device)
        fn = step_clean if i < warm else step_noisy
        params, opt_state, loss, _ = fn(params, opt_state, x[idx], y[idx],
                                        generator)
        losses.append(loss)
    return params, torch.stack(losses).tolist() if losses else []


def eval_under_noise(generator: torch.Generator, params, apply_fn: Callable,
                     data, noise_fracs, n_trials: int = 3,
                     has_bn_state: bool = False):
    """Extended Data Fig. 6 sweep: noise fraction -> accuracy under that
    inference-time weight noise, averaged over n_trials draws."""
    x, y = data
    out = {}
    with torch.no_grad():
        for nf in noise_fracs:
            accs = []
            for _ in range(n_trials):
                if has_bn_state:
                    logits, _ = apply_fn(params, x, generator=generator,
                                         noise_frac=float(nf), train=False)
                else:
                    logits = apply_fn(params, x, generator=generator,
                                      noise_frac=float(nf))
                accs.append(float(accuracy(logits, y)))
            out[float(nf)] = sum(accs) / len(accs)
    return out
