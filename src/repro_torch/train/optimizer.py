"""Optimizers (PyTorch port of `repro/train/optimizer.py`): AdamW,
SGD-momentum, the cosine schedule and global-norm clipping, as plain
functions over nested dicts of tensors.

`torch.optim` is not used: these follow the reference's update order
operation for operation, so one step of the port equals one of the
reference to float32 rounding. Leaves are visited in sorted key order, as
`jax.tree_util` flattens a dict (tuples and lists in order).
"""
from __future__ import annotations

import math

import torch


def tree_leaves(tree):
    """The leaves of nested dicts, tuples and lists: dicts in sorted key
    order, sequences in order (`jax.tree_util`'s order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure), as a new tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """The structure of `tree` holding `leaves` (in `tree_leaves`
    order)."""
    return _fill(tree, iter(leaves))


def _fill(t, it):
    # a module-level function: a recursive closure would form a reference
    # cycle holding the iterator, and with it `leaves` (a step's gradients,
    # 8.5 GB at qwen2-72b's full width), until the cyclic collector ran
    if isinstance(t, dict):
        return {k: _fill(t[k], it) for k in sorted(t)}
    if isinstance(t, (tuple, list)):
        return type(t)(_fill(x, it) for x in t)
    return next(it)


def clip_grads(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / (global norm + 1e-9)).
    Returns (clipped grads, global norm)."""
    gnorm = torch.sqrt(sum(torch.sum(g ** 2) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def cosine_lr(base_lr: float, step: int, total_steps: int,
              warmup: int = 0) -> float:
    """Linear warm-up over `warmup` steps, then a cosine decay to 0 at
    `total_steps`."""
    warm = min(step / max(warmup, 1), 1.0)
    prog = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0), 1.0)
    return base_lr * warm * 0.5 * (1.0 + math.cos(math.pi * prog))


# ------------------------------------------------------------------- AdamW

def adamw_init(params):
    """Zero moments and step count (on the params' device)."""
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(grads, state, params, lr, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
    """One AdamW step. Returns (new params, new state)."""
    t = state["t"] + 1
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
    # the bias corrections in float32, as the reference's b ** t
    tf = t.to(torch.float32)
    c1, c2 = (1 - torch.pow(torch.full((), b, dtype=torch.float32,
                                       device=t.device), tf)
              for b in (b1, b2))
    new_params = tree_map(
        lambda p, m_, v_: p - lr * ((m_ / c1) / (torch.sqrt(v_ / c2) + eps)
                                    + weight_decay * p),
        params, m, v)
    return new_params, {"m": m, "v": v, "t": t}


# ------------------------------------------------------------ SGD momentum

def sgdm_init(params):
    return {"mom": tree_map(torch.zeros_like, params)}


def sgdm_update(grads, state, params, lr, momentum: float = 0.9,
                weight_decay: float = 0.0):
    """One SGD-momentum step. Returns (new params, new state)."""
    mom = tree_map(lambda m, g: momentum * m + g, state["mom"], grads)
    new_params = tree_map(lambda p, m: p - lr * (m + weight_decay * p),
                          params, mom)
    return new_params, {"mom": mom}
