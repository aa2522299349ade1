"""Weights carried across from the JAX reference.

`params_from_numpy` takes the reference's params as the nested dict of
numpy arrays that `jax.tree_util.tree_map(np.asarray, params)` gives and
returns the port's params in the same layout (per-layer weights stacked
(L, in, out) under 'layers').
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree):
    """Nested dict of numpy arrays -> the same structure of CPU tensors;
    floating arrays become float32 (the CIM serving dtype). Move the
    result with `.to(device)` leaf by leaf."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    a = np.array(tree)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    return torch.from_numpy(a)
