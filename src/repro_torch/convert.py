"""Weights and chip state carried across from the JAX reference.

`params_from_numpy` takes the reference's params as the nested dict of
numpy arrays that `jax.tree_util.tree_map(np.asarray, params)` gives (the
transformer's stacked layers, the CNNs' conv / fc / BN dicts and PACT clip
vectors) and returns the port's params in the same layout.

`chip_states_from_numpy` takes a dict of the reference's deployed
`ChipLinear`s (`cnn7.deploy`, `resnet20.deploy`), their arrays as numpy,
and returns the port's: the same programmed conductances, normalizers and
ADC steps, which the two packages cannot draw alike for `relaxed` or
`writeverify` programming, prepared for the kernel (`core.cim.prepare`).
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


def chip_states_from_numpy(states):
    """name -> reference ChipLinear (fields layer, bias_rows, alpha,
    signed; layer a CIMLayer whose arrays convert with np.asarray) -> name
    -> the port's `models.nn.ChipLinear` of float32 CPU tensors."""
    from .core.cim import LAYER_FIELDS, CIMLayer, prepare
    from .models.nn import ChipLinear

    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {}
    for name, s in states.items():
        layer = prepare(CIMLayer(*(f32(getattr(s.layer, f))
                                   for f in LAYER_FIELDS)))
        out[name] = ChipLinear(layer, int(np.asarray(s.bias_rows)),
                               f32(s.alpha), bool(np.asarray(s.signed)))
    return out
