"""Weights and chip state carried across from the JAX reference.

`params_from_numpy` takes the reference's params as the nested dict of
numpy arrays that `jax.tree_util.tree_map(np.asarray, params)` gives (the
transformer's stacked layers with the qwen family's QKV biases `bq` /
`bk` / `bv` and an encoder-decoder's cross-attention `xln` / `xw*`, its
`enc_layers` stack and `ln_enc`, a VLM's `vis_proj`; the recurrent archs'
trees — rwkv6's mixes `mu` / `cmu` and bonus `u`, mamba2's `a_log`,
`dt_bias` and `dd`, zamba2's unstacked `shared_attn` —, the CNNs' conv /
fc / BN dicts and PACT clip vectors) and returns the port's params in the
same layout. `opt_state_from_numpy` does the same for the reference's
AdamW state (`launch/steps.adamw_init_f32` / `adamw_apply`: f32 moments
"m" and "v" in the params' layout and the int32 step count "t"), so a
whole reference train state carries across.

`chip_states_from_numpy` takes a dict of the reference's deployed
`ChipLinear`s (`cnn7.deploy` / `deploy_upto`, `resnet20.deploy`,
`lstm.deploy`), their arrays as numpy, and returns the port's: the same
programmed conductances, normalizers, ADC steps and measured ADC offsets,
which the two packages cannot draw alike for `relaxed` or `writeverify`
programming or an offset spread, prepared for the kernel
(`core.cim.prepare`); `layer_from_numpy` does it for one `CIMLayer`.
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


def opt_state_from_numpy(state):
    """The reference's {"m", "v", "t"} AdamW state (numpy arrays) -> the
    port's: f32 moment trees and a 0-d int32 t, CPU tensors."""
    return {"m": params_from_numpy(state["m"]),
            "v": params_from_numpy(state["v"]),
            "t": torch.tensor(int(np.asarray(state["t"])),
                              dtype=torch.int32)}


def layer_from_numpy(layer):
    """A reference CIMLayer (arrays that convert with np.asarray) -> the
    port's, float32 CPU tensors, prepared (gd, 1 / norm and the offsets
    in counts formed)."""
    from .core.cim import LAYER_FIELDS, CIMLayer, prepare
    return prepare(CIMLayer(*(torch.from_numpy(
        np.array(getattr(layer, f), dtype=np.float32))
        for f in LAYER_FIELDS)))


def chip_states_from_numpy(states):
    """name -> reference ChipLinear (fields layer, bias_rows, alpha,
    signed) -> name -> the port's `models.nn.ChipLinear` of float32 CPU
    tensors."""
    from .models.nn import ChipLinear
    return {name: ChipLinear(
        layer_from_numpy(s.layer), int(np.asarray(s.bias_rows)),
        torch.from_numpy(np.array(s.alpha, dtype=np.float32)),
        bool(np.asarray(s.signed))) for name, s in states.items()}
