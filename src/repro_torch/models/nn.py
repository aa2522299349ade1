"""Packed CIM serving of transformer projections (PyTorch port of the
packed half of `repro/models/nn.py`).

`deploy_transformer_cim` compiles each layer's dense projections onto one
simulated chip (`core.cim.compile_chip`) and returns params augmented
with '<name>_cim' entries: a list with one PackedCIMLayer per layer, which
`models/transformer.cim_linear` serves through `packed_linear`.

At one tensor-parallel shard the reference compiles every projection as
one replicated ("none") stack; that is all the port does. Sharded deploys
(a 'model' width above 1, `ShardedPackedLayer`) wait for ROADMAP A13.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..core import cim as cim_api
from ..core.types import CIMConfig, CoreSpec
from ..core.verify import verify_deployed

# Dense-block projections the packed serving path covers (the reference's
# shared-expert keys join with MoE, ROADMAP A7).
PACKED_PROJ_KEYS = ("wq", "wk", "wv", "wo", "w_g", "w_i", "w_o")


def deploy_packed_stack(stacked_w: Dict[str, torch.Tensor], ccfg: CIMConfig,
                        *, mode: str = "ideal", in_alpha: float = 3.0,
                        spec: Optional[CoreSpec] = None,
                        x_cal: Optional[List[Dict[str, Any]]] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, List[cim_api.PackedCIMLayer]]:
    """Compile a layer stack's weight matrices into packed chips.

    stacked_w: name -> (L, R, C) stacked weights. Each layer index gets
    its own `compile_chip` run (one chip per transformer layer).
    x_cal: optional per-layer list of name -> (B_cal, R) calibration
    activations (the parity seam with the reference, whose batches come
    from jax.random); without it the batches are drawn from `generator`.
    Returns name -> [PackedCIMLayer per layer].
    """
    names = sorted(stacked_w)
    n_layers = stacked_w[names[0]].shape[0]
    if x_cal is not None and len(x_cal) != n_layers:
        raise ValueError(f"x_cal has {len(x_cal)} layers, the stack "
                         f"{n_layers}")
    spec = spec or CoreSpec()
    out: Dict[str, List[cim_api.PackedCIMLayer]] = {n: [] for n in names}
    for li in range(n_layers):
        chip = cim_api.compile_chip(
            {n: stacked_w[n][li].to(torch.float32) for n in names},
            ccfg, spec, mode, in_alpha=in_alpha,
            x_cal=None if x_cal is None else x_cal[li], generator=generator)
        for n in names:
            out[n].append(chip.layers[n])
    return out


def packed_linear(pcl, x, ccfg: CIMConfig, *, impl: str = "auto"):
    """x: (B, n_in) float -> (B, n_out) float through one packed launch."""
    return cim_api.packed_forward(pcl, x.to(torch.float32), ccfg, impl=impl)


def arch_cim_config(arch_cfg) -> CIMConfig:
    """The CIMConfig a transformer arch serves its packed projections with:
    the arch's cim_* fields are the one source of truth, for deploy and
    for the forward pass alike."""
    return CIMConfig(in_bits=arch_cfg.cim_in_bits,
                     out_bits=arch_cfg.cim_out_bits)


def deploy_transformer_cim(params, arch_cfg, *, mode: str = "ideal",
                           in_alpha: float = 3.0,
                           mesh_shape: Optional[Dict[str, int]] = None,
                           spec: Optional[CoreSpec] = None,
                           x_cal: Optional[List[Dict[str, Any]]] = None):
    """Compile every packed-servable projection of a dense transformer
    onto CIM chips (one chip per layer) and return params augmented with
    '<name>_cim' entries, re-verified by the chip-IR verifier.

    x_cal: optional per-layer name -> (64, R) calibration batches; without
    it they are drawn from a torch.Generator seeded 7 on the params'
    device. mesh_shape: a 'model' width above 1 raises (sharded deploys
    are ROADMAP A13).
    """
    if "layers" not in params or "wq" not in params["layers"]:
        raise ValueError(
            "deploy_transformer_cim covers dense attention+MLP stacks "
            "(params['layers']['wq'])")
    if int((mesh_shape or {}).get("model", 1)) > 1:
        raise NotImplementedError(
            "tensor-parallel CIM deploys are not ported yet (ROADMAP A13)")
    stacked = {n: params["layers"][n] for n in PACKED_PROJ_KEYS
               if n in params["layers"]}
    gen = torch.Generator(params["layers"]["wq"].device).manual_seed(7)
    new_layers = dict(params["layers"])
    for n, pcls in deploy_packed_stack(
            stacked, arch_cim_config(arch_cfg), mode=mode, in_alpha=in_alpha,
            spec=spec, x_cal=x_cal, generator=gen).items():
        new_layers[n + "_cim"] = pcls
    out = dict(params)
    out["layers"] = new_layers
    return verify_deployed(out)
