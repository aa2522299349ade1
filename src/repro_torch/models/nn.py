"""Packed CIM deploys (PyTorch port of the packed half of
`repro/models/nn.py`).

`deploy_transformer_cim` compiles each layer's dense projections onto one
simulated chip (`core.cim.compile_chip`) and returns params augmented
with '<name>_cim' entries: a list with one PackedCIMLayer per layer, which
`models/transformer.cim_linear` serves through `packed_linear`.
`deploy_rbm_cim` compiles an RBM onto one bidirectional chip.

At one tensor-parallel shard the reference compiles every projection as
one replicated ("none") stack; that is all the port does. Sharded deploys
(a 'model' width above 1, `ShardedPackedLayer`) wait for ROADMAP A13.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..core import cim as cim_api
from ..core.types import CIMConfig, CoreSpec, NonIdealityConfig
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
    Returns name -> [PackedCIMLayer per layer]. The plan depends only on
    the shapes, so the first layer's plan serves every layer.
    """
    names = sorted(stacked_w)
    n_layers = stacked_w[names[0]].shape[0]
    if x_cal is not None and len(x_cal) != n_layers:
        raise ValueError(f"x_cal has {len(x_cal)} layers, the stack "
                         f"{n_layers}")
    spec = spec or CoreSpec()
    out: Dict[str, List[cim_api.PackedCIMLayer]] = {n: [] for n in names}
    plan = None
    for li in range(n_layers):
        chip = cim_api.compile_chip(
            {n: stacked_w[n][li].to(torch.float32) for n in names},
            ccfg, spec, mode, plan=plan, in_alpha=in_alpha,
            x_cal=None if x_cal is None else x_cal[li], generator=generator)
        plan = chip.plan
        for n in names:
            out[n].append(chip.layers[n])
    return out


def packed_linear(pcl, x, ccfg: CIMConfig, *, impl: str = "auto"):
    """x: (B, n_in) float -> (B, n_out) float through one packed launch."""
    return cim_api.packed_forward(pcl, x.to(torch.float32), ccfg, impl=impl)


def arch_cim_config(arch_cfg) -> CIMConfig:
    """The CIMConfig a transformer arch serves its packed projections with:
    the arch's cim_* fields (input / output bits, IR-drop alpha) are the
    one source of truth, for deploy and for the forward pass alike."""
    return CIMConfig(
        in_bits=arch_cfg.cim_in_bits, out_bits=arch_cfg.cim_out_bits,
        nonideal=NonIdealityConfig(ir_drop_alpha=arch_cfg.cim_ir_drop))


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


def deploy_rbm_cim(params, ccfg: CIMConfig, v_cal, *, mode: str = "ideal",
                   interleave: bool = False, spec: Optional[CoreSpec] = None,
                   generator: Optional[torch.Generator] = None):
    """Compile an RBM onto ONE bidirectional chip (paper Fig. 4e-g).

    The augmented (V+1, H+1) array (bias vectors embedded with the
    always-on-unit trick) goes through the chip compiler ONCE with
    directions=("fwd", "bwd"): v->h runs SL->BL, h->v BL->SL over the same
    programmed conductances, each direction with its own per-tile ADC
    calibration on training-set-driven activations (the visibles `v_cal`
    forward, a software half-step's hiddens backward).

    interleave=True applies the paper's Fig. 4f pixel-interleaved mapping
    as a custom stage-1 Plan: visible rows are permuted so core k holds
    units {k, k + n_blocks, ...} (rows padded to equal per-core bins), and
    the Gibbs loop gathers inputs / scatters outputs by the stored
    permutation. generator: draws for any missing calibration batch.

    Returns `models/rbm.ChipRBM`; serve with `rbm.chip_gibbs_recover` or
    `launch/recover.py`.
    """
    from . import rbm
    from ..core.mapping import (Plan, Tile, interleave_assignment,
                                ir_drop_max_cols)
    spec = spec or CoreSpec()
    n_vis, n_hid = params["w"].shape
    w_aug = rbm._augmented(params)             # (V+1, H+1)
    n_units, n_cols = w_aug.shape
    dev = w_aug.device
    row_cap = spec.rows // 2                   # differential weight rows
    perm = inv_perm = plan = None
    n_pad = n_units
    w_dep = w_aug
    if interleave:
        n_blocks = -(-n_units // row_cap)
        bs = -(-n_units // n_blocks)           # equal per-core bins
        n_pad = n_blocks * bs                  # pad with inert zero rows
        assign = interleave_assignment(n_pad, n_blocks, device=dev)
        perm = torch.argsort(assign, stable=True)   # bin k: units = k mod n
        inv_perm = torch.argsort(perm, stable=True)
        w_dep = torch.zeros((n_pad, n_cols), device=dev)
        w_dep[:n_units] = w_aug
        w_dep = w_dep[perm]
        # the custom plan keeps the IR-drop bound plan_chip would apply
        col_cap = min(spec.cols, ir_drop_max_cols(ccfg, spec) or spec.cols)
        n_cblocks = -(-n_cols // col_cap)
        tiles = [Tile("rbm", row0=i * bs, col0=j * col_cap, rows=bs,
                      cols=min(col_cap, n_cols - j * col_cap),
                      core=i * n_cblocks + j)
                 for i in range(n_blocks) for j in range(n_cblocks)]
        if len(tiles) > spec.n_cores:
            raise ValueError(f"interleaved RBM needs {len(tiles)} cores "
                             f"> {spec.n_cores} available")
        plan = Plan(tiles=tiles, n_cores_used=len(tiles), duplicated={},
                    merged=[])

    xv = rbm._aug_v(v_cal)
    if n_pad > xv.shape[1]:
        xv = torch.nn.functional.pad(xv, (0, n_pad - xv.shape[1]))
    if perm is not None:
        xv = xv[:, perm]
    ph = torch.sigmoid(v_cal @ params["w"] + params["b"])
    xh = rbm._aug_h((ph > 0.5).to(torch.float32))
    chip = cim_api.compile_chip(
        {"rbm": w_dep.to(torch.float32)}, ccfg, spec, mode, plan=plan,
        in_alpha=1.0, x_cal={"rbm": xv}, directions=("fwd", "bwd"),
        in_alpha_bwd=1.0, x_cal_bwd={"rbm": xh}, generator=generator)
    return verify_deployed(rbm.ChipRBM(
        chip=chip, perm=perm, inv_perm=inv_perm, n_vis=n_vis, n_hid=n_hid,
        n_pad=n_pad))
