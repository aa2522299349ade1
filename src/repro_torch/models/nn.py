"""Neural-network substrate over the CIM core (PyTorch port of
`repro/models/nn.py`).

Every weight matrix has two execution paths:

  * SOFTWARE path (float, differentiable): PACT-quantized activations
    (straight-through rounding) and, for noise-resilient training (paper
    Fig. 3c, `train/noisy.py`), Gaussian weight noise (`noisy_linear` /
    `noisy_conv`, drawn from a torch.Generator). Like the reference's
    training, it multiplies by the noisy weight in plain PyTorch; the
    noisy-matmul kernel is on no training path of either package.
  * CHIP path (inference, integer): the weight (with bias and folded batch
    norm merged in, paper Fig. 4c) is programmed onto simulated RRAM with
    the bias-as-rows scheme, calibrated (`deploy_linear`), and executed
    through the single-matrix CIM kernel (`chip_linear` / `chip_conv`).

Bias-as-rows (paper Methods): if the bias range is B times the weight
range, the bias is split evenly over B appended rows driven with
full-scale inputs.

Tensors are NHWC, as in the reference (`max_pool` permutes to PyTorch's
NCHW inside). `im2col` flattens each patch channel-major, (C, kh, kw),
which is what the reference's `conv_general_dilated_patches` gives
(its comment says kh*kw*C); the conv weights (kh, kw, cin, cout) are
reshaped to (kh*kw*cin, cout) all the same, in both packages, so the port
reproduces the reference's pairing of patch and weight entries. `SAME`
padding is XLA's: total = max((out - 1) * s + k - in, 0), the smaller
half before (asymmetric at stride 2).

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

import math
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core import cim as cim_api
from ..core.noise import weight_noise
from ..core.quant import pact_quantize
from ..core.types import CIMConfig, CoreSpec, NonIdealityConfig
from ..core.verify import verify_deployed

# ---------------------------------------------------------------- init utils

def linear_init(generator: torch.Generator, n_in: int, n_out: int):
    w = torch.randn((n_in, n_out), generator=generator,
                    device=generator.device) * math.sqrt(2.0 / n_in)
    return {"w": w, "b": torch.zeros((n_out,), device=generator.device)}


def conv_init(generator: torch.Generator, kh: int, kw_: int, cin: int,
              cout: int):
    fan_in = kh * kw_ * cin
    w = torch.randn((kh, kw_, cin, cout), generator=generator,
                    device=generator.device) * math.sqrt(2.0 / fan_in)
    return {"w": w, "b": torch.zeros((cout,), device=generator.device)}


def bn_init(c: int, device=None):
    return {"gamma": torch.ones((c,), device=device),
            "beta": torch.zeros((c,), device=device),
            "mean": torch.zeros((c,), device=device),
            "var": torch.ones((c,), device=device)}


# ------------------------------------------------------------ software path

def quant_act(x, alpha, bits: int, signed: bool):
    """PACT activation quantization with STE; identity if bits <= 0."""
    if bits <= 0:
        return x
    return pact_quantize(x, alpha, bits, signed=signed)


def noisy_linear(generator: Optional[torch.Generator], p, x,
                 noise_frac: float):
    w = p["w"]
    if noise_frac > 0.0 and generator is not None:
        w = weight_noise(generator, w, noise_frac)
    return x @ w + p["b"]


def _same_pads(size: int, k: int, stride: int):
    """XLA's SAME padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def im2col(x, kh: int, kw_: int, stride: int = 1, padding: str = "SAME"):
    """x: (B, H, W, C) -> patches (B, Ho, Wo, C*kh*kw), each patch
    flattened channel-major (C, kh, kw) as the reference's
    `conv_general_dilated_patches` flattens it. The windows are strided
    views of the padded input (`Tensor.unfold`), gathered by one copy."""
    b, h, w, c = x.shape
    if padding == "SAME":
        (pt, pb), (pl, pr) = _same_pads(h, kh, stride), \
            _same_pads(w, kw_, stride)
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    win = x.unfold(1, kh, stride).unfold(2, kw_, stride)  # (B,Ho,Wo,C,kh,kw)
    return win.reshape(b, win.shape[1], win.shape[2], c * kh * kw_)


def noisy_conv(generator: Optional[torch.Generator], p, x,
               noise_frac: float, stride: int = 1, padding: str = "SAME"):
    kh, kw_, cin, cout = p["w"].shape
    cols = im2col(x, kh, kw_, stride, padding)      # (B, Ho, Wo, kh*kw*cin)
    w2 = p["w"].reshape(kh * kw_ * cin, cout)
    if noise_frac > 0.0 and generator is not None:
        w2 = weight_noise(generator, w2, noise_frac)
    return cols @ w2 + p["b"]


def batch_norm(p, x, train: bool, momentum: float = 0.9, eps: float = 1e-5):
    """Returns (y, updated bn params). Reduction over all but the last
    axis."""
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = torch.mean(x, axes)
        var = torch.var(x, axes, unbiased=False)
        new_p = dict(p, mean=momentum * p["mean"] + (1 - momentum) * mean,
                     var=momentum * p["var"] + (1 - momentum) * var)
    else:
        mean, var, new_p = p["mean"], p["var"], p
    y = (x - mean) / torch.sqrt(var + eps) * p["gamma"] + p["beta"]
    return y, new_p


def fold_bn(conv_p, bn_p, eps: float = 1e-5):
    """Merge BN into conv weights / bias (paper Fig. 4c) for chip
    deployment."""
    scale = bn_p["gamma"] / torch.sqrt(bn_p["var"] + eps)
    w = conv_p["w"] * scale              # broadcast over output channel
    b = (conv_p["b"] - bn_p["mean"]) * scale + bn_p["beta"]
    return {"w": w, "b": b}


def max_pool(x, window: int = 2, stride: int = 2):
    """VALID max pooling of (B, H, W, C)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def avg_pool_global(x):
    return torch.mean(x, dim=(1, 2))


# ------------------------------------------------------------- chip path

class ChipLinear(NamedTuple):
    """A linear / conv (flattened) layer programmed on the simulated chip."""
    layer: cim_api.CIMLayer
    bias_rows: int            # rows appended for the bias
    alpha: torch.Tensor       # input PACT clip used at deploy time (0-d)
    signed: bool


def _augment_bias(w2, b, drive):
    """Append bias rows: the bias split over B rows driven at full-scale
    input `drive` (the PACT clip alpha: `chip_linear` drives them at
    `cl.alpha`); B scales with bmax / (drive * wmax), so each row's
    conductance stays within the weight range."""
    wmax = torch.clamp(torch.max(torch.abs(w2)), min=1e-12)
    bmax = torch.max(torch.abs(b))
    n_rows = int(torch.clamp(torch.ceil(bmax / (drive * wmax)), min=1))
    rows = (b / (n_rows * drive))[None, :].expand(n_rows, -1)
    return torch.cat([w2, rows], dim=0), n_rows


def deploy_linear(p, cfg: CIMConfig, alpha, x_cal=None, signed: bool = False,
                  mode: str = "relaxed",
                  generator: Optional[torch.Generator] = None) -> ChipLinear:
    """Program one weight matrix (+ bias rows) onto simulated RRAM;
    programming noise from `generator`."""
    w2 = p["w"] if p["w"].ndim == 2 else p["w"].reshape(-1, p["w"].shape[-1])
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=w2.device)
    w_aug, n_rows = _augment_bias(w2, p["b"], alpha)
    if x_cal is not None:
        ones = torch.full((x_cal.shape[0], n_rows), float(alpha),
                          device=x_cal.device)
        x_cal = torch.cat([x_cal.reshape(x_cal.shape[0], -1), ones], -1)
    layer = cim_api.program(w_aug, cfg, in_alpha=float(alpha), x_cal=x_cal,
                            mode=mode, generator=generator)
    return ChipLinear(layer, n_rows, alpha, signed)


def chip_linear(cl: ChipLinear, x, cfg: CIMConfig, seed: int = 0,
                impl: str = "auto",
                generator: Optional[torch.Generator] = None):
    """x: (B, n_in) float -> (B, n_out) float through the chip datapath:
    one launch of the single-matrix kernel, the bias rows driven at
    `cl.alpha` inside it (impl="plain": its plain version); the
    bit-serial oracle where `cfg` needs it (`core.cim.forward`; its
    draws from `generator`)."""
    return cim_api.forward(cl.layer, x, cfg, bias=cl.alpha,
                           bias_rows=cl.bias_rows, seed=seed, impl=impl,
                           generator=generator)


def chip_conv(cl: ChipLinear, x, cfg: CIMConfig, kh: int, kw_: int,
              stride: int = 1, padding: str = "SAME", seed: int = 0,
              impl: str = "auto"):
    cols = im2col(x, kh, kw_, stride, padding)
    b, ho, wo, d = cols.shape
    y = chip_linear(cl, cols.reshape(-1, d), cfg, seed=seed, impl=impl)
    return y.reshape(b, ho, wo, -1)


# --------------------------------------------- packed CIM serving (engine)

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


def deploy_rbm_cim(params, ccfg: CIMConfig, v_cal, *, mode: str = "relaxed",
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
