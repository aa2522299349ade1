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

`deploy_transformer_cim` compiles each layer's dense and shared-expert
projections onto one simulated chip (`core.cim.compile_chip`) and each
routed expert of each layer onto a chip of its own (the paper's
power-gated cores), and returns params augmented with '<name>_cim'
entries: a list with one entry per layer (experts: per layer, a list
with one PackedCIMLayer per expert), which `models/transformer.cim_linear`
and `models/moe.moe_ffn` serve through `packed_linear`. As in the
reference, the dense layers of llama4's interleave ('dense_layers') are
not deployed: they serve float under --cim.
`deploy_recurrent_cim` compiles the recurrent stacks (rwkv6, mamba2) one
chip per layer and zamba2's shared attention block onto a chip of its own;
`deploy_cim` picks it or `deploy_transformer_cim` by the arch's family.
`deploy_rbm_cim` compiles an RBM onto one bidirectional chip.

Tensor parallelism (`mesh_shape` / `mesh` with a 'model' width M > 1):
ONE ENGINE PER SHARD. Each shard compiles its own chip per layer from its
local slice of every projection (`distributed/sharding.param_pspecs` and
`shard_slice`: a NeuRRAM core is an intra-shard unit), so a layer entry
is a `ShardedPackedLayer` holding M per-shard PackedCIMLayers.
Column-parallel shards each produce a slice of the output (concatenated
in shard order), row-parallel shards each read a slice of the input and
produce partial sums (folded left to right in shard order). A projection
whose sharded dim does not divide by M stays one replicated ('none')
stack of bare PackedCIMLayers, compiled on chips of its own. With a
`launch/mesh.Mesh`, shard s's chips are placed on the mesh's 'model'
device s at deploy time; without one they stay on the params' device.
One executor serves both (`sharded_packed_loop`, the reference's loop
and its shard_map executor in one): each shard's kernel launches where
its chips lie. Routed experts place expert-parallel: expert e on the
device of shard e // (E / M). At M = 1 every projection is a 'none'
stack, as in the reference.

Data rows (a mesh whose 'data' width D is above 1): the deploy compiles
once, as at D = 1, and gives each data row its own copy of the chips —
every stack placed onto that row's 'model' devices by the same rule
(`_place_on_row`; a 'none' stack on the row's first device) — under
params['cim_rows']. `row_params(params, r)` is what row r serves with:
its chips, and the float params on its first device. On a mesh that
repeats a device the copies are the same tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core import cim as cim_api
from ..core.cim import Alpha
from ..core.noise import weight_noise
from ..core.quant import pact_quantize
from ..core.types import CIMConfig, CoreSpec, NonIdealityConfig
from ..core.verify import verify_deployed
from ..distributed import sharding

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

# Projections the packed serving path covers: dense-block and shared-
# expert projections (one chip per layer), routed-expert stacks (one chip
# per layer and expert).
PACKED_PROJ_KEYS = ("wq", "wk", "wv", "wo", "w_g", "w_i", "w_o",
                    "sw_g", "sw_i", "sw_o")
PACKED_EXPERT_KEYS = ("ew_g", "ew_i", "ew_o")
# the recurrent stacks (`deploy_recurrent_cim`, one chip per layer): rwkv6's
# time-mix r/k/v/g/out and channel-mix k/v/receptance projections; mamba2's
# fused in/out projections and the hybrid block's SwiGLU MLP
RWKV_PROJ_KEYS = ("wr", "wk", "wv", "wg", "wo", "ck", "cv", "cr")
MAMBA_PROJ_KEYS = ("in_proj", "out_proj", "w_g", "w_i", "w_o")


def _check_alpha_names(in_alpha: Alpha, names) -> None:
    """A per-name in_alpha dict may only name projections of the stack."""
    if isinstance(in_alpha, dict):
        unknown = sorted(set(in_alpha) - set(names))
        if unknown:
            raise ValueError(
                f"in_alpha names {unknown} match no projection in this "
                f"stack (stack names: {sorted(names)}) — a typo here would "
                "silently deploy the projection at the default clip")


def _group_alpha(in_alpha: Alpha, names) -> Alpha:
    """A per-name in_alpha dict restricted to one deploy group's names
    (the whole dict is checked against every group up front)."""
    if not isinstance(in_alpha, dict):
        return in_alpha
    return {n: a for n, a in in_alpha.items() if n in names}


def _compile_stack(stacked_w, ccfg, mode, in_alpha, spec, x_cal, generator,
                   plan=None):
    """deploy_packed_stack's work; also returns the plan, which depends
    only on the shapes and so serves every chip of equal shapes."""
    names = sorted(stacked_w)
    _check_alpha_names(in_alpha, names)
    n_layers = stacked_w[names[0]].shape[0]
    if x_cal is not None and len(x_cal) != n_layers:
        raise ValueError(f"x_cal has {len(x_cal)} layers, the stack "
                         f"{n_layers}")
    out: Dict[str, List[cim_api.PackedCIMLayer]] = {n: [] for n in names}
    for li in range(n_layers):
        chip = cim_api.compile_chip(
            {n: stacked_w[n][li].to(torch.float32) for n in names},
            ccfg, spec or CoreSpec(), mode, plan=plan, in_alpha=in_alpha,
            x_cal=None if x_cal is None else x_cal[li], generator=generator)
        plan = chip.plan
        for n in names:
            out[n].append(chip.layers[n])
    return out, plan


def deploy_packed_stack(stacked_w: Dict[str, torch.Tensor], ccfg: CIMConfig,
                        *, mode: str = "ideal", in_alpha: Alpha = 3.0,
                        spec: Optional[CoreSpec] = None,
                        x_cal: Optional[List[Dict[str, Any]]] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, List[cim_api.PackedCIMLayer]]:
    """Compile a layer stack's weight matrices into packed chips.

    stacked_w: name -> (L, R, C) stacked weights. Each layer index gets
    its own `compile_chip` run (one chip per transformer layer).
    in_alpha: the PACT clip, a float or per-name dict; a dict naming a
    projection the stack lacks raises (a typo would otherwise deploy that
    projection at the 1.0 fallback). x_cal: optional per-layer list of
    name -> (B_cal, R) calibration activations (the parity seam with the
    reference, whose batches come from jax.random); without it the
    batches are drawn from `generator`. Returns name -> [PackedCIMLayer
    per layer]. The plan depends only on the shapes, so the first layer's
    plan serves every layer.
    """
    return _compile_stack(stacked_w, ccfg, mode, in_alpha, spec, x_cal,
                          generator)[0]


@dataclasses.dataclass
class ShardedPackedLayer:
    """One layer's projection as per-tensor-parallel-shard packed chips,
    and how their outputs combine: 'col' shards each produce a slice of
    the output (concatenated in shard order), 'row' shards each read a
    slice of the input and produce partial sums (`_ordered_fold`).
    Executed by `sharded_packed_loop`."""
    shards: List[cim_api.PackedCIMLayer]    # one per 'model' shard
    partition: str                          # 'col' | 'row' | 'none'
    n_shards: int


def _ordered_fold(parts):
    """Partial sums added left to right in shard order, one f32 add at a
    time from the first (the reference's loop's reduction)."""
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y


def _shard_input(spl: ShardedPackedLayer, x, s: int):
    """Shard s's input: x itself, or its s-th column slice for 'row'."""
    if spl.partition != "row":
        return x
    r = x.shape[-1] // spl.n_shards
    return x.narrow(-1, s * r, r)


def sharded_packed_loop(spl: ShardedPackedLayer, x, ccfg: CIMConfig, *,
                        seed: int = 0, impl: str = "auto"):
    """Serve one projection through its per-shard chips. x: (B, R_global)
    float. Shard s's kernel launches where its chips lie (on a mesh's
    'model' device s when deploy placed them there, x's slice moved to
    it); every shard's launch is enqueued before any output is copied
    back to x's device, so shards on distinct cards may overlap. 'col'
    outputs concatenate in shard order, 'row' partials fold left to right
    in shard order (`_ordered_fold`)."""
    outs = []
    for s, pcl in enumerate(spl.shards):
        dev = pcl.packed.gd_tiles.device
        outs.append(cim_api.packed_forward(
            pcl, _shard_input(spl, x, s).to(dev), ccfg, seed=seed, impl=impl))
    outs = [y.to(x.device) for y in outs]
    if spl.n_shards == 1:
        return outs[0]
    if spl.partition == "col":
        sharding.tally("all-gather", outs[0].numel() * spl.n_shards
                       * outs[0].element_size())
        return torch.cat(outs, dim=-1)
    sharding.tally("all-reduce", outs[0].numel() * outs[0].element_size())
    return _ordered_fold(outs)


def _place_chip(pcl: cim_api.PackedCIMLayer, dev) -> cim_api.PackedCIMLayer:
    """The chip with every tensor on `dev` (itself when already there)."""
    p = pcl.packed
    if p.gd_tiles.device == dev:
        return pcl
    layer = pcl.layer._replace(**{
        f: v.to(dev) for f, v in zip(pcl.layer._fields, pcl.layer)
        if isinstance(v, torch.Tensor)})
    packed = dataclasses.replace(
        p, gd_tiles=p.gd_tiles.to(dev),
        inv_norm_tiles=p.inv_norm_tiles.to(dev),
        v_decr_tiles=p.v_decr_tiles.to(dev),
        denorm_tiles=p.denorm_tiles.to(dev))
    return cim_api.PackedCIMLayer(layer, packed)


def place_packed_stack(stack, mesh, n_shards: int):
    """Place a packed chip stack onto the serving mesh at DEPLOY time:
    shard s of a ShardedPackedLayer (or of each layer's, for a per-layer
    list of them) on the mesh's 'model' device s
    (`distributed/sharding.packed_shardings`); a routed-expert stack
    ([L][E] PackedCIMLayers) expert-parallel, expert e on the device of
    shard e // (E / n_shards). Serving then moves no chip state."""
    from ..distributed.sharding import packed_shardings
    devs = packed_shardings(mesh, n_shards)
    if isinstance(stack, ShardedPackedLayer):
        return ShardedPackedLayer(
            [_place_chip(c, d) for c, d in zip(stack.shards, devs)],
            stack.partition, stack.n_shards)
    if isinstance(stack[0], ShardedPackedLayer):
        return [place_packed_stack(s, mesh, n_shards) for s in stack]
    per = len(stack[0]) // n_shards
    return [[_place_chip(c, devs[e // per]) for e, c in enumerate(layer)]
            for layer in stack]


def packed_linear(pcl, x, ccfg: CIMConfig, *, seed: int = 0,
                  impl: str = "auto"):
    """x: (B, n_in) float -> (B, n_out) float through one packed launch,
    or one per shard of a ShardedPackedLayer (`sharded_packed_loop`;
    seed: the stochastic neuron's salt)."""
    if isinstance(pcl, ShardedPackedLayer):
        return sharded_packed_loop(pcl, x.to(torch.float32), ccfg,
                                   seed=seed, impl=impl)
    return cim_api.packed_forward(pcl, x.to(torch.float32), ccfg, seed=seed,
                                  impl=impl)


def arch_cim_config(arch_cfg) -> CIMConfig:
    """The CIMConfig a transformer arch serves its packed projections with:
    the arch's cim_* fields (input / output bits, IR-drop alpha) are the
    one source of truth, for deploy and for the forward pass alike."""
    return CIMConfig(
        in_bits=arch_cfg.cim_in_bits, out_bits=arch_cfg.cim_out_bits,
        nonideal=NonIdealityConfig(ir_drop_alpha=arch_cfg.cim_ir_drop))


def _deploy_sharded_stacks(stacked: Dict[str, torch.Tensor],
                           ccfg: CIMConfig, *, mode: str, in_alpha: Alpha,
                           mesh_shape: Dict[str, int],
                           spec: Optional[CoreSpec], generator,
                           mesh=None, x_cal=None, x_cal_shards=None):
    """Compile (L, R, C) weight stacks into per-shard packed chip stacks:
    the deploy core of `deploy_transformer_cim` and
    `deploy_recurrent_cim`. ONE ENGINE PER 'model' SHARD, compiled from
    that shard's local slice of every projection; returns name -> a
    per-layer list of ShardedPackedLayers (placed on `mesh` when given),
    or of bare PackedCIMLayers for a replicated ('none') projection.

    A projection whose sharded dim does not divide by the 'model' width
    falls back to one replicated engine (the fit_pspecs rule), compiled on
    chips of its own: mixed into shard 0's chip it would make shard 0's
    plan differ from the other shards'. x_cal: per-layer name -> (64, R)
    batches for the 'none' chips; x_cal_shards: per shard, per layer,
    name -> (64, R_local) batches for the shard chips (the reference
    draws shard s's from fold_in(key, s) and the 'none' chips' from
    fold_in(key, M)); missing batches come from `generator`. Every shard
    chip has the same shapes, so the first one's plan serves them all."""
    from ..distributed.sharding import (param_pspecs, partition_kind,
                                        shard_shape, shard_slice)
    _check_alpha_names(in_alpha, stacked)
    n_sh = max(int(mesh_shape.get("model", 1)), 1)
    specs = param_pspecs({"layers": dict(stacked)})["layers"]
    kinds = {}
    for n, w in stacked.items():
        try:
            shard_shape(w.shape, specs[n], {"model": n_sh})
            kinds[n] = partition_kind(specs[n]) if n_sh > 1 else "none"
        except ValueError:      # not divisible: replicate (fit_pspecs rule)
            kinds[n] = "none"
    sharded = sorted(n for n in stacked if kinds[n] != "none")
    none = sorted(n for n in stacked if kinds[n] == "none")
    if sharded and x_cal_shards is not None and len(x_cal_shards) != n_sh:
        raise ValueError(f"x_cal_shards has {len(x_cal_shards)} shards, the "
                         f"deploy {n_sh}")
    shard_chips, plan = [], None
    for s in range(n_sh if sharded else 0):
        local = {n: shard_slice(stacked[n], specs[n], {"model": n_sh},
                                {"model": s}) for n in sharded}
        chips, plan = _compile_stack(
            local, ccfg, mode, _group_alpha(in_alpha, sharded), spec,
            None if x_cal_shards is None else x_cal_shards[s], generator,
            plan=plan)
        shard_chips.append(chips)
    out = {}
    if none:
        out = _compile_stack({n: stacked[n] for n in none}, ccfg, mode,
                             _group_alpha(in_alpha, none), spec, x_cal,
                             generator)[0]
    for n in sharded:
        spls = [ShardedPackedLayer([sc[n][li] for sc in shard_chips],
                                   kinds[n], n_sh)
                for li in range(len(shard_chips[0][n]))]
        out[n] = spls if mesh is None else place_packed_stack(spls, mesh,
                                                              n_sh)
    return {n: out[n] for n in stacked}


def _place_on_row(v, row_mesh):
    """One '<name>_cim' entry placed on a (1, M) row mesh by the deploy's
    rule: shard s of a ShardedPackedLayer (or of each layer's) on 'model'
    device s, routed experts expert-parallel where M > 1 divides E, and
    every other chip (a 'none' stack) on the row's first device."""
    dev = row_mesh.devices[0][0]
    n = row_mesh.shape["model"]
    if isinstance(v, ShardedPackedLayer):
        return place_packed_stack(v, row_mesh, v.n_shards)
    if isinstance(v, cim_api.PackedCIMLayer):
        return _place_chip(v, dev)
    if isinstance(v[0], ShardedPackedLayer):
        return place_packed_stack(v, row_mesh, v[0].n_shards)
    if isinstance(v[0], list):                      # [L][E] expert chips
        if n > 1 and len(v[0]) % n == 0:
            return place_packed_stack(v, row_mesh, n)
        return [[_place_chip(c, dev) for c in layer] for layer in v]
    return [_place_chip(c, dev) for c in v]


def _with_rows(out, mesh):
    """`out` with params['cim_rows'] when `mesh` has data rows (module
    docstring): per row {"device": its first device, "entries": {(key,
    name): placed entry}} for every '<name>_cim' entry of out['layers']
    and out['shared_attn']."""
    if mesh is None or mesh.shape["data"] == 1:
        return out
    rows = []
    for row in mesh.rows(("data",)):
        entries = {(top, n): _place_on_row(v, row)
                   for top in ("layers", "shared_attn") if top in out
                   for n, v in out[top].items() if n.endswith("_cim")}
        rows.append({"device": row.devices[0][0], "entries": entries})
    return dict(out, cim_rows=tuple(rows))


def row_params(params, r: int):
    """The params data row r serves with (module docstring): row r's
    chips in place of each '<name>_cim' entry, every other tensor moved to
    the row's first device (no copy where it lies there). Without data
    rows, row 0 is `params` itself."""
    rows = params.get("cim_rows")
    if rows is None:
        if r != 0:
            raise ValueError(f"params have no data row {r}")
        return params
    row = rows[r]

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: (row["entries"][(path[0], k)] if path and
                        k.endswith("_cim") else walk(v, path + (k,)))
                    for k, v in tree.items() if k != "cim_rows"}
        if isinstance(tree, torch.Tensor):
            return tree.to(row["device"])
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(t, path) for t in tree)
        return tree
    return walk(params, ())


def _resolve_mesh(arch_cfg, mesh, mesh_shape):
    """The (mesh, mesh_shape) a CIM deploy plans and places with: an
    explicit `mesh` wins, else the arch's `cim_mesh`; `mesh_shape`
    defaults to the mesh's own axis sizes, and one whose 'model' width
    disagrees with the mesh's raises; so does a mesh serving cannot take
    (`launch/mesh.check_serving_mesh`)."""
    from ..launch.mesh import check_serving_mesh
    mesh = mesh if mesh is not None else getattr(arch_cfg, "cim_mesh", None)
    if mesh is not None:
        check_serving_mesh(mesh)
    if mesh_shape is None:
        mesh_shape = dict(mesh.shape) if mesh is not None else {"model": 1}
    elif mesh is not None \
            and int(mesh_shape.get("model", 1)) != mesh.shape["model"]:
        raise ValueError(
            f"mesh_shape {dict(mesh_shape)} disagrees with the serving "
            f"mesh's axes {mesh.shape}: per-shard chip stacks are placed "
            "with shard s on the mesh's 'model' device s, so the TP width "
            "must equal the mesh's 'model' size (drop mesh_shape to derive "
            "it from the mesh)")
    return mesh, dict(mesh_shape)


def deploy_transformer_cim(params, arch_cfg, *, mode: str = "ideal",
                           in_alpha: Alpha = 3.0,
                           mesh_shape: Optional[Dict[str, int]] = None,
                           spec: Optional[CoreSpec] = None, mesh=None,
                           x_cal: Optional[List[Dict[str, Any]]] = None,
                           x_cal_shards: Optional[
                               List[List[Dict[str, Any]]]] = None,
                           x_cal_experts: Optional[
                               List[List[Dict[str, Any]]]] = None):
    """Compile every packed-servable projection of a transformer onto CIM
    chips and return params augmented with '<name>_cim' entries,
    re-verified by the chip-IR verifier.

    One chip per layer (per shard under tensor parallelism, module
    docstring) carries the dense-block and shared-expert projections
    (PACKED_PROJ_KEYS). The routed experts (PACKED_EXPERT_KEYS, (L, E, R,
    C) stacks) get one chip per (layer, expert), which `moe.moe_ffn`
    serves; each '<name>_cim' expert entry is a per-layer list of
    per-expert PackedCIMLayers ([L][E]), placed expert-parallel on a mesh
    whose 'model' width divides E. Every expert chip has the same shapes,
    so the first one's plan serves them all.

    mesh_shape / mesh: the tensor-parallel width ({'model': M}) and the
    serving `launch/mesh.Mesh` the shard chips are placed on (default
    `arch_cfg.cim_mesh`; without either, M = 1). in_alpha: the PACT clip,
    a float or a per-name dict over both groups (an unknown name raises).
    x_cal: optional per-layer name -> (64, R) calibration batches for the
    replicated ('none') layer chips; x_cal_shards: optional per-shard,
    per-layer ones for the shard chips; x_cal_experts: optional
    per-layer, per-expert ones for the expert chips (the reference draws
    them from jax.random, which the port cannot replay: the parity tests
    hand them in). Missing batches are drawn from a torch.Generator
    seeded 7 on the params' device.
    """
    if "layers" not in params or "wq" not in params["layers"]:
        raise ValueError(
            "deploy_transformer_cim covers dense attention+MLP stacks "
            "(params['layers']['wq']); recurrent archs (rwkv6 / mamba2) "
            "deploy through deploy_recurrent_cim")
    mesh, mesh_shape = _resolve_mesh(arch_cfg, mesh, mesh_shape)
    layers = params["layers"]
    stacked = {n: layers[n] for n in PACKED_PROJ_KEYS if n in layers}
    expert_w = {n: layers[n] for n in PACKED_EXPERT_KEYS if n in layers}
    _check_alpha_names(in_alpha, list(stacked) + list(expert_w))
    ccfg = arch_cim_config(arch_cfg)
    gen = torch.Generator(layers["wq"].device).manual_seed(7)
    new_layers = dict(layers)
    for n, v in _deploy_sharded_stacks(
            stacked, ccfg, mode=mode,
            in_alpha=_group_alpha(in_alpha, stacked), mesh_shape=mesh_shape,
            spec=spec, generator=gen, mesh=mesh, x_cal=x_cal,
            x_cal_shards=x_cal_shards).items():
        new_layers[n + "_cim"] = v
    if expert_w:
        names = sorted(expert_w)
        n_layers, n_experts = expert_w[names[0]].shape[:2]
        alpha = _group_alpha(in_alpha, names)
        plan = None
        per_exp = []
        for e in range(n_experts):
            xc = None if x_cal_experts is None else \
                [x_cal_experts[li][e] for li in range(n_layers)]
            chips, plan = _compile_stack(
                {n: expert_w[n][:, e] for n in names}, ccfg, mode, alpha,
                spec, xc, gen, plan=plan)
            per_exp.append(chips)
        n_model = int(mesh_shape.get("model", 1))
        for n in names:
            stack = [[per_exp[e][n][li] for e in range(n_experts)]
                     for li in range(n_layers)]
            if mesh is not None and n_model > 1 \
                    and n_experts % n_model == 0:
                stack = place_packed_stack(stack, mesh, n_model)
            new_layers[n + "_cim"] = stack
    out = dict(params)
    out["layers"] = new_layers
    return verify_deployed(_with_rows(out, mesh))


def is_recurrent_arch(arch_cfg) -> bool:
    """The family predicate for CIM deployment: an arch whose projections
    compile through `deploy_recurrent_cim` (rwkv6 / mamba2 stacks) rather
    than `deploy_transformer_cim` (dense / MoE)."""
    return bool(getattr(arch_cfg, "rwkv", False)) \
        or getattr(arch_cfg, "ssm_state", 0) > 0


def recurrent_proj_keys(arch_cfg):
    """The projection names a recurrent arch compiles onto CIM chips."""
    if not is_recurrent_arch(arch_cfg):
        raise ValueError(
            f"{getattr(arch_cfg, 'name', arch_cfg)} is not a recurrent arch "
            "(expected rwkv=True or ssm_state > 0)")
    return RWKV_PROJ_KEYS if arch_cfg.rwkv else MAMBA_PROJ_KEYS


def deploy_cim(params, arch_cfg, **kw):
    """Family-dispatched CIM deploy: the one entry `launch/serve.py` calls
    (through `launch/steps.ArchServing.deploy_cim`)."""
    if is_recurrent_arch(arch_cfg):
        return deploy_recurrent_cim(params, arch_cfg, **kw)
    return deploy_transformer_cim(params, arch_cfg, **kw)


def deploy_recurrent_cim(params, arch_cfg, *, mode: str = "ideal",
                         in_alpha: float = 3.0,
                         mesh_shape: Optional[Dict[str, int]] = None,
                         spec: Optional[CoreSpec] = None, mesh=None,
                         x_cal: Optional[List[Dict[str, Any]]] = None,
                         x_cal_shards: Optional[
                             List[List[Dict[str, Any]]]] = None,
                         x_cal_shared: Optional[List[Dict[str, Any]]] = None):
    """Compile a recurrent stack's projections onto CIM chips and return
    params augmented with '<name>_cim' entries, re-verified by the chip-IR
    verifier.

    One chip per layer (per shard under tensor parallelism, as in
    `deploy_transformer_cim`) carries every weight-stationary projection:
    rwkv6's time-mix `wr wk wv wg wo` and channel-mix `ck cv cr`, or
    mamba2's `in_proj out_proj` and MLP `w_g w_i w_o`. The S / h
    recurrences (and rwkv6's decay LoRA) stay float: they are
    state-dependent, nothing weight-stationary to program. zamba2's one
    shared attention block compiles its dense projections onto a chip of
    its own, as a one-layer stack whose entries are then unstacked (a
    bare PackedCIMLayer or ShardedPackedLayer per projection under
    params['shared_attn'], served by `transformer.dense_block`).

    in_alpha: the scalar PACT clip of the rms-normed inputs; rwkv6's `cv`,
    driven by the squared relu of `ck`'s output, gets in_alpha ** 2.
    x_cal / x_cal_shards: the layer chips' calibration batches, as
    `deploy_transformer_cim` takes them; x_cal_shared: a one-entry list of
    them for the shared block's replicated chips (the reference draws
    those from fold_in(key, 104729)). Missing batches are drawn from a
    torch.Generator seeded 7 on the params' device.
    """
    names = recurrent_proj_keys(arch_cfg)
    layers = params["layers"]
    stacked = {n: layers[n] for n in names if n in layers}
    if not stacked:
        raise ValueError("no recurrent projections found in "
                         f"params['layers'] (expected some of {names})")
    mesh, mesh_shape = _resolve_mesh(arch_cfg, mesh, mesh_shape)
    ccfg = arch_cim_config(arch_cfg)
    alphas = {n: float(in_alpha) for n in stacked}
    if "cv" in alphas:          # squared-relu input range (docstring)
        alphas["cv"] = float(in_alpha) ** 2
    gen = torch.Generator(layers[names[0]].device).manual_seed(7)
    new_layers = dict(layers)
    for n, v in _deploy_sharded_stacks(
            stacked, ccfg, mode=mode, in_alpha=alphas,
            mesh_shape=mesh_shape, spec=spec, generator=gen, mesh=mesh,
            x_cal=x_cal, x_cal_shards=x_cal_shards).items():
        new_layers[n + "_cim"] = v
    out = dict(params)
    out["layers"] = new_layers
    if getattr(arch_cfg, "hybrid_attn_every", 0) > 0 \
            and "shared_attn" in params:
        sa = params["shared_attn"]
        chips = _deploy_sharded_stacks(
            {n: sa[n][None] for n in PACKED_PROJ_KEYS if n in sa}, ccfg,
            mode=mode, in_alpha=in_alpha, mesh_shape=mesh_shape, spec=spec,
            generator=gen, mesh=mesh, x_cal=x_cal_shared)
        out["shared_attn"] = dict(sa, **{n + "_cim": v[0]
                                         for n, v in chips.items()})
    return verify_deployed(_with_rows(out, mesh))


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
