"""High-level CIM API — the chip-compiler pipeline models deploy through
(PyTorch port of `repro/core/cim.py`, forward direction, ideal mode).

    plan  ->  schedule  ->  program  ->  calibrate  ->  pack

  * `plan_chip`      (mapping.plan_layers): matrices -> `Plan` of core tiles.
  * `schedule_chip`  (mapping.schedule_tiles): per-layer ordered passes.
  * `program_chip`   : weights -> `CIMLayer` conductances ('ideal' encode)
                       plus the whole-matrix calibration.
  * `calibrate_chip` : one ADC v_decr per tile, measured on that tile's own
                       partial-sum distribution.
  * `pack_chip`      (mapping.pack_tiles): per-layer `PackedCIMLayer`s.

`compile_chip` composes them into a `CompiledChip` and, by default, runs
the chip-IR verifier (`core.verify.verify_chip`) over it. `packed_forward`
serves one packed layer: quantize, one kernel launch, rescale.

Randomness (synthetic calibration batches) comes from an explicit
`torch.Generator`; callers that must match the JAX reference pass the
reference's calibration batches as `x_cal` instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from .calibration import calibrate_layer, quantile_linear
from .conductance import weights_to_conductances
from .mapping import (MatrixReq, PackedPlan, Plan, TileSchedule, block_view,
                      ir_drop_max_cols, pack_tiles, plan_layers,
                      schedule_tiles)
from .quant import quantize_to_int
from .types import CIMConfig, CoreSpec
from .verify import verify_chip
from ..kernels.cim_mvm.ops import cim_mvm_packed


class CIMLayer(NamedTuple):
    """One weight matrix programmed onto (simulated) RRAM cores."""
    g_pos: torch.Tensor
    g_neg: torch.Tensor
    w_max: torch.Tensor
    norm: torch.Tensor
    v_decr: torch.Tensor
    adc_offset: torch.Tensor
    in_alpha: torch.Tensor     # PACT input clip


def synthetic_x_cal(rows: int, in_alpha: float, generator: torch.Generator):
    """A synthetic (64, rows) calibration batch matched to the input clip:
    truncated normal in [-2, 2] times in_alpha, drawn from `generator` on
    its own device."""
    x = torch.empty((64, rows), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return in_alpha * x


def program(w, cfg: CIMConfig, in_alpha=1.0, x_cal=None, mode: str = "ideal",
            generator: Optional[torch.Generator] = None) -> CIMLayer:
    """Program weight matrix w (R, C) onto the chip and calibrate it.

    x_cal: optional (B_cal, R) float calibration activations; None draws a
    synthetic batch from `generator` (a fresh one seeded 0 if None).
    """
    if mode != "ideal":
        raise NotImplementedError(
            f"mode={mode!r}: relaxed and writeverify programming are not "
            "ported yet (ROADMAP A11); use mode='ideal'")
    c = weights_to_conductances(w, cfg.device)
    if x_cal is None:
        gen = generator or torch.Generator(w.device).manual_seed(0)
        x_cal = synthetic_x_cal(w.shape[0], in_alpha, gen)
    x_int_cal, _ = quantize_to_int(x_cal, in_alpha, cfg.in_bits, signed=True)
    cal = calibrate_layer(x_int_cal, c.g_pos, c.g_neg, cfg)
    return CIMLayer(c.g_pos, c.g_neg, c.w_max, c.norm, cal.v_decr,
                    cal.adc_offset,
                    torch.tensor(in_alpha, dtype=torch.float32,
                                 device=w.device))


class PackedCIMLayer(NamedTuple):
    """One programmed layer + its packed tile plan."""
    layer: CIMLayer
    packed: PackedPlan


def calibrate_tile_v_decr(layer: CIMLayer, tiles, x_cal, cfg: CIMConfig,
                          coverage: float = 0.999):
    """Per-core ADC calibration: one v_decr per tile, covering that tile's
    OWN normalized partial-sum distribution
        q_t = (x_t @ gd_t) * v_read / norm_t,   norm_t = column sums of the
    tile's G+ + G-. Batched over all tiles of the layer: the (R, C) matrix
    viewed as (row_block, col_block, bk, bn) blocks gives every tile's
    partial sums in one product. Returns (T,) aligned with the replica-0
    tiles in the given order."""
    tiles = [t for t in tiles if not t.replica]
    x_int, _ = quantize_to_int(x_cal, layer.in_alpha, cfg.in_bits,
                               signed=True)
    bk = max(t.rows for t in tiles)
    bn = max(t.cols for t in tiles)
    dev = layer.g_pos.device
    rb = torch.tensor([t.row0 // bk for t in tiles], device=dev)
    cb = torch.tensor([t.col0 // bn for t in tiles], device=dev)
    rows = torch.tensor([t.rows for t in tiles], device=dev)
    cols = torch.tensor([t.cols for t in tiles], device=dev)
    rmask = (torch.arange(bk, device=dev)[None, :] < rows[:, None])
    keep = rmask[:, :, None] & (torch.arange(bn, device=dev)[None, None, :]
                                < cols[:, None, None])
    zero = torch.zeros((), device=dev)
    gd = torch.where(keep, block_view(layer.g_pos - layer.g_neg, bk, bn)[rb, cb],
                     zero)
    norm = torch.where(keep, block_view(layer.g_pos + layer.g_neg, bk, bn)[rb, cb],
                       zero).sum(dim=1)
    xb = block_view(x_int.to(torch.float32), x_int.shape[0], bk)[0]
    xt = torch.where(rmask[:, None, :], xb[rb], zero)        # (T, B, bk)
    q = torch.bmm(xt, gd) * cfg.v_read / norm[:, None, :]    # (T, B, bn)
    colok = torch.arange(bn, device=dev)[None, None, :] < cols[:, None, None]
    absq = torch.where(colok, q.abs(), torch.full((), float("inf"),
                                                  device=dev))
    n_valid = cols * x_int.shape[0]
    qmax = quantile_linear(absq.reshape(len(tiles), -1), coverage, n_valid)
    return torch.clamp(qmax, min=1e-9) / cfg.out_mag_levels


def pack_cim_layer(layer: CIMLayer, tiles, cfg: CIMConfig, v_decr=None,
                   schedule: Optional[TileSchedule] = None) -> PackedCIMLayer:
    """Pack a programmed CIMLayer's tiles for single-launch execution, with
    norm * v_decr folded into denorm_tiles (raw count accumulation for the
    activations whose counts are already neuron units)."""
    fold = cfg.activation not in ("tanh", "sigmoid", "stochastic")
    packed = pack_tiles(tiles, layer.g_pos - layer.g_neg,
                        gsum=layer.g_pos + layer.g_neg,
                        v_decr=layer.v_decr if v_decr is None else v_decr,
                        fold_norm=fold, schedule=schedule)
    return PackedCIMLayer(layer, packed)


def packed_forward(pcl: PackedCIMLayer, x, cfg: CIMConfig, *,
                   impl: str = "auto"):
    """y ~= x @ W through the packed chip datapath. x: (B, R) float over
    the layer's full weight rows; the whole tile plan is one kernel
    launch, with row-split partial sums de-normalized per core and
    accumulated digitally inside it."""
    layer, packed = pcl.layer, pcl.packed
    x_int, scale = quantize_to_int(x, layer.in_alpha, cfg.in_bits,
                                   signed=True)
    acc = cim_mvm_packed(x_int, packed, cfg, impl=impl)
    if cfg.activation in ("tanh", "sigmoid", "stochastic"):
        return acc                     # already neuron units
    return acc * layer.w_max * scale / (cfg.v_read * cfg.device.g_max)


# ------------------------------------------------- chip-compiler pipeline

@dataclasses.dataclass(eq=False)
class CompiledChip:
    """The chip-compiler's output: every stage's result, servable."""
    cfg: CIMConfig
    spec: CoreSpec
    mode: str
    plan: Plan
    schedules: Dict[str, TileSchedule]
    layers: Dict[str, PackedCIMLayer]

    def __contains__(self, name: str) -> bool:
        return name in self.layers


def plan_chip(reqs: Sequence[MatrixReq], cfg: CIMConfig,
              spec: CoreSpec = CoreSpec()) -> Plan:
    """Stage 1 (PLAN), bounding tile width by the IR-drop constraint."""
    return plan_layers(reqs, spec,
                       max_cols_per_core=ir_drop_max_cols(cfg, spec))


def schedule_chip(plan: Plan, names: Sequence[str]
                  ) -> Dict[str, TileSchedule]:
    """Stage 2 (SCHEDULE): per-layer ordered passes."""
    return {n: schedule_tiles(plan.tiles_for(n)) for n in names}


def program_chip(weights: Dict[str, torch.Tensor], cfg: CIMConfig, *,
                 mode: str = "ideal", in_alpha: float = 1.0,
                 x_cal: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None):
    """Stage 3 (PROGRAM): conductances + whole-matrix calibration per
    matrix, in sorted name order. Returns (name -> CIMLayer, name ->
    calibration batch); the same batch drives stage 4."""
    layers: Dict[str, CIMLayer] = {}
    batches: Dict[str, torch.Tensor] = {}
    for name in sorted(weights):
        w = weights[name]
        xc = x_cal.get(name) if x_cal is not None else None
        if xc is None:
            gen = generator or torch.Generator(w.device).manual_seed(0)
            xc = synthetic_x_cal(w.shape[0], in_alpha, gen)
        xc = torch.as_tensor(xc, dtype=torch.float32, device=w.device)
        layers[name] = program(w, cfg, in_alpha=in_alpha, x_cal=xc,
                               mode=mode)
        batches[name] = xc
    return layers, batches


def calibrate_chip(layers: Dict[str, CIMLayer], plan: Plan,
                   batches: Dict[str, torch.Tensor], cfg: CIMConfig
                   ) -> Dict[str, torch.Tensor]:
    """Stage 4 (CALIBRATE): one v_decr per tile."""
    return {n: calibrate_tile_v_decr(layers[n], plan.tiles_for(n),
                                     batches[n], cfg)
            for n in layers}


def pack_chip(layers: Dict[str, CIMLayer], plan: Plan,
              schedules: Dict[str, TileSchedule], cfg: CIMConfig,
              v_decrs: Dict[str, torch.Tensor]
              ) -> Dict[str, PackedCIMLayer]:
    """Stage 5 (PACK), forward direction."""
    return {n: pack_cim_layer(layers[n], plan.tiles_for(n), cfg,
                              v_decr=v_decrs[n], schedule=schedules[n])
            for n in layers}


def _oracle_only(cfg: CIMConfig) -> bool:
    """Non-idealities the packed serving path cannot honor at all."""
    ni = cfg.nonideal
    return (ni.wire_r_alpha > 0 or ni.coupling_sigma > 0
            or ni.adc_offset_sigma > 0)


def compile_chip(weights: Dict[str, torch.Tensor], cfg: CIMConfig,
                 spec: CoreSpec = CoreSpec(), mode: str = "ideal", *,
                 in_alpha: float = 1.0,
                 x_cal: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 verify: str = "strict") -> CompiledChip:
    """Run plan -> schedule -> program -> calibrate -> pack over one chip's
    weight matrices (name -> (R, C), all on one device), forward direction
    (transpose-direction chips wait for ROADMAP A9).

    x_cal: optional per-name (B_cal, R) calibration activations; missing
    names draw synthetic batches from `generator`. verify: "strict" (the
    default) runs the chip-IR verifier; "off" skips it.
    """
    if verify not in ("strict", "off"):
        raise ValueError(f"verify must be 'strict' or 'off', got "
                         f"{verify!r}")
    if _oracle_only(cfg):
        raise ValueError(
            "compile_chip serves the fused kernel path only; per-phase "
            "non-idealities require the bit-serial oracle")
    plan = plan_chip([MatrixReq(n, int(w.shape[0]), int(w.shape[1]))
                      for n, w in weights.items()], cfg, spec)
    schedules = schedule_chip(plan, sorted(weights))
    layers, batches = program_chip(weights, cfg, mode=mode,
                                   in_alpha=in_alpha, x_cal=x_cal,
                                   generator=generator)
    v_decrs = calibrate_chip(layers, plan, batches, cfg)
    packed = pack_chip(layers, plan, schedules, cfg, v_decrs)
    chip = CompiledChip(cfg=cfg, spec=spec, mode=mode, plan=plan,
                        schedules=schedules, layers=packed)
    if verify == "strict":
        verify_chip(chip)
    return chip
