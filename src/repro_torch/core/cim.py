"""High-level CIM API — the chip-compiler pipeline models deploy through
(PyTorch port of `repro/core/cim.py`).

    plan  ->  schedule  ->  program  ->  calibrate  ->  pack

  * `plan_chip`      (mapping.plan_layers): matrices -> `Plan` of core tiles.
  * `schedule_chip`  (mapping.schedule_tiles): per-layer ordered passes.
  * `program_chip`   : weights -> `CIMLayer` conductances at one of three
                       fidelities — 'ideal' (exact encode), 'relaxed'
                       (+relaxation noise, 3 iterations), 'writeverify'
                       (pulse-level simulation) — plus the whole-matrix
                       calibration.
  * `calibrate_chip` : one ADC v_decr per tile and direction, measured on
                       that tile's own partial-sum distribution.
  * `pack_chip`      (mapping.pack_tiles / pack_tiles_transposed):
                       per-layer `PackedCIMLayer`s; the transpose (BL->SL)
                       direction shares the forward gd_tiles stack.

`compile_chip` composes them into a `CompiledChip` and, by default, runs
the chip-IR verifier (`core.verify.verify_chip`) over it. `packed_forward`
serves one packed layer: quantize, one kernel launch, rescale.
`CIMEngine` holds one compiled chip on its device and serves it by name
and direction, one launch per forward. The PACT input clip (`in_alpha`,
`in_alpha_bwd`) is a float or a per-name dict; a name the dict lacks
takes 1.0, as in the reference (`_alpha_for`).

`program` / `forward` are the per-matrix path (`models/nn.chip_linear` /
`chip_conv`, the CNN deploys): one programmed matrix through ONE launch
of the single-matrix kernel with the glue fused in
(`kernels/cim_mvm.kernel.cim_forward`: float patches in, bias rows as a
constant, quantized on load; the de-normalized digital output in x @ W
units with measured ADC offsets cancelled). `program` runs the verifier's
`exact-dot` check on every programmed matrix and `prepare`s it: gd = G+ -
G-, the normalizer's inverse and the integer offset counts are formed
once, not per call. Configurations with a per-phase non-ideality (IR
drop, wire R, coupling, an ADC offset spread) or the stochastic neuron
take the reference's own route for them, the bit-serial oracle
(`kernels/cim_mvm/ref.py`, `_needs_ref`), with the same quantization,
offset cancellation and dequantization around it.

Randomness (programming noise, synthetic calibration batches) comes from
an explicit `torch.Generator`; callers that must match the JAX reference
pass the reference's calibration batches as `x_cal` / `x_cal_bwd`, or its
programmed layers (`convert.chip_states_from_numpy`), instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from .calibration import calibrate_layer, quantile_linear
from .conductance import program_conductances, weights_to_conductances
from .mapping import (MatrixReq, PackedPlan, Plan, TileSchedule, block_view,
                      ir_drop_max_cols, pack_tiles, pack_tiles_transposed,
                      plan_layers, schedule_tiles)
from .quant import quantize_to_int
from .types import CIMConfig, CoreSpec
from .verify import check_layer, verify_chip
from .writeverify import iterative_program
from ..kernels.cim_mvm import kernel as _K
from ..kernels.cim_mvm.ops import cim_mvm_packed
from ..kernels.cim_mvm.ref import cim_mvm_ref, dequantize_output

# the programmed state of a CIMLayer, as the reference's CIMLayer has it
LAYER_FIELDS = ("g_pos", "g_neg", "w_max", "norm", "v_decr", "adc_offset",
                "in_alpha")


class CIMLayer(NamedTuple):
    """One weight matrix programmed onto (simulated) RRAM cores; the last
    three fields are what the single-matrix kernel reads, formed once by
    `prepare` (None until then)."""
    g_pos: torch.Tensor
    g_neg: torch.Tensor
    w_max: torch.Tensor
    norm: torch.Tensor
    v_decr: torch.Tensor
    adc_offset: torch.Tensor
    in_alpha: torch.Tensor     # PACT input clip
    gd: Optional[torch.Tensor] = None          # G+ - G-, (K, N) f32
    inv_norm: Optional[torch.Tensor] = None    # 1 / norm, (N,) f32
    off_counts: Optional[torch.Tensor] = None  # round(adc_offset / v_decr)


def prepare(layer: CIMLayer) -> CIMLayer:
    """The layer with its kernel operands formed: gd = G+ - G-, 1 / norm
    and the ADC offsets in counts, each contiguous f32 on the layer's
    device."""
    f32 = torch.float32
    return layer._replace(
        gd=(layer.g_pos - layer.g_neg).to(f32).contiguous(),
        inv_norm=(1.0 / layer.norm.to(f32)).contiguous(),
        off_counts=torch.round(layer.adc_offset / layer.v_decr).to(f32)
        .contiguous())


def synthetic_x_cal(rows: int, in_alpha: float, generator: torch.Generator):
    """A synthetic (64, rows) calibration batch matched to the input clip:
    truncated normal in [-2, 2] times in_alpha, drawn from `generator` on
    its own device."""
    x = torch.empty((64, rows), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return in_alpha * x


def program(w, cfg: CIMConfig, in_alpha=1.0, x_cal=None,
            mode: str = "relaxed",
            generator: Optional[torch.Generator] = None) -> CIMLayer:
    """Program weight matrix w (R, C) onto the chip at fidelity `mode`
    ('ideal', 'relaxed' or 'writeverify') and calibrate it.

    x_cal: optional (B_cal, R) float calibration activations; None draws a
    synthetic batch. Programming noise, then the synthetic batch, then the
    ADC offsets of an offset spread are drawn from `generator` (a fresh one
    seeded 0 on w's device if None). Runs the verifier's per-matrix
    `exact-dot` check.
    """
    gen = generator or torch.Generator(w.device).manual_seed(0)
    if mode == "ideal":
        c = weights_to_conductances(w, cfg.device)
    elif mode == "relaxed":
        c = program_conductances(gen, w, cfg.device, iterations=3)
    elif mode == "writeverify":
        ideal = weights_to_conductances(w, cfg.device)
        g_pos = iterative_program(gen, ideal.g_pos, cfg.device)
        g_neg = iterative_program(gen, ideal.g_neg, cfg.device)
        c = type(ideal)(g_pos, g_neg, ideal.w_max,
                        torch.sum(g_pos + g_neg, dim=0))
    else:
        raise ValueError(f"mode must be 'ideal', 'relaxed' or "
                         f"'writeverify', got {mode!r}")
    check_layer(c.g_pos, c.g_neg)
    if x_cal is None:
        x_cal = synthetic_x_cal(w.shape[0], in_alpha, gen)
    x_int_cal, _ = quantize_to_int(x_cal, in_alpha, cfg.in_bits, signed=True)
    cal = calibrate_layer(x_int_cal, c.g_pos, c.g_neg, cfg, generator=gen)
    return prepare(CIMLayer(
        c.g_pos, c.g_neg, c.w_max, c.norm, cal.v_decr, cal.adc_offset,
        torch.tensor(float(in_alpha), dtype=torch.float32, device=w.device)))


def forward(layer: CIMLayer, x, cfg: CIMConfig, *, bias=None,
            bias_rows: int = 0, seed: int = 0, impl: str = "auto",
            generator: Optional[torch.Generator] = None):
    """y ~= x @ W through the chip datapath of one prepared matrix. x:
    (B, R - bias_rows) float; the last bias_rows weight rows are driven
    with `bias` (0-d). One launch of the single-matrix kernel, the input
    quantization, the digital offset cancellation (offsets measured during
    calibration) and the dequantization fused in; impl="plain" forces its
    plain version (on-card comparison only). seed: the reference's salt
    of the kernel's stochastic neuron, which this path does not take.

    Where the reference's `_needs_ref` holds (a per-phase non-ideality or
    the stochastic neuron), the layer runs the bit-serial oracle instead,
    with its stored offsets present; the coupling noise and the
    stochastic neuron draw from `generator`."""
    if layer.gd is None:
        raise ValueError("the layer is not prepared: pass it through "
                         "core.cim.prepare once after programming")
    if _needs_ref(cfg):
        return _oracle_forward(layer, x, cfg, bias, bias_rows, generator)
    return _K.cim_forward(
        x.contiguous(), layer.gd, layer.inv_norm, layer.v_decr,
        layer.off_counts, layer.norm, layer.w_max, layer.in_alpha, cfg,
        bias=bias, bias_rows=bias_rows, impl=impl)


def _oracle_forward(layer: CIMLayer, x, cfg: CIMConfig, bias,
                    bias_rows: int, generator):
    """The reference's forward on its oracle route: the bias rows
    appended, quantize_to_int, the bit-serial oracle with the layer's
    ADC offsets in the charge, their counts cancelled (activation
    'none'), dequantize_output."""
    if bias_rows:
        x = torch.cat([x, bias.expand(x.shape[0], bias_rows).to(x.dtype)],
                      dim=-1)
    x_int, scale = quantize_to_int(x, layer.in_alpha, cfg.in_bits,
                                   signed=True)
    counts = cim_mvm_ref(x_int, layer.g_pos, layer.g_neg, layer.v_decr, cfg,
                         generator=generator, adc_offset=layer.adc_offset,
                         bit_serial=True).counts
    if cfg.activation == "none":
        counts = counts - layer.off_counts[None, :]
    return dequantize_output(counts, layer.v_decr, layer.norm, layer.w_max,
                             scale, cfg)


def _needs_ref(cfg: CIMConfig) -> bool:
    """Per-phase non-idealities require the bit-serial oracle path."""
    ni = cfg.nonideal
    return (ni.ir_drop_alpha > 0 or ni.wire_r_alpha > 0
            or ni.coupling_sigma > 0 or ni.adc_offset_sigma > 0
            or cfg.activation == "stochastic")


def effective_weight(layer: CIMLayer, cfg: CIMConfig):
    """The weight the (noisy) array actually realizes."""
    return (layer.g_pos - layer.g_neg) * layer.w_max / cfg.device.g_max


class PackedCIMLayer(NamedTuple):
    """One programmed layer + its packed tile plan."""
    layer: CIMLayer
    packed: PackedPlan


def calibrate_tile_v_decr(layer: CIMLayer, tiles, x_cal, cfg: CIMConfig,
                          coverage: float = 0.999, *,
                          direction: str = "fwd",
                          in_alpha: Optional[float] = None):
    """Per-core, per-direction ADC calibration: one v_decr per tile,
    covering that tile's OWN normalized partial-sum distribution
        fwd: q_t = (x_t @ gd_t) * v_read / (column sums of G+ + G-)
        bwd: q_t = (x_t @ gd_t.T) * v_read / (row sums of G+ + G-)
    with x_cal in the direction's input space ((B, C) for 'bwd') and
    `in_alpha` overriding the layer's forward input clip. Batched over
    all tiles of the layer: the (R, C) matrix viewed as (row_block,
    col_block, bk, bn) blocks gives every tile's partial sums in one
    product. Returns (T,) aligned with the replica-0 tiles in the given
    order."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction must be 'fwd' or 'bwd', got "
                         f"{direction!r}")
    tiles = [t for t in tiles if not t.replica]
    alpha = layer.in_alpha if in_alpha is None else in_alpha
    x_int, _ = quantize_to_int(x_cal, alpha, cfg.in_bits, signed=True)
    bk = max(t.rows for t in tiles)
    bn = max(t.cols for t in tiles)
    dev = layer.g_pos.device
    rb = torch.tensor([t.row0 // bk for t in tiles], device=dev)
    cb = torch.tensor([t.col0 // bn for t in tiles], device=dev)
    rows = torch.tensor([t.rows for t in tiles], device=dev)
    cols = torch.tensor([t.cols for t in tiles], device=dev)
    rmask = torch.arange(bk, device=dev)[None, :] < rows[:, None]
    cmask = torch.arange(bn, device=dev)[None, :] < cols[:, None]
    keep = rmask[:, :, None] & cmask[:, None, :]
    zero = torch.zeros((), device=dev)
    gd = torch.where(keep, block_view(layer.g_pos - layer.g_neg, bk, bn)[rb, cb],
                     zero)
    gs = torch.where(keep,
                     block_view(layer.g_pos + layer.g_neg, bk, bn)[rb, cb],
                     zero)
    xf = x_int.to(torch.float32)
    n_b = xf.shape[0]
    if direction == "fwd":                  # x_t: (T, B, bk) -> q: (T, B, bn)
        xt = block_view(xf, n_b, bk)[0][rb]
        xt = torch.where(rmask[:, None, :], xt, zero)
        q = torch.bmm(xt, gd) * cfg.v_read / gs.sum(dim=1)[:, None, :]
        ok, n_out = cmask, cols
    else:                                   # x_t: (T, B, bn) -> q: (T, B, bk)
        xt = block_view(xf, n_b, bn)[0][cb]
        xt = torch.where(cmask[:, None, :], xt, zero)
        q = torch.bmm(xt, gd.transpose(1, 2)) * cfg.v_read \
            / gs.sum(dim=2)[:, None, :]
        ok, n_out = rmask, rows
    absq = torch.where(ok[:, None, :], q.abs(),
                       torch.full((), float("inf"), device=dev))
    qmax = quantile_linear(absq.reshape(len(tiles), -1), coverage,
                           n_out * n_b)
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


def packed_forward(pcl: PackedCIMLayer, x, cfg: CIMConfig, *, seed: int = 0,
                   impl: str = "auto"):
    """y ~= x @ W through the packed chip datapath. x: (B, R) float over
    the layer's full weight rows; the whole tile plan is one kernel
    launch, with row-split partial sums de-normalized per core and
    accumulated digitally inside it. seed: the stochastic neuron's salt."""
    layer, packed = pcl.layer, pcl.packed
    if cfg.activation == "stochastic" and packed.n_row_blocks > 1:
        raise ValueError(
            f"stochastic sampling on plan '{packed.layer}' would sum "
            f"comparator bits across {packed.n_row_blocks} input splits "
            "into non-Bernoulli values; serve a direction whose input fits "
            "one block")
    x_int, scale = quantize_to_int(x, layer.in_alpha, cfg.in_bits,
                                   signed=True)
    acc = cim_mvm_packed(x_int, packed, cfg, seed=seed, impl=impl)
    if cfg.activation in ("tanh", "sigmoid", "stochastic"):
        return acc                     # already neuron units
    return acc * layer.w_max * scale / (cfg.v_read * cfg.device.g_max)


# ------------------------------------------------- chip-compiler pipeline

@dataclasses.dataclass(eq=False)
class CompiledChip:
    """The chip-compiler's output: every stage's result, servable. When
    compiled with directions=("fwd", "bwd") every matrix also carries a
    transpose-direction packed view in `bwd_layers`, sharing its forward
    gd_tiles stack by reference."""
    cfg: CIMConfig
    spec: CoreSpec
    mode: str
    plan: Plan
    schedules: Dict[str, TileSchedule]
    layers: Dict[str, PackedCIMLayer]
    bwd_layers: Dict[str, PackedCIMLayer] = dataclasses.field(
        default_factory=dict)

    @property
    def directions(self) -> Tuple[str, ...]:
        return ("fwd", "bwd") if self.bwd_layers else ("fwd",)

    def layers_for(self, direction: str) -> Dict[str, PackedCIMLayer]:
        if direction == "fwd":
            return self.layers
        if direction == "bwd":
            if not self.bwd_layers:
                raise ValueError(
                    "chip was not compiled with directions=('fwd','bwd')")
            return self.bwd_layers
        raise ValueError(f"direction must be 'fwd' or 'bwd', got "
                         f"{direction!r}")

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


Alpha = Union[float, Dict[str, float]]


def _alpha_for(in_alpha: Alpha, name: str) -> float:
    """The PACT clip of `name`: the float, or the dict's entry (1.0 where
    it has none, as the reference's `_alpha_for`)."""
    return (in_alpha.get(name, 1.0)
            if isinstance(in_alpha, dict) else in_alpha)


def program_chip(weights: Dict[str, torch.Tensor], cfg: CIMConfig, *,
                 mode: str = "relaxed", in_alpha: Alpha = 1.0,
                 x_cal: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None):
    """Stage 3 (PROGRAM): conductances + whole-matrix calibration per
    matrix, in sorted name order, each at its own clip
    (`_alpha_for(in_alpha, name)`). Returns (name -> CIMLayer, name ->
    calibration batch); the same batch drives stage 4. Programming noise
    comes from `generator` (a fresh one seeded 0 if None)."""
    layers: Dict[str, CIMLayer] = {}
    batches: Dict[str, torch.Tensor] = {}
    prog_gen = generator
    for name in sorted(weights):
        w = weights[name]
        alpha = _alpha_for(in_alpha, name)
        xc = _batch(x_cal, name, w.shape[0], alpha, generator, w.device)
        if prog_gen is None:
            prog_gen = torch.Generator(w.device).manual_seed(0)
        layers[name] = program(w, cfg, in_alpha=alpha, x_cal=xc,
                               mode=mode, generator=prog_gen)
        batches[name] = xc
    return layers, batches


def _batch(x_cal, name: str, width: int, in_alpha: float, generator,
           device):
    """The calibration batch for `name`: the given one, or a synthetic one
    matched to the input clip from `generator` (a fresh one seeded 0)."""
    xc = x_cal.get(name) if x_cal is not None else None
    if xc is None:
        gen = generator or torch.Generator(device).manual_seed(0)
        xc = synthetic_x_cal(width, in_alpha, gen)
    return torch.as_tensor(xc, dtype=torch.float32, device=device)


def calibrate_chip(layers: Dict[str, CIMLayer], plan: Plan,
                   batches: Dict[str, torch.Tensor], cfg: CIMConfig, *,
                   direction: str = "fwd",
                   in_alpha: Optional[Alpha] = None
                   ) -> Dict[str, torch.Tensor]:
    """Stage 4 (CALIBRATE): one v_decr per tile in `direction`; batches
    live in the direction's input space, in_alpha (float or per-name)
    overrides the forward clip for the transpose direction."""
    return {n: calibrate_tile_v_decr(
        layers[n], plan.tiles_for(n), batches[n], cfg, direction=direction,
        in_alpha=None if in_alpha is None else _alpha_for(in_alpha, n))
        for n in layers}


def pack_chip(layers: Dict[str, CIMLayer], plan: Plan,
              schedules: Dict[str, TileSchedule], cfg: CIMConfig,
              v_decrs: Dict[str, torch.Tensor], *, direction: str = "fwd",
              packed: Optional[Dict[str, PackedCIMLayer]] = None,
              in_alpha: Alpha = 1.0) -> Dict[str, PackedCIMLayer]:
    """Stage 5 (PACK). direction='bwd' packs the transpose view of an
    already packed forward chip (`packed`), sharing its gd_tiles stacks;
    in_alpha (float or per-name) is then the transpose direction's input
    clip."""
    if direction == "fwd":
        return {n: pack_cim_layer(layers[n], plan.tiles_for(n), cfg,
                                  v_decr=v_decrs[n], schedule=schedules[n])
                for n in layers}
    if direction != "bwd":
        raise ValueError(f"direction must be 'fwd' or 'bwd', got "
                         f"{direction!r}")
    if packed is None:
        raise ValueError("direction='bwd' needs the forward pack "
                         "(packed=...) whose gd_tiles it shares")
    fold = cfg.activation not in ("tanh", "sigmoid", "stochastic")
    out: Dict[str, PackedCIMLayer] = {}
    for n, lay in layers.items():
        p_bwd = pack_tiles_transposed(
            plan.tiles_for(n), packed[n].packed,
            gsum=lay.g_pos + lay.g_neg, v_decr=v_decrs[n],
            fold_norm=fold, schedule=schedules[n])
        # the transpose view of the programmed layer: the SAME conductance
        # tensors, that direction's normalizer (row sums), a conservative
        # whole-matrix ADC step (the per-tile steps in the pack serve) and
        # its own input clip
        dev = lay.g_pos.device
        lay_bwd = CIMLayer(
            lay.g_pos, lay.g_neg, lay.w_max,
            torch.sum(lay.g_pos + lay.g_neg, dim=1), torch.max(v_decrs[n]),
            torch.zeros((lay.g_pos.shape[0],), device=dev),
            torch.tensor(_alpha_for(in_alpha, n), dtype=torch.float32,
                         device=dev))
        out[n] = PackedCIMLayer(lay_bwd, p_bwd)
    return out


def _oracle_only(cfg: CIMConfig) -> bool:
    """Non-idealities the packed serving path cannot honor at all (IR drop
    is planned around: `mapping.ir_drop_max_cols`)."""
    ni = cfg.nonideal
    return (ni.wire_r_alpha > 0 or ni.coupling_sigma > 0
            or ni.adc_offset_sigma > 0)


def compile_chip(weights: Dict[str, torch.Tensor], cfg: CIMConfig,
                 spec: CoreSpec = CoreSpec(), mode: str = "relaxed", *,
                 reqs: Optional[Sequence[MatrixReq]] = None,
                 plan: Optional[Plan] = None, in_alpha: Alpha = 1.0,
                 x_cal: Optional[Dict[str, torch.Tensor]] = None,
                 directions: Sequence[str] = ("fwd",),
                 in_alpha_bwd: Alpha = 1.0,
                 x_cal_bwd: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 verify: str = "strict") -> CompiledChip:
    """Run plan -> schedule -> program -> calibrate -> pack over one chip's
    weight matrices (name -> (R, C), all on one device).

    reqs: optional MatrixReqs for stage 1 (their intensities steer
    duplication); one plain req per weight by default. in_alpha /
    in_alpha_bwd: PACT clips, a float or per-name (1.0 for a missing
    name). plan: optional pre-built Plan overriding stage 1 (a custom mapping,
    such as the pixel-interleaved RBM, or one layer's plan reused for
    every layer of a stack of equal shapes). x_cal: optional per-name
    (B_cal, R) calibration activations; missing names draw synthetic
    batches from `generator`. directions ("fwd",) or ("fwd", "bwd"): with
    "bwd" every matrix is also calibrated and packed in the transpose
    direction, from x_cal_bwd ((B_cal, C) per name) at input clip
    in_alpha_bwd. verify: "strict" (the default) runs the chip-IR
    verifier; "off" skips it.
    """
    if verify not in ("strict", "off"):
        raise ValueError(f"verify must be 'strict' or 'off', got "
                         f"{verify!r}")
    if _oracle_only(cfg):
        raise ValueError(
            "compile_chip serves the fused kernel path only; per-phase "
            "non-idealities require the bit-serial oracle")
    directions = tuple(directions)
    if "fwd" not in directions or set(directions) - {"fwd", "bwd"}:
        raise ValueError(f"directions must be ('fwd',) or ('fwd','bwd'), "
                         f"got {directions}")
    if plan is None:
        reqs = list(reqs) if reqs is not None else [
            MatrixReq(n, int(w.shape[0]), int(w.shape[1]))
            for n, w in weights.items()]
        if {r.name for r in reqs} != set(weights):
            raise ValueError("reqs names must match weights names")
        plan = plan_chip(reqs, cfg, spec)
    else:
        for n, w in weights.items():
            ts = plan.tiles_for(n)
            if not ts:
                raise ValueError(f"supplied plan has no tiles for '{n}'")
            ext = (max(t.row0 + t.rows for t in ts),
                   max(t.col0 + t.cols for t in ts))
            if ext != tuple(w.shape):
                raise ValueError(
                    f"supplied plan covers {ext} for '{n}' but the weight "
                    f"is {tuple(w.shape)}")
    schedules = schedule_chip(plan, sorted(weights))
    layers, batches = program_chip(weights, cfg, mode=mode,
                                   in_alpha=in_alpha, x_cal=x_cal,
                                   generator=generator)
    v_decrs = calibrate_chip(layers, plan, batches, cfg)
    packed = pack_chip(layers, plan, schedules, cfg, v_decrs)
    bwd_packed: Dict[str, PackedCIMLayer] = {}
    if "bwd" in directions:
        batches_bwd = {n: _batch(x_cal_bwd, n, w.shape[1],
                                 _alpha_for(in_alpha_bwd, n), generator,
                                 w.device)
                       for n, w in sorted(weights.items())}
        v_decrs_bwd = calibrate_chip(layers, plan, batches_bwd, cfg,
                                     direction="bwd", in_alpha=in_alpha_bwd)
        bwd_packed = pack_chip(layers, plan, schedules, cfg, v_decrs_bwd,
                               direction="bwd", packed=packed,
                               in_alpha=in_alpha_bwd)
    chip = CompiledChip(cfg=cfg, spec=spec, mode=mode, plan=plan,
                        schedules=schedules, layers=packed,
                        bwd_layers=bwd_packed)
    if verify == "strict":
        verify_chip(chip)
    return chip


class CIMEngine:
    """Serves one CompiledChip on `device`: compile once (`program`), then
    each `forward` is ONE launch of the layer's kernel — packed,
    scheduled or, for direction "bwd", transposed (`packed_forward`).

        eng = CIMEngine(cfg, mode="relaxed", device="cuda")
        eng.program({"fc1": w1, "fc2": w2})       # plan ... pack
        y = eng.forward("fc1", x)

    The weights are moved to `device` before programming, so the chip's
    state lives where it serves; `device` is CUDA unless "cpu" is passed
    (the CPU runs the kernels' plain versions). Configurations with a
    per-phase non-ideality other than IR drop need the bit-serial oracle
    and raise, as in the reference.
    """

    def __init__(self, cfg: CIMConfig, spec: CoreSpec = CoreSpec(),
                 mode: str = "relaxed", device=None):
        from ..device import resolve_device
        if _oracle_only(cfg):
            raise ValueError(
                "CIMEngine serves the fused kernel path only; per-phase "
                "non-idealities require the bit-serial oracle")
        self.cfg = cfg
        self.spec = spec
        self.mode = mode
        self.device = resolve_device(device)
        self.chip: Optional[CompiledChip] = None

    @property
    def plan(self) -> Optional[Plan]:
        return self.chip.plan if self.chip is not None else None

    @property
    def layers(self) -> Dict[str, PackedCIMLayer]:
        return self.chip.layers if self.chip is not None else {}

    def program(self, weights: Dict[str, torch.Tensor], *,
                reqs: Optional[Sequence[MatrixReq]] = None,
                plan: Optional[Plan] = None, in_alpha: Alpha = 1.0,
                x_cal: Optional[Dict[str, torch.Tensor]] = None,
                directions: Sequence[str] = ("fwd",),
                in_alpha_bwd: Alpha = 1.0,
                x_cal_bwd: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Plan:
        """Compile `weights` into a fresh chip (the old one is dropped);
        see `compile_chip`. With directions=("fwd", "bwd") every matrix
        also serves transposed. Returns the plan."""
        dev = self.device
        on = lambda d: None if d is None else {
            n: torch.as_tensor(v, dtype=torch.float32, device=dev)
            for n, v in d.items()}
        self.chip = compile_chip(
            on(weights), self.cfg, self.spec, self.mode, reqs=reqs,
            plan=plan, in_alpha=in_alpha, x_cal=on(x_cal),
            directions=directions, in_alpha_bwd=in_alpha_bwd,
            x_cal_bwd=on(x_cal_bwd), generator=generator)
        return self.chip.plan

    def forward(self, name: str, x, *, direction: str = "fwd",
                seed: int = 0, impl: str = "auto"):
        """y ~= x @ W_name (direction "fwd", SL->BL) or x @ W_name.T
        ("bwd", BL->SL, over the same programmed cells): one kernel
        launch (impl="plain": its plain version)."""
        if self.chip is None:
            raise ValueError("the engine holds no chip: call program first")
        return packed_forward(self.chip.layers_for(direction)[name], x,
                              self.cfg, seed=seed, impl=impl)

    def __contains__(self, name: str) -> bool:
        return name in self.layers
