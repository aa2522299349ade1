"""Plain-torch model of one NeuRRAM MVM (PyTorch port of
`repro/kernels/cim_mvm/ref.py`).

  input phase:  the settled output voltage of a column is
                    V_j = V_read * (x_int @ (G+ - G-))_j / norm_j
                (the voltage-mode conductance normalization; the bit-serial
                pulses fold into x_int because the datapath is linear)
  output phase: sign bit from comparator polarity; magnitude by counting
                charge-decrement steps of size v_decr until the polarity
                flips (early-stopped at N_max = 2^(out_bits-1)-1 steps),
                with ReLU / tanh / sigmoid fused into the conversion.

Only the algebraic (`bit_serial=False`) path is ported, with the one
non-ideality that path models: IR drop, an input-drive droop that grows with
the total conductance the active rows source. The other per-phase
non-idealities need the bit-serial walk and raise. So does the stochastic
neuron: the reference draws its noise from a jax.random key, a stream the
port does not replay (the port's stochastic neuron is the kernels' hash
epilogue, kernels/prng.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...core.types import CIMConfig


class CIMOutput(NamedTuple):
    counts: torch.Tensor      # (B, C) int32 — signed ADC counts
    q_analog: torch.Tensor    # (B, C) float32 — pre-ADC charge (volts)


def pwl_tanh_counts(steps, n_max: int):
    """Piecewise-linear tanh counter schedule (paper Methods): the counter
    increments every decrement step up to 35, then every 2 steps to 40,
    every 3 to 43, every 4 beyond, scaled from the paper's 47-count layout
    to n_max."""
    steps = steps.to(torch.float32)
    s = n_max / 47.0
    k0, k1, k2 = 35.0 * s, 40.0 * s, 43.0 * s
    st0, st1, st2 = k0, k0 + 2.0 * (k1 - k0), k0 + 2.0 * (k1 - k0) + 3.0 * (k2 - k1)
    out = torch.where(
        steps <= st0, steps,
        torch.where(
            steps <= st1, k0 + (steps - st0) / 2.0,
            torch.where(steps <= st2, k1 + (steps - st1) / 3.0,
                        k2 + (steps - st2) / 4.0)))
    return torch.clamp(torch.floor(out), max=float(n_max))


def adc_convert(q, cfg: CIMConfig, v_decr):
    """Neuron output phase: charge -> signed counts with fused activation."""
    n_max = cfg.out_mag_levels
    sign = torch.sign(q)
    # round-to-nearest: the comparator flips when the cumulative decrement
    # first exceeds |Q|, i.e. mid-LSB
    steps = torch.floor(torch.abs(q) / v_decr + 0.5)
    if cfg.activation == "relu":
        return (torch.clamp(steps, max=float(n_max)) * (sign > 0)).to(torch.int32)
    if cfg.activation in ("tanh", "sigmoid"):
        mag = pwl_tanh_counts(torch.clamp(steps, max=float(4 * n_max)), n_max)
        out = sign * mag
        if cfg.activation == "sigmoid":
            out = torch.floor((out + n_max) / 2.0)  # shift to [0, n_max]
        return out.to(torch.int32)
    if cfg.activation == "stochastic":
        raise NotImplementedError(
            "the oracle's stochastic neuron needs the reference's jax.random "
            "noise stream, which is not ported; the kernels' stochastic "
            "epilogue is the port's stochastic neuron")
    return (sign * torch.clamp(steps, max=float(n_max))).to(torch.int32)


def _check_ideal(cfg: CIMConfig) -> None:
    ni = cfg.nonideal
    if ni.wire_r_alpha > 0 or ni.coupling_sigma > 0 \
            or ni.adc_offset_sigma > 0:
        raise NotImplementedError(
            "per-phase non-idealities need the bit-serial oracle, which is "
            "not ported yet")


def cim_mvm_ref(x_int, g_pos, g_neg, v_decr, cfg: CIMConfig, *,
                adc_offset: Optional[torch.Tensor] = None) -> CIMOutput:
    """Oracle CIM MVM, the reference's `bit_serial=False` path: the ideal
    datapath plus IR drop. x_int: (B, R) integers; g_pos/g_neg: (R, C)
    uS; v_decr: scalar or (C,)."""
    _check_ideal(cfg)
    gd = g_pos - g_neg
    norm = torch.sum(g_pos + g_neg, dim=0)
    xf = x_int.to(torch.float32)
    v_in = xf * cfg.v_read
    alpha = cfg.nonideal.ir_drop_alpha
    if alpha > 0.0:
        # (i)+(ii): the input drive droops with the total current the active
        # rows source, nonlinear in the input pattern
        load = torch.abs(xf) @ torch.sum(g_pos + g_neg, dim=1)
        droop = torch.clamp(1.0 - alpha * load, 0.7, 1.0)
        v_in = v_in * droop[:, None]
    q = (v_in @ gd) / norm
    if adc_offset is not None:
        q = q + adc_offset[None, :]
    return CIMOutput(adc_convert(q, cfg, v_decr), q)


def dequantize_output(counts, v_decr, norm, w_max, in_scale, cfg: CIMConfig):
    """Map ADC counts back to x @ W units (the chip multiplies the
    pre-computed normalizer back digitally)."""
    c = counts.to(torch.float32)
    if cfg.activation in ("tanh", "sigmoid", "stochastic"):
        return c  # activation outputs are already in neuron units
    return c * v_decr * norm[None, :] * w_max * in_scale \
        / (cfg.v_read * cfg.device.g_max)
