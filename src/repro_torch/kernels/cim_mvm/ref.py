"""Plain-torch model of one NeuRRAM MVM, the bit-serial oracle (PyTorch
port of `repro/kernels/cim_mvm/ref.py`; paper Methods, 'Implementation of
MVM with multi-bit inputs and outputs').

  input phase:  an n-bit signed input is sent as (n-1) ternary pulse
                phases; phase k's settled output voltage is
                    V_j^k = V_read * (p_k @ (G+ - G-))_j / norm_j
                (the voltage-mode conductance normalization), integrated
                for 2^k cycles, so the charge is
                    Q_j = V_read * (x_int @ Gd)_j / norm_j  (+ non-idealities)
  output phase: sign bit from comparator polarity; magnitude by counting
                charge-decrement steps of size v_decr until the polarity
                flips (early-stopped at N_max = 2^(out_bits-1)-1 steps),
                with ReLU / tanh / sigmoid fused into the conversion; the
                stochastic neuron adds LFSR noise to the integrator and
                emits the comparator bit.

`bit_serial=True` walks the pulse phases, which the per-phase
non-idealities need: IR droop from each phase's own load, crossbar wire
attenuation, coupling noise scaled by the active pulses, ADC offsets (given
or drawn). `bit_serial=False` is the algebraic identity sum_k 2^k p_k =
x_int (the same where the datapath is linear; the calibration's analog
pass). Draws (coupling, the offset spread, the stochastic neuron) come
from an explicit `torch.Generator`, in that order, where the reference
splits its key; they are held to the reference by their statistics.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...core.noise import lfsr_noise
from ...core.quant import int_bit_planes
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


def _need(generator, what: str):
    if generator is None:
        raise ValueError(f"{what} needs a generator (the reference asserts "
                         "a PRNG key)")


def adc_convert(q, cfg: CIMConfig, v_decr, *,
                generator: Optional[torch.Generator] = None):
    """Neuron output phase: charge -> signed counts with fused activation
    (the stochastic neuron's comparator bit: LFSR noise from
    `generator`)."""
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
        _need(generator, "the stochastic neuron")
        noise = lfsr_noise(generator, q.shape, v_decr * n_max)
        return (q + noise > 0).to(torch.int32)
    return (sign * torch.clamp(steps, max=float(n_max))).to(torch.int32)


def cim_mvm_ref(x_int, g_pos, g_neg, v_decr, cfg: CIMConfig, *,
                generator: Optional[torch.Generator] = None,
                adc_offset: Optional[torch.Tensor] = None,
                bit_serial: bool = True) -> CIMOutput:
    """Oracle CIM MVM. x_int: (B, R) integers; g_pos / g_neg: (R, C) uS;
    v_decr: scalar or (C,); adc_offset: (C,) volts, or None to draw the
    spread `cfg.nonideal.adc_offset_sigma` from `generator`.
    bit_serial=True walks the per-bit pulse phases (needed when per-phase
    non-idealities are on); bit_serial=False uses the algebraic identity
    (coupling, which lives between phases, is then not modeled)."""
    ni = cfg.nonideal
    gd = g_pos - g_neg
    gsum = g_pos + g_neg
    gtot_row = torch.sum(gsum, dim=1)     # total conductance per input wire
    norm = torch.sum(gsum, dim=0)

    def settle(pulses):
        """Pulse phases (..., B, R) -> settled column voltages (..., B,
        C)."""
        pf = pulses.to(torch.float32)
        v_in = pf * cfg.v_read
        if ni.ir_drop_alpha > 0.0:
            # (i)+(ii): the input drive droops with the total current the
            # active rows source, nonlinear in the input pattern
            load = torch.abs(pf) @ gtot_row
            droop = torch.clamp(1.0 - ni.ir_drop_alpha * load, 0.7, 1.0)
            v_in = v_in * droop[..., None]
        v_out = (v_in @ gd) / norm
        if ni.wire_r_alpha > 0.0:
            # (iii): crossbar wire resistance, an output attenuation growing
            # with the column's total conductance
            v_out = v_out * (1.0 - ni.wire_r_alpha * norm / torch.max(norm))
        return v_out

    if bit_serial:
        planes = int_bit_planes(x_int, cfg.in_mag_bits)      # (K, B, R)
        v_phases = settle(planes)                            # (K, B, C)
        q = v_phases[0] * float(2 ** (cfg.in_mag_bits - 1))
        for k in range(1, cfg.in_mag_bits):                  # MSB first
            q = q + v_phases[k] * float(2 ** (cfg.in_mag_bits - 1 - k))
        if ni.coupling_sigma > 0.0:
            _need(generator, "coupling noise")
            n_active = torch.sum(torch.abs(planes), dim=(0, 2)).to(
                torch.float32)
            q = q + (ni.coupling_sigma * torch.sqrt(n_active + 1.0))[:, None] \
                * torch.randn(q.shape, generator=generator, device=q.device)
    else:
        q = settle(x_int)

    if adc_offset is not None:
        q = q + adc_offset[None, :]
    elif ni.adc_offset_sigma > 0.0:
        _need(generator, "the ADC offset spread")
        q = q + ni.adc_offset_sigma * torch.randn(
            (q.shape[-1],), generator=generator, device=q.device)[None, :]
    return CIMOutput(adc_convert(q, cfg, v_decr, generator=generator), q)


def dequantize_output(counts, v_decr, norm, w_max, in_scale, cfg: CIMConfig):
    """Map ADC counts back to x @ W units (the chip multiplies the
    pre-computed normalizer back digitally)."""
    c = counts.to(torch.float32)
    if cfg.activation in ("tanh", "sigmoid", "stochastic"):
        return c  # activation outputs are already in neuron units
    return c * v_decr * norm[None, :] * w_max * in_scale \
        / (cfg.v_read * cfg.device.g_max)
