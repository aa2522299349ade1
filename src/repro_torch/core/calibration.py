"""Model-driven chip calibration (PyTorch port of
`repro/core/calibration.py`; paper Fig. 3b, Extended Data Fig. 5).

The ADC charge-decrement step v_decr is calibrated so the output
distribution of training-set activations fills the ADC swing. The
quantile is `jnp.quantile`'s linear method, written out over a sort:
`torch.quantile` caps its input size, and the per-tile calibration of a
full-width layer sorts thousands of tiles at once.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .types import CIMConfig
from ..kernels.cim_mvm.ref import cim_mvm_ref


class LayerCalibration(NamedTuple):
    v_decr: torch.Tensor       # 0-d ADC decrement step (volts)
    adc_offset: torch.Tensor   # (C,) volts measured with zero input


def quantile_linear(a, q: float, n_valid: Optional[torch.Tensor] = None):
    """`jnp.quantile(a, q, axis=-1)` with the linear method, in float32.

    a: (..., N). n_valid: optional (...) count of valid leading entries
    per row after sorting — pad the invalid entries of `a` with +inf so
    they sort last. Returns (...).
    """
    a = torch.sort(a.to(torch.float32), dim=-1).values
    if n_valid is None:
        n_valid = torch.full(a.shape[:-1], a.shape[-1], dtype=torch.float32,
                             device=a.device)
    n = n_valid.to(torch.float32)
    pos = torch.tensor(q, dtype=torch.float32, device=a.device) * (n - 1)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    low = torch.minimum(torch.clamp(low, min=0), n - 1).to(torch.int64)
    high = torch.minimum(torch.clamp(high, min=0), n - 1).to(torch.int64)
    lo_v = torch.gather(a, -1, low[..., None])[..., 0]
    hi_v = torch.gather(a, -1, high[..., None])[..., 0]
    return lo_v * low_w + hi_v * high_w


def calibrate_v_decr(q_samples, cfg: CIMConfig, coverage: float = 0.999):
    """Pick v_decr so `coverage` of |Q| falls inside the N_max counts."""
    qmax = quantile_linear(torch.abs(q_samples).reshape(-1), coverage)
    return torch.clamp(qmax, min=1e-9) / cfg.out_mag_levels


def tile_partial_sums(x_int, g_pos, g_neg, tile, cfg: CIMConfig,
                      direction: str = "fwd"):
    """Normalized analog partial sums ONE core (tile) produces on a batch.

      'fwd' (SL->BL): inputs drive the tile's weight rows, outputs appear
            on its columns; normalizer = per-column sum of G+ + G-.
      'bwd' (BL->SL): inputs drive the tile's COLUMNS, outputs appear on
            its rows; normalizer = per-row sum of G+ + G-.

    x_int: (B, R) / (B, C) integer activations in the direction's input
    space, in full-matrix coordinates.
    """
    r0, r1 = tile.row0, tile.row0 + tile.rows
    c0, c1 = tile.col0, tile.col0 + tile.cols
    gp, gn = g_pos[r0:r1, c0:c1], g_neg[r0:r1, c0:c1]
    xf = x_int.to(torch.float32)
    if direction == "fwd":
        return (xf[:, r0:r1] @ (gp - gn)) * cfg.v_read \
            / torch.sum(gp + gn, dim=0)
    if direction == "bwd":
        return (xf[:, c0:c1] @ (gp - gn).T) * cfg.v_read \
            / torch.sum(gp + gn, dim=1)
    raise ValueError(f"direction must be 'fwd' or 'bwd', got {direction!r}")


def measure_adc_offsets(generator: Optional[torch.Generator], n_cols: int,
                        cfg: CIMConfig, device=None):
    """Neuron-testing mode: zero input through the neurons reveals the
    per-neuron offsets, which the controller stores and cancels
    digitally: N(0, adc_offset_sigma^2) per column from `generator`, or
    zeros on `device` where the configuration has no spread."""
    sigma = cfg.nonideal.adc_offset_sigma
    if sigma <= 0.0:
        return torch.zeros((n_cols,), dtype=torch.float32, device=device)
    if generator is None:
        raise ValueError("the ADC offset spread needs a generator")
    return sigma * torch.randn((n_cols,), generator=generator,
                               device=generator.device)


def calibrate_layer(x_int_cal, g_pos, g_neg, cfg: CIMConfig,
                    coverage: float = 0.999, *,
                    generator: Optional[torch.Generator] = None
                    ) -> LayerCalibration:
    """x_int_cal: (B_cal, R) integer activations from the *training set*.
    The offsets are measured first (drawn from `generator` under a
    spread); the analog pass runs with them present, so v_decr covers the
    offset-shifted charge."""
    offs = measure_adc_offsets(generator, g_pos.shape[1], cfg, g_pos.device)
    # analog-only pass: only q_analog is read, so the ADC runs without an
    # activation (no stochastic draw)
    out = cim_mvm_ref(x_int_cal, g_pos, g_neg, 1.0,
                      dataclasses.replace(cfg, activation="none"),
                      adc_offset=offs, bit_serial=False)
    return LayerCalibration(calibrate_v_decr(out.q_analog, cfg, coverage),
                            offs)


def search_v_read(x_int_cal, g_pos, g_neg, cfg: CIMConfig,
                  candidates=(0.2, 0.3, 0.4, 0.5, 0.6), *,
                  generator: Optional[torch.Generator] = None) -> float:
    """Grid-search the read voltage: a larger V_read raises the SNR but
    worsens the IR-drop droop (non-linear). Score: minus the mean squared
    error of the analog output / V_read against the ideal linear MVM on
    the calibration batch; the first best candidate wins. Under an offset
    spread every candidate sees the same offsets, drawn once from
    `generator` (the reference reuses one key)."""
    gd = g_pos - g_neg
    norm = torch.sum(g_pos + g_neg, dim=0)
    ideal = (x_int_cal.to(torch.float32) @ gd) / norm
    offs = measure_adc_offsets(generator, g_pos.shape[1], cfg, g_pos.device)
    best_v, best_score = cfg.v_read, -float("inf")
    for v in candidates:
        c = dataclasses.replace(cfg, v_read=float(v), activation="none")
        out = cim_mvm_ref(x_int_cal, g_pos, g_neg, 1.0, c, adc_offset=offs,
                          bit_serial=False)
        score = -float(torch.mean((out.q_analog / v - ideal) ** 2))
        if score > best_score:
            best_v, best_score = float(v), score
    return best_v
