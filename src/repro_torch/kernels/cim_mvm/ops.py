"""Public entry points of the CIM MVM kernels (PyTorch port of
`repro/kernels/cim_mvm/ops.py`).

`cim_mvm` is the unfused single-matrix entry: it forms the folded
representation (differential conductance gd = G+ - G- and the per-column
normalizer) as the reference does and returns signed ADC counts from one
kernel launch. The models' per-matrix path (`core.cim.forward`) calls the
fused `kernel.cim_forward` on a prepared layer instead.

`cim_mvm_packed` executes a whole layer's TNSA tile plan
(core/mapping.PackedPlan) in one kernel launch — the serving path behind
core.cim.packed_forward. Row-split partial sums accumulate inside the
kernel; per-tile counts are weighted by the plan's denorm_tiles (the
valid-column mask for stochastic bits).

`packed_call` routes by the plan, as the reference does: a transpose plan
to the transposed kernel, a multi-pass (merged-core) plan to the scheduled
kernel, a single-pass plan to the packed kernel; `scheduled=True` forces
the scheduled kernel onto a single-pass plan. The reference's per-slot
baseline (`fused=False`) is not ported (ROADMAP A10) and raises.
"""
from __future__ import annotations

import torch

from . import kernel as K
from ...core.types import CIMConfig


def cim_mvm(x_int, g_pos, g_neg, v_decr, cfg: CIMConfig, *, seed: int = 0,
            norm=None, block=K.REF_BLOCK, impl: str = "auto"):
    """CIM MVM returning signed ADC counts, shape (B, C) float32.

    x_int: (B, R) integer-valued float or int tensor; g_pos / g_neg: (R, C)
    conductances in uS; v_decr: the ADC step (0-d); norm: the per-column
    normalizer (default: the column sums of G+ + G-). block: the
    reference's (bm, bk, bn), which keys the stochastic neuron's draws.
    impl="plain" forces the plain version (on-card comparison only)."""
    gd = (g_pos - g_neg).to(torch.float32).contiguous()
    if norm is None:
        norm = torch.sum(g_pos + g_neg, dim=0)
    inv_norm = (1.0 / norm.to(torch.float32)).contiguous()
    vd = torch.as_tensor(v_decr, dtype=torch.float32, device=gd.device)
    return K.cim_mvm(x_int.to(torch.float32).contiguous(), gd, inv_norm,
                     vd.reshape(()), activation=cfg.activation,
                     n_max=cfg.out_mag_levels, v_read=cfg.v_read, seed=seed,
                     block=block, impl=impl)


def packed_call(x, packed, *, activation: str, n_max: int, v_read: float,
                seed: int = 0, scheduled=None, fused: bool = True,
                impl: str = "auto"):
    """Single entry point to the packed kernels: validates the plan/input
    fit, launches ONE kernel over every tile, slices the padding off.
    impl="plain" forces the plain version (on-card comparison only)."""
    if x.shape[-1] != packed.n_rows:
        raise ValueError(
            f"input has {x.shape[-1]} features but plan "
            f"'{packed.layer}' covers {packed.n_rows} weight rows")
    if not fused:
        raise NotImplementedError(
            "fused=False (the per-slot partial baseline) is not ported yet "
            "(ROADMAP A10)")
    kernel = packed.route(scheduled)
    x = x.to(torch.float32).contiguous()
    tiles = (packed.gd_tiles, packed.inv_norm_tiles, packed.denorm_tiles,
             packed.v_decr_tiles)
    kw = dict(activation=activation, n_max=n_max, v_read=v_read, seed=seed,
              impl=impl)
    runs = dict(n_run_ranks=packed.n_run_ranks, n_run_len=packed.n_run_len)
    if kernel == "cim_mvm_transposed":
        out = K.cim_mvm_transposed(
            x, *tiles, packed.row_index, packed.tile_index, packed.run_start,
            packed.col_run_start, packed.col_runs, **runs, **kw)
    elif kernel == "cim_mvm_scheduled":
        out = K.cim_mvm_scheduled(
            x, *tiles, packed.row_index, packed.run_start,
            packed.col_run_start, packed.col_runs, packed.live_slots, **runs,
            **kw)
    else:
        out = K.cim_mvm_packed(
            x, *tiles, packed.row_index, packed.col_start,
            n_row_blocks=packed.n_row_blocks, n_ranks=packed.n_ranks, **kw)
    return out[:, :packed.n_cols]


def cim_mvm_packed(x_int, packed, cfg: CIMConfig, *, seed: int = 0,
                   scheduled=None, fused: bool = True, impl: str = "auto"):
    """Packed whole-layer CIM MVM returning the digitally accumulated
    (B, C) float32 output — summed ADC counts when the plan was packed
    with fold_norm=False, de-normalized charge units with fold_norm=True.
    x_int: (B, R) integer-valued activations over the full weight rows."""
    return packed_call(x_int, packed, activation=cfg.activation,
                       n_max=cfg.out_mag_levels, v_read=cfg.v_read,
                       seed=seed, scheduled=scheduled, fused=fused,
                       impl=impl)
