"""Public entry points of the packed CIM MVM (PyTorch port of
`repro/kernels/cim_mvm/ops.py`).

`cim_mvm_packed` executes a whole layer's TNSA tile plan
(core/mapping.PackedPlan) in one kernel launch — the serving path behind
core.cim.packed_forward. Row-split partial sums accumulate inside the
kernel; per-tile counts are weighted by the plan's denorm_tiles.

Only single-pass forward plans are ported: a plan whose schedule has more
than one pass (merged cores) needs the scheduled kernel (ROADMAP B2), a
transpose-direction plan the transposed kernel (ROADMAP B4); both raise.
"""
from __future__ import annotations

import torch

from .kernel import cim_mvm_packed as _cim_mvm_packed_kernel
from ...core.types import CIMConfig


def packed_call(x, packed, *, activation: str, n_max: int, v_read: float,
                impl: str = "auto"):
    """Single entry point to the packed kernel: validates the plan/input
    fit, launches ONE kernel over every tile, slices the padding off.
    impl="plain" forces the plain version (on-card comparison only)."""
    if x.shape[-1] != packed.n_rows:
        raise ValueError(
            f"input has {x.shape[-1]} features but plan "
            f"'{packed.layer}' covers {packed.n_rows} weight rows")
    if packed.transpose:
        raise NotImplementedError(
            f"plan '{packed.layer}' is a transpose-direction plan; its "
            "kernel is not ported yet (ROADMAP B4)")
    if packed.n_passes > 1:
        raise NotImplementedError(
            f"plan '{packed.layer}' has {packed.n_passes} sequential passes; "
            "the scheduled kernel is not ported yet (ROADMAP B2)")
    out = _cim_mvm_packed_kernel(
        x.to(torch.float32).contiguous(), packed.gd_tiles,
        packed.inv_norm_tiles, packed.denorm_tiles, packed.v_decr_tiles,
        packed.row_index, packed.col_start,
        n_row_blocks=packed.n_row_blocks, n_ranks=packed.n_ranks,
        activation=activation, n_max=n_max, v_read=v_read, impl=impl)
    return out[:, :packed.n_cols]


def cim_mvm_packed(x_int, packed, cfg: CIMConfig, *, impl: str = "auto"):
    """Packed whole-layer CIM MVM returning the digitally accumulated
    (B, C) float32 output — summed ADC counts when the plan was packed
    with fold_norm=False, de-normalized charge units with fold_norm=True.
    x_int: (B, R) integer-valued activations over the full weight rows."""
    return packed_call(x_int, packed, activation=cfg.activation,
                       n_max=cfg.out_mag_levels, v_read=cfg.v_read,
                       impl=impl)
