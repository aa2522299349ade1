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
the scheduled kernel onto a single-pass plan. `fused=False` runs the
scheduled and transposed kernels over the reference's per-slot partial
layout (`PackedPlan.run_layout`: each slot its own run, folded in slot
order), the pre-fusion baseline; the same kernels with other tables, bit
for bit the fused result on integer counts. The single-pass packed kernel
ignores the flag, as the reference's does.

bm is the reference's batch block: here it keys only the stochastic
neuron's draws (bm_ref = min(bm, M)); None takes `autotune.lookup`'s
value, 256. The launch route (the split route or the walk, and the walk's
item layout) defaults to the autotuner's cached winner for the plan's
signature (`autotune.lookup_route`; the kernels' rule until
`autotune.tune` has measured the shape) — pass route to pin it
(`kernel.RULE`: the rule, whatever is cached). Unlike a
tuned bm in the reference, a tuned route never changes an output.
"""
from __future__ import annotations

import torch

from . import autotune
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
                seed: int = 0, bm=None, scheduled=None, fused: bool = True,
                route=None, impl: str = "auto"):
    """Single entry point to the packed kernels: validates the plan/input
    fit, launches ONE kernel over every tile, slices the padding off.
    bm: the stochastic neuron's batch block (None: `autotune.lookup`);
    fused=False: the per-slot partial baseline; route: a `kernel.Route`
    (None: `autotune.lookup_route`, else the kernels' rule). impl="plain"
    forces the plain version (on-card comparison only)."""
    if x.shape[-1] != packed.n_rows:
        raise ValueError(
            f"input has {x.shape[-1]} features but plan "
            f"'{packed.layer}' covers {packed.n_rows} weight rows")
    m = x.shape[0]
    if bm is None:
        bm = autotune.lookup(packed, m, activation)
    if route is None:
        route = autotune.lookup_route(packed, m, activation)
    kernel = packed.route(scheduled)
    x = x.to(torch.float32).contiguous()
    tiles = (packed.gd_tiles, packed.inv_norm_tiles, packed.denorm_tiles,
             packed.v_decr_tiles)
    kw = dict(activation=activation, n_max=n_max, v_read=v_read, seed=seed,
              bm=bm, route=route, impl=impl)
    *tables, n_run_ranks, n_run_len = packed.run_layout(fused)
    runs = dict(n_run_ranks=n_run_ranks, n_run_len=n_run_len)
    if kernel == "cim_mvm_transposed":
        out = K.cim_mvm_transposed(
            x, *tiles, packed.row_index, packed.tile_index, *tables, **runs,
            **kw)
    elif kernel == "cim_mvm_scheduled":
        out = K.cim_mvm_scheduled(
            x, *tiles, packed.row_index, *tables, packed.live_slots, **runs,
            **kw)
    else:
        out = K.cim_mvm_packed(
            x, *tiles, packed.row_index, packed.col_start,
            n_row_blocks=packed.n_row_blocks, n_ranks=packed.n_ranks, **kw)
    return out[:, :packed.n_cols]


def cim_mvm_packed(x_int, packed, cfg: CIMConfig, *, seed: int = 0,
                   bm=None, scheduled=None, fused: bool = True, route=None,
                   impl: str = "auto"):
    """Packed whole-layer CIM MVM returning the digitally accumulated
    (B, C) float32 output — summed ADC counts when the plan was packed
    with fold_norm=False, de-normalized charge units with fold_norm=True.
    x_int: (B, R) integer-valued activations over the full weight rows.
    bm / fused / route as `packed_call`."""
    return packed_call(x_int, packed, activation=cfg.activation,
                       n_max=cfg.out_mag_levels, v_read=cfg.v_read,
                       seed=seed, bm=bm, scheduled=scheduled, fused=fused,
                       route=route, impl=impl)
