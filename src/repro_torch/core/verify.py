"""Chip-IR verifier: static passes over every chip-compiler artifact
(PyTorch port of `repro/core/verify.py`).

Every violation raises a structured `ChipVerifyError` naming the pipeline
stage, layer, tile/slot and invariant, before anything launches.

  schedule  permutation            non-idle slots cover the tiles once
            pass-shape             order length == n_passes * pass_len
            core-double-booking    no core fires twice within one pass
  program   exact-dot              a per-matrix CIMLayer (the single-
                                   matrix kernel's operand): every
                                   conductance >= 1 uS, so G+ - G- lies on
                                   the 2^-23 grid, and K rows of inputs up
                                   to 127 keep the FP64 dot exact
            shared-memory          one block of the single-matrix kernel
                                   fits Hopper's shared memory
  plan      core-bounds            every tile sits on a real core
            tile-extent            tiles fit the physical core array
            ir-drop-cols           columns per core respect
                                   `mapping.ir_drop_max_cols`
  pack      geometry / stack-shape index maps and stacked tensor trailing
                                   dims agree with the plan
            tile-slot-permutation  the launch reaches every stack entry once
            index-bounds           row/col/out index maps in range;
                                   seq_slot is pass-major
            block-coverage         non-idle slots cover the layer's output
                                   block grid exactly once
            fused-runs / run-block the fused run layout is consecutive,
                                   maximal and agrees with col_block
            col-offsets            col_start (the packed kernel's CSR
                                   offsets of each column block's slots)
                                   matches col_block (None on transpose
                                   plans); row_index / tile_index match
                                   row_block / tile_slot
            run-offsets            run_start, col_run_start and col_runs
                                   (the run tables of the scheduled and
                                   transposed kernels) and live_slots (the
                                   split route's term blocks) match
                                   out_slot / out_col
            route                  a pinned route the plan's kernel
                                   cannot take at the batch
            shared-memory          one CUDA block of each route the plan
                                   launches (or of a pinned route) — the
                                   walk at the tiling it picks for the
                                   batch (transposed: the
                                   walk over the stored tile's column
                                   axis, its only route), and for a
                                   forward plan the split route of a
                                   decode batch (<= 16 rows) — fits
                                   Hopper's 232,448 bytes of shared
                                   memory; the split route's term pass
                                   has one thread per tile column, at
                                   most 256
            bulk-copy              a forward plan's chunk bytes (16 tile
                                   rows) are a multiple of 16, so every
                                   chunk of a tile sits at the tile's
                                   offset mod 16 and the split route's
                                   bulk copy (cp.async.bulk: 16-byte
                                   multiples) of its aligned cover lands
                                   at one fixed shift
            exact-dot              gd_tiles lie on the 2^-23 grid and are
                                   small enough that the kernel's FP64
                                   tile dot (of the route's length, bk) is
                                   exact for |x| <= 127
  deploy    stack-geometry         every chip of a deployed stack (a
                                   layer list, or a layer x expert list of
                                   lists) shares one static plan geometry
                                   and tensor shapes, as the reference's
                                   stacked pytrees must
  chip      schedule-pack          the packed pass structure matches the
                                   stage-2 schedule
            shared-stack           a transpose pack reuses the forward
                                   pack's gd_tiles tensor
            direction-agreement    the transpose pack is the forward
            / direction-keys       pack's swap (geometry, block maps via
                                   tile_slot, pass structure, names)

The reference's `vmem-budget` (16 MiB of TPU VMEM per grid step) has no
meaning on the card; `shared-memory` takes its place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from .mapping import (PackedPlan, Plan, Tile, TileSchedule,
                      col_block_offsets, ir_drop_max_cols, live_slots,
                      run_tables)
from .types import CIMConfig, CoreSpec
from ..kernels.cim_mvm.kernel import (SMEM_LIMIT, SPLIT_CHUNK_ROWS,
                                      SPLIT_KERNELS, SPLIT_ROWS,
                                      SPLIT_THREADS, H100_SMS,
                                      mvm_geometry, mvm_shared_bytes,
                                      one_block, split_route, split_rows,
                                      split_shared_bytes, walk_geometry,
                                      walk_shared_bytes)

# the largest batch block the serving path launches (prefill of 4 x 64)
_DEFAULT_BM = 256
# The reference's per-grid-step VMEM budget has no meaning on the card: the
# name stands for the limit that takes its place, the shared memory one
# Hopper block can use (`kernel.SMEM_LIMIT`, bytes), which the
# `shared-memory` invariant checks.
DEFAULT_VMEM_BUDGET = SMEM_LIMIT
_GD_GRID_INV = 2.0 ** 23     # gd elements are integer multiples of 2^-23
_IN_MAX_LIMIT = 127          # the largest |x| any CIMConfig allows (8 bits)


class ChipVerifyError(ValueError):
    """A chip-compiler artifact violated a static invariant: `stage`,
    `invariant`, `layer` and `tile`/slot are kept as attributes and
    embedded in the message."""

    def __init__(self, stage: str, invariant: str, message: str, *,
                 layer: Optional[str] = None, tile: Optional[int] = None):
        self.stage = stage
        self.invariant = invariant
        self.layer = layer
        self.tile = tile
        where = f" layer={layer!r}" if layer is not None else ""
        where += f" tile={tile}" if tile is not None else ""
        super().__init__(
            f"[stage:{stage}]{where} invariant={invariant}: {message}")


# ------------------------------------------------------- stage 2: schedule

def check_schedule(tiles: Sequence[Tile], schedule: TileSchedule, *,
                   layer: Optional[str] = None) -> None:
    """Verify a stage-2 TileSchedule against its tile sequence."""
    tiles = [t for t in tiles if t.replica == 0]
    if len(schedule.order) != schedule.n_passes * schedule.pass_len:
        raise ChipVerifyError(
            "schedule", "pass-shape",
            f"order has {len(schedule.order)} slots but n_passes="
            f"{schedule.n_passes} * pass_len={schedule.pass_len} = "
            f"{schedule.n_passes * schedule.pass_len}", layer=layer)
    covered = sorted(i for i in schedule.order if i is not None)
    if covered != list(range(len(tiles))):
        dup = sorted({i for i in covered if covered.count(i) > 1})
        miss = sorted(set(range(len(tiles))) - set(covered))
        raise ChipVerifyError(
            "schedule", "permutation",
            f"non-idle slots must cover the {len(tiles)}-tile sequence "
            f"exactly once (duplicated: {dup}, missing: {miss}, "
            f"out-of-range: {sorted(set(covered) - set(range(len(tiles))))})",
            layer=layer)
    for p in range(schedule.n_passes):
        seen = {}
        for s in range(p * schedule.pass_len, (p + 1) * schedule.pass_len):
            i = schedule.order[s]
            if i is None:
                continue
            core = tiles[i].core
            if core in seen:
                raise ChipVerifyError(
                    "schedule", "core-double-booking",
                    f"core {core} fires twice in pass {p} (tiles "
                    f"{seen[core]} and {i})", layer=layer, tile=i)
            seen[core] = i


# ------------------------------------------- stage 3: per-matrix program

_EXACT_G_MIN = 1.0       # uS: every f32 >= 1 is a multiple of 2^-23


def check_layer(g_pos, g_neg, *, bm: Optional[int] = None,
                layer: Optional[str] = None) -> None:
    """Verify one programmed matrix (a per-matrix CIMLayer's G+ and G-,
    (K, N) uS) for the single-matrix kernel `cim_mvm`.

    exact-dot: the kernel sums x @ (G+ - G-) in FP64 and rounds once, which
    equals its plain version bit for bit only when the sum is exact. Every
    f32 of magnitude >= 1 is a multiple of 2^-23, so with every conductance
    >= 1 uS (relaxation and write-verify clip to g_min) G+ - G-, rounded to
    f32, is one too; K rows of integer inputs up to 127 then stay below
    2^53 grid steps while K * 127 * max|G+ - G-| < 2^30.

    shared-memory: the kernel's tiling of bm rows (default 256) of this
    (K, N) matrix (`mvm_geometry`) fits a Hopper block's shared memory."""
    g_lo = min(float(g_pos.min()), float(g_neg.min())) if g_pos.numel() \
        else _EXACT_G_MIN
    if g_lo < _EXACT_G_MIN:
        raise ChipVerifyError(
            "program", "exact-dot",
            f"a conductance of {g_lo} uS lies below {_EXACT_G_MIN} uS: G+ - "
            "G- may fall off the 2^-23 grid and the kernel's FP64 dot "
            "could round", layer=layer)
    k = int(g_pos.shape[0])
    gd_max = float((g_pos - g_neg).abs().max()) if g_pos.numel() else 0.0
    if k * _IN_MAX_LIMIT * gd_max >= 2.0 ** 30:
        raise ChipVerifyError(
            "program", "exact-dot",
            f"|G+ - G-| reaches {gd_max}: a {k}-row dot of inputs up to "
            f"{_IN_MAX_LIMIT} could reach 2^30 and round in FP64",
            layer=layer)
    rows = _DEFAULT_BM if bm is None else max(int(bm), 1)
    n = int(g_pos.shape[1])
    if k and n:
        # a tiling that fits: which of them the card runs fastest is the
        # launch's question, not the verifier's
        geo = mvm_geometry(rows, k, n, occupancy=one_block, n_sm=H100_SMS)
        need = mvm_shared_bytes(geo, k)
        if need > SMEM_LIMIT:
            raise ChipVerifyError(
                "program", "shared-memory",
                f"one CUDA block of cim_mvm needs {need} bytes of shared "
                f"memory at {rows} rows of a ({k}, {n}) matrix (geometry "
                f"{geo.as_dict()}) but a Hopper block has {SMEM_LIMIT}",
                layer=layer)


# ----------------------------------------------------------- stage 1: plan

def check_plan(plan: Plan, cfg: CIMConfig, spec: CoreSpec, *,
               droop_tol: float = 0.05) -> None:
    """Verify a stage-1 Plan against the physical core array and the
    IR-drop planning constraint."""
    max_cols = ir_drop_max_cols(cfg, spec, droop_tol)
    row_cap = spec.rows // 2
    for i, t in enumerate(plan.tiles):
        if not 0 <= t.core < spec.n_cores:
            raise ChipVerifyError(
                "plan", "core-bounds",
                f"tile on core {t.core} outside the chip's "
                f"{spec.n_cores} cores", layer=t.layer, tile=i)
        if t.rows > row_cap or t.cols > spec.cols:
            raise ChipVerifyError(
                "plan", "tile-extent",
                f"tile is {t.rows}x{t.cols} weight cells but a core holds "
                f"at most {row_cap}x{spec.cols}", layer=t.layer, tile=i)
        if max_cols is not None and t.cols > max_cols:
            raise ChipVerifyError(
                "plan", "ir-drop-cols",
                f"tile spans {t.cols} columns but ir_drop_alpha="
                f"{cfg.nonideal.ir_drop_alpha} bounds a core to "
                f"{max_cols}", layer=t.layer, tile=i)


# ----------------------------------------------------------- stage 5: pack

def _trailing(shape, n):
    return tuple(int(d) for d in shape[-n:])


def _ints(t):
    return None if t is None else [int(v) for v in t.tolist()]


def check_packed(packed: PackedPlan, *, bm: Optional[int] = None,
                 route=None, layer: Optional[str] = None) -> None:
    """Verify a stage-5 PackedPlan's static index maps, tensor shapes,
    kernel tables and its kernel's shared memory.

    bm: batch rows the shared-memory check assumes; None takes the
    largest batch block the serving path launches. route: a pinned launch
    route (`kernel.Route`, what the autotuner sweeps): the shared-memory
    check then takes that route at bm rows instead of the rule's routes.
    """
    name = layer if layer is not None else packed.layer
    T = packed.n_tiles

    for field in ("col_block", "seq_slot", "tile_slot", "out_slot"):
        if len(getattr(packed, field)) != T:
            raise ChipVerifyError(
                "pack", "geometry",
                f"{field} has {len(getattr(packed, field))} entries for "
                f"{T} slots", layer=name)
    if packed.n_passes < 1 or T % packed.n_passes:
        raise ChipVerifyError(
            "pack", "geometry",
            f"{T} slots do not divide into {packed.n_passes} passes",
            layer=name)
    if packed.bk < 1 or packed.bn < 1 or packed.n_rows < 1 \
            or packed.n_cols < 1:
        raise ChipVerifyError(
            "pack", "geometry",
            f"degenerate block geometry bk={packed.bk} bn={packed.bn} "
            f"n_rows={packed.n_rows} n_cols={packed.n_cols}", layer=name)

    gd_shape = ((T, packed.bn, packed.bk) if packed.transpose
                else (T, packed.bk, packed.bn))
    if _trailing(packed.gd_tiles.shape, 3) != gd_shape:
        raise ChipVerifyError(
            "pack", "stack-shape",
            f"gd_tiles trailing dims {_trailing(packed.gd_tiles.shape, 3)} "
            f"!= {gd_shape}"
            + (" (transpose plans index the forward-orientation stack)"
               if packed.transpose else ""), layer=name)
    for fname, arr in (("inv_norm_tiles", packed.inv_norm_tiles),
                       ("denorm_tiles", packed.denorm_tiles)):
        if _trailing(arr.shape, 3) != (T, 1, packed.bn):
            raise ChipVerifyError(
                "pack", "stack-shape",
                f"{fname} trailing dims {_trailing(arr.shape, 3)} != "
                f"{(T, 1, packed.bn)}", layer=name)
    for fname, arr in (("v_decr_tiles", packed.v_decr_tiles),
                       ("row_index", packed.row_index)):
        if _trailing(arr.shape, 1) != (T,):
            raise ChipVerifyError(
                "pack", "stack-shape",
                f"{fname} trailing dim {_trailing(arr.shape, 1)} != {(T,)}",
                layer=name)

    if sorted(packed.tile_slot) != list(range(T)):
        raise ChipVerifyError(
            "pack", "tile-slot-permutation",
            f"tile_slot is not a permutation of range({T}) — some stack "
            "entries would be launched twice and others never", layer=name)

    n_rb = max(1, math.ceil(packed.n_rows / packed.bk))
    n_cb = max(1, math.ceil(packed.n_cols / packed.bn))
    pass_len = packed.pass_len
    n_runs = len(packed.out_col)
    for i in range(T):
        if not 0 <= packed.row_block[i] < n_rb:
            raise ChipVerifyError(
                "pack", "index-bounds",
                f"row_block[{i}]={packed.row_block[i]} outside the "
                f"{n_rb} input blocks of n_rows={packed.n_rows} at "
                f"bk={packed.bk}", layer=name, tile=i)
        if not 0 <= packed.col_block[i] < n_cb:
            raise ChipVerifyError(
                "pack", "index-bounds",
                f"col_block[{i}]={packed.col_block[i]} outside the "
                f"{n_cb} output blocks of n_cols={packed.n_cols} at "
                f"bn={packed.bn}", layer=name, tile=i)
        if packed.seq_slot[i] != i // pass_len:
            raise ChipVerifyError(
                "pack", "index-bounds",
                f"seq_slot[{i}]={packed.seq_slot[i]} breaks the "
                f"pass-major layout (expected {i // pass_len})",
                layer=name, tile=i)
        if not 0 <= packed.out_slot[i] < n_runs:
            raise ChipVerifyError(
                "pack", "index-bounds",
                f"out_slot[{i}]={packed.out_slot[i]} outside the "
                f"{n_runs} runs of out_col", layer=name, tile=i)
    for r, blk in enumerate(packed.out_col):
        if not -1 <= blk < n_cb:
            raise ChipVerifyError(
                "pack", "index-bounds",
                f"out_col[{r}]={blk} outside the {n_cb} output blocks "
                "(-1 marks an all-idle run)", layer=name)

    if T:
        if packed.out_slot[0] != 0:
            raise ChipVerifyError(
                "pack", "fused-runs",
                f"out_slot starts at {packed.out_slot[0]}, not run 0",
                layer=name, tile=0)
        for i in range(1, T):
            if packed.out_slot[i] - packed.out_slot[i - 1] not in (0, 1):
                raise ChipVerifyError(
                    "pack", "fused-runs",
                    f"out_slot[{i - 1}..{i}] = ({packed.out_slot[i - 1]}, "
                    f"{packed.out_slot[i]}): runs must be maximal stretches "
                    "of consecutive slots", layer=name, tile=i)
        if packed.out_slot[-1] != n_runs - 1:
            raise ChipVerifyError(
                "pack", "fused-runs",
                f"out_slot ends at run {packed.out_slot[-1]} but out_col "
                f"declares {n_runs} runs", layer=name, tile=T - 1)
        for r in range(1, n_runs):
            if packed.out_col[r] == packed.out_col[r - 1]:
                raise ChipVerifyError(
                    "pack", "fused-runs",
                    f"adjacent runs {r - 1} and {r} share output block "
                    f"{packed.out_col[r]}", layer=name)

    seen = {}
    for i in range(T):
        run_blk = packed.out_col[packed.out_slot[i]]
        if run_blk == -1:
            continue                        # idle slot (pass padding)
        if run_blk != packed.col_block[i]:
            raise ChipVerifyError(
                "pack", "run-block",
                f"slot {i} sits in run {packed.out_slot[i]} of output "
                f"block {run_blk} but its col_block is "
                f"{packed.col_block[i]}", layer=name, tile=i)
        blk = (packed.row_block[i], packed.col_block[i])
        if blk in seen:
            raise ChipVerifyError(
                "pack", "block-coverage",
                f"output block {blk} packed twice (slots {seen[blk]} and "
                f"{i}) — its partial sum would be double-counted",
                layer=name, tile=i)
        seen[blk] = i
    missing = [(r, c) for r in range(n_rb) for c in range(n_cb)
               if (r, c) not in seen]
    if missing:
        raise ChipVerifyError(
            "pack", "block-coverage",
            f"no slot covers output block(s) {missing} of the "
            f"{n_rb}x{n_cb} block grid — those outputs would be "
            "silently zero", layer=name)

    # the kernel's CSR offsets: column block j owns [col_start[j],
    # col_start[j+1]); a stale or corrupt table would skip or repeat tiles
    want = None if packed.transpose else col_block_offsets(packed.col_block)
    have = _ints(packed.col_start)
    if have != want:
        raise ChipVerifyError(
            "pack", "col-offsets",
            f"col_start {have} disagrees with col_block (expected {want})",
            layer=name)
    if _ints(packed.row_index) != list(packed.row_block):
        raise ChipVerifyError(
            "pack", "col-offsets",
            "row_index disagrees with row_block", layer=name)
    want_slots = list(packed.tile_slot) if packed.transpose else None
    if _ints(packed.tile_index) != want_slots:
        raise ChipVerifyError(
            "pack", "col-offsets",
            f"tile_index disagrees with tile_slot (expected {want_slots})",
            layer=name)

    # the run tables the scheduled and transposed kernels walk: a stale
    # table would skip, repeat or misorder runs
    for tname, want_t in zip(("run_start", "col_run_start", "col_runs"),
                             run_tables(packed.out_slot, packed.out_col,
                                        packed.n_col_blocks)):
        if _ints(getattr(packed, tname)) != want_t:
            raise ChipVerifyError(
                "pack", "run-offsets",
                f"{tname} disagrees with out_slot / out_col (expected "
                f"{want_t})", layer=name)
    want_live = live_slots(packed.out_slot, packed.out_col)
    if _ints(packed.live_slots) != want_live:
        raise ChipVerifyError(
            "pack", "run-offsets",
            f"live_slots disagrees with out_slot / out_col (expected "
            f"{want_live})", layer=name)

    # every route the plan launches: the batch's (the walk, or the split
    # route up to its edge) and, for a forward plan, the split route of a
    # decode batch. The transposed kernel's only route is the walk, over
    # the stored tile's column axis: it contracts packed.bk stored columns
    # into packed.bn outputs.
    kernel = packed.route()
    split = kernel in SPLIT_KERNELS
    rows = _DEFAULT_BM if bm is None else max(int(bm), 1)
    if route is None or route.kind == "rule":
        batches = {rows, SPLIT_ROWS[-1]} if split else {rows}
        launches = [(m, split and split_route(m), None)
                    for m in sorted(batches)]
    else:
        if route.kind == "split" and (not split or not split_route(rows)):
            raise ChipVerifyError(
                "pack", "route",
                f"{kernel} has no split route at {rows} rows", layer=name)
        launches = [(rows, route.kind == "split", route.layout)]
    for m, on_split, layout in launches:
        if on_split:
            what, bm_eff = "split route", split_rows(m)
            need = split_shared_bytes(bm_eff, packed.bk, packed.bn)
        else:
            what = "walk"
            geo = walk_geometry(m, packed.bk, packed.bn,
                                packed.n_col_blocks, trans=packed.transpose,
                                layout=layout)
            bm_eff, need = geo.bm, walk_shared_bytes(geo)
        if need > SMEM_LIMIT:
            raise ChipVerifyError(
                "pack", "shared-memory",
                f"one CUDA block of {kernel} ({what}) needs {need} bytes of "
                f"shared memory at {bm_eff} rows but a Hopper block has "
                f"{SMEM_LIMIT}", layer=name)
    if split and packed.bn > SPLIT_THREADS:
        raise ChipVerifyError(
            "pack", "shared-memory",
            f"the split route of {kernel} runs one thread per tile column, "
            f"at most {SPLIT_THREADS}; the plan has bn={packed.bn}",
            layer=name)
    chunk = SPLIT_CHUNK_ROWS * packed.bn * 4
    if split and chunk % 16:
        raise ChipVerifyError(
            "pack", "bulk-copy",
            f"chunk bytes {chunk} ({SPLIT_CHUNK_ROWS} rows of bn="
            f"{packed.bn}) are not a multiple of 16: the split route's "
            "chunks of one tile would sit at different offsets mod 16",
            layer=name)

    # The kernel sums each tile's dot in FP64 and rounds once, which is
    # exact — and so equal to the plain version bit for bit — only when
    # every gd element is a multiple of 2^-23 (G+ - G- of conductances
    # >= 1 uS, as `ideal` programs them) and no partial sum can reach
    # 2^30 = 2^53 grid steps for any input a CIMConfig allows.
    gd = packed.gd_tiles
    scaled = gd * _GD_GRID_INV
    off_grid = int((scaled != torch.round(scaled)).sum())
    if off_grid:
        raise ChipVerifyError(
            "pack", "exact-dot",
            f"{off_grid} gd_tiles elements are not multiples of 2^-23: the "
            "kernel's FP64 tile dot would round, and its counts could "
            "differ from the plain version's at .5 boundaries", layer=name)
    g_max = float(gd.abs().max()) if gd.numel() else 0.0
    # bk is the dot length of either route: a transpose plan's bk is the
    # stored tile's column count
    if packed.bk * _IN_MAX_LIMIT * g_max >= 2.0 ** 30:
        raise ChipVerifyError(
            "pack", "exact-dot",
            f"|gd| reaches {g_max}: a {packed.bk}-row tile dot of inputs "
            f"up to {_IN_MAX_LIMIT} could reach 2^30 and round in FP64",
            layer=name)


# --------------------------------------------------- chip-level invariants

def check_directions(name: str, fwd: PackedPlan, bwd: PackedPlan) -> None:
    """Verify a transpose-direction pack against its forward pack: shared
    conductance stack by identity, swapped geometry, slot-for-slot
    agreement through the cross-direction tile_slot permutation."""
    if bwd.gd_tiles is not fwd.gd_tiles:
        raise ChipVerifyError(
            "chip", "shared-stack",
            "transpose pack carries its own gd_tiles stack instead of "
            "referencing the forward stack: one programmed conductance set "
            "must serve both directions", layer=name)
    if not bwd.transpose or fwd.transpose:
        raise ChipVerifyError(
            "chip", "direction-agreement",
            f"direction flags wrong (fwd.transpose={fwd.transpose}, "
            f"bwd.transpose={bwd.transpose})", layer=name)
    if (bwd.bk, bwd.bn) != (fwd.bn, fwd.bk) \
            or (bwd.n_rows, bwd.n_cols) != (fwd.n_cols, fwd.n_rows):
        raise ChipVerifyError(
            "chip", "direction-agreement",
            f"transpose geometry not the forward swap: bwd "
            f"{(bwd.bk, bwd.bn, bwd.n_rows, bwd.n_cols)} vs fwd "
            f"{(fwd.bk, fwd.bn, fwd.n_rows, fwd.n_cols)}", layer=name)
    if bwd.n_passes != fwd.n_passes or bwd.seq_slot != fwd.seq_slot:
        raise ChipVerifyError(
            "chip", "direction-agreement",
            "transpose pack's pass structure diverges from the forward "
            f"pack ({bwd.n_passes} vs {fwd.n_passes} passes)", layer=name)
    want_row = tuple(fwd.col_block[g] for g in bwd.tile_slot)
    want_col = tuple(fwd.row_block[g] for g in bwd.tile_slot)
    if bwd.row_block != want_row or bwd.col_block != want_col:
        raise ChipVerifyError(
            "chip", "direction-agreement",
            "transpose block maps are not the forward maps gathered "
            "through tile_slot (slot-for-slot agreement broken)", layer=name)


def verify_chip(chip):
    """Run every verifier pass over a CompiledChip; returns the chip,
    raises ChipVerifyError on the first violated invariant."""
    check_plan(chip.plan, chip.cfg, chip.spec)
    for name, sched in chip.schedules.items():
        check_schedule(chip.plan.tiles_for(name), sched, layer=name)
    for name, pcl in chip.layers.items():
        check_packed(pcl.packed, layer=name)
        sched = chip.schedules.get(name)
        if sched is not None and (
                pcl.packed.n_passes != sched.n_passes
                or pcl.packed.n_tiles != sched.n_passes * sched.pass_len):
            raise ChipVerifyError(
                "chip", "schedule-pack",
                f"packed pass structure ({pcl.packed.n_passes} passes x "
                f"{pcl.packed.pass_len}) disagrees with the stage-2 "
                f"schedule ({sched.n_passes} x {sched.pass_len})",
                layer=name)
    if chip.bwd_layers:
        if set(chip.bwd_layers) != set(chip.layers):
            raise ChipVerifyError(
                "chip", "direction-keys",
                f"bwd layer names {sorted(chip.bwd_layers)} != fwd names "
                f"{sorted(chip.layers)}")
        for name, pcl in chip.bwd_layers.items():
            check_packed(pcl.packed, layer=name)
            check_directions(name, chip.layers[name].packed, pcl.packed)
    return chip


_STACK_FIELDS = ("bk", "bn", "n_rows", "n_cols", "row_block", "col_block",
                 "seq_slot", "n_passes", "transpose", "tile_slot", "out_slot",
                 "out_col")
_STACK_TENSORS = ("gd_tiles", "inv_norm_tiles", "v_decr_tiles",
                  "denorm_tiles")


def _is_sharded(x) -> bool:
    """A models/nn.ShardedPackedLayer (duck-typed: nn imports this
    module)."""
    return hasattr(x, "shards") and hasattr(x, "partition")


def _stack_members(node, kind):
    """The `kind` leaves of a (nested) list of them, or of
    ShardedPackedLayers holding them, else None."""
    out = []
    for x in node:
        if isinstance(x, list):
            sub = _stack_members(x, kind)
            if sub is None:
                return None
            out += sub
        elif _is_sharded(x):
            check_sharded(x)
            sub = _stack_members(x.shards, kind)
            if sub is None:
                return None
            out += sub
        elif isinstance(x, kind):
            out.append(x)
        else:
            return None
    return out


def check_sharded(spl, *, layer: Optional[str] = None) -> None:
    """A ShardedPackedLayer holds one chip per shard and a known
    partition; its shards stack (`check_stack`)."""
    if spl.partition not in ("col", "row", "none") \
            or len(spl.shards) != spl.n_shards or spl.n_shards < 1:
        raise ChipVerifyError(
            "deploy", "shard-stack",
            f"{len(spl.shards)} shard chips for n_shards {spl.n_shards}, "
            f"partition {spl.partition!r}", layer=layer)


def check_stack(plans: Sequence[PackedPlan], *,
                layer: Optional[str] = None) -> None:
    """A deployed stack's chips share the first one's static geometry and
    tensor shapes (the reference stacks them into one pytree, which
    requires it; the port's launches rely on it per layer and expert)."""
    first = plans[0]
    name = layer if layer is not None else first.layer
    for i, p in enumerate(plans[1:], 1):
        for f in _STACK_FIELDS:
            if getattr(p, f) != getattr(first, f):
                raise ChipVerifyError(
                    "deploy", "stack-geometry",
                    f"chip {i} of the stack has {f} {getattr(p, f)!r}, chip "
                    f"0 {getattr(first, f)!r}", layer=name)
        for f in _STACK_TENSORS:
            if getattr(p, f).shape != getattr(first, f).shape:
                raise ChipVerifyError(
                    "deploy", "stack-geometry",
                    f"chip {i} of the stack has {f} of shape "
                    f"{tuple(getattr(p, f).shape)}, chip 0 "
                    f"{tuple(getattr(first, f).shape)}", layer=name)


def verify_deployed(tree):
    """Verify every chip artifact reachable in a deployed tree (dicts,
    lists, tuples and dataclasses, as the port's deploys build them):
    CompiledChips get `verify_chip`, PackedPlans `check_packed`, and a
    list (or list of lists: layer x expert) of PackedCIMLayers, or of
    ShardedPackedLayers (layer x shard), `check_stack` over all its
    chips — every layer and shard of a tensor-parallel stack shares one
    plan; a list of ShardedPackedLayers also one partition and width.
    A bare ShardedPackedLayer (zamba2's shared block) gets
    `check_sharded` and its shards `check_stack`. Returns the tree."""
    from .cim import CompiledChip, PackedCIMLayer   # cim imports this module
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, PackedPlan):
            check_packed(node)
        elif isinstance(node, CompiledChip):
            verify_chip(node)
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, list) and node and \
                (members := _stack_members(node, PackedCIMLayer)):
            kinds = {(x.partition, x.n_shards) for x in node
                     if _is_sharded(x)}
            if len(kinds) > 1:
                raise ChipVerifyError(
                    "deploy", "shard-stack",
                    f"the layers of one stack are sharded differently: "
                    f"{sorted(kinds)}", layer=members[0].packed.layer)
            check_stack([m.packed for m in members])
            stack.extend(members)
        elif _is_sharded(node):
            check_sharded(node)
            stack.append(node.shards)
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            stack.extend(getattr(node, f.name)
                         for f in dataclasses.fields(node))
    return tree
