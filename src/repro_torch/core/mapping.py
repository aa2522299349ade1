"""TNSA multi-core weight mapping — the PLAN, SCHEDULE and PACK stages of
the chip-compiler pipeline (PyTorch port of `repro/core/mapping.py`;
paper Fig. 2a + Methods 'Weight mapping strategy onto multiple CIM cores').

  * `plan_layers` (PLAN): matrices larger than a core are SPLIT into
    <=128x256 weight tiles (differential rows halve a 256-row core); hot
    matrices are DUPLICATED across spare cores; small matrices are MERGED
    diagonally or horizontally (`seq_slot` > 0) when the chip runs out of
    cores; `ir_drop_max_cols` bounds tile width under IR drop.
  * `schedule_tiles` (SCHEDULE): same-core `seq_slot` tiles serialize into
    ordered passes; a plan with one pass fires every core at once.
  * `pack_tiles` (PACK): one layer's tiles as stacked tensors
    (`gd_tiles (T, bk, bn)`, `inv_norm_tiles (T, 1, bn)`, `v_decr_tiles
    (T,)`, `denorm_tiles (T, 1, bn)`) plus static index maps, executed as
    ONE kernel launch (`kernels/cim_mvm`). Each pass's slots are re-sorted
    stably by output column block (`_fused_layout`): a RUN is a stretch of
    consecutive slots of one column block. A single-pass pack's column
    blocks are one run each, so `col_start` holds them as CSR offsets; a
    multi-pass pack may split a column block over several runs, which
    `run_start` / `col_run_start` / `col_runs` describe. All of these live
    on the plan's device next to `row_index`, for the kernels to read.
  * `pack_tiles_transposed` (PACK, BL->SL direction): the transpose view
    of a forward pack for bidirectional workloads (the RBM, paper Fig.
    4e-g). It shares the forward `gd_tiles` stack by reference and builds
    only the per-row normalizer, ADC steps and denorms, in its own fused
    slot order; `tile_slot` maps each slot to its stack position.
  * `multicore_mvm_packed`: a packed plan in one launch — the CIM datapath
    under a CIMConfig, or with cfg None the exact tiled matmul (the
    kernel's identity epilogue). `multicore_mvm` is the readable per-tile
    loop in plain PyTorch, kept as the reference keeps it.

The planner and scheduler work on Python metadata. The pack is batched
tensor code: a (R, C) matrix viewed as (row_block, bk, col_block, bn)
blocks holds every tile, so the stacked tensors are one gather instead of
a Python loop over thousands of tiles, with the same values as the
reference's per-tile loop.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .types import CIMConfig, CoreSpec


@dataclasses.dataclass
class Tile:
    layer: str
    row0: int          # offset in the layer's weight-row space
    col0: int
    rows: int
    cols: int
    core: int = -1     # assigned physical core
    replica: int = 0   # >0 for duplicated tiles
    seq_slot: int = 0  # >0 => shares a core with other tiles, accessed serially


@dataclasses.dataclass
class MatrixReq:
    name: str
    rows: int               # weight rows (pre-differential)
    cols: int
    intensity: float = 1.0  # compute per weight (MACs/weight) — duplication prio


@dataclasses.dataclass(eq=False)
class Plan:
    tiles: List[Tile]
    n_cores_used: int
    duplicated: Dict[str, int]
    merged: List[Tuple[str, ...]]

    def tiles_for(self, name: str) -> List[Tile]:
        return [t for t in self.tiles if t.layer == name and t.replica == 0]


def ir_drop_max_cols(cfg: CIMConfig, spec: CoreSpec = CoreSpec(),
                     droop_tol: float = 0.05) -> Optional[int]:
    """IR-drop planning constraint: cap the columns per core so the
    worst-case driver droop alpha * R * C * (g_max + g_min) stays under
    `droop_tol`. None when IR drop is off."""
    alpha = cfg.nonideal.ir_drop_alpha
    if alpha <= 0:
        return None
    rows = spec.rows // 2                          # differential weight rows
    g_pair = cfg.device.g_max + cfg.device.g_min   # worst-case G+ + G- /cell
    return max(1, min(spec.cols, int(droop_tol / (alpha * rows * g_pair))))


def plan_layers(reqs: Sequence[MatrixReq], spec: CoreSpec = CoreSpec(),
                differential_rows: bool = True,
                max_cols_per_core: Optional[int] = None) -> Plan:
    """Stage 1 (PLAN): greedy reproduction of the paper's allocation policy
    (split, then merge when over budget, else duplicate hot matrices)."""
    row_cap = spec.rows // 2 if differential_rows else spec.rows
    col_cap = spec.cols
    if max_cols_per_core is not None:
        col_cap = max(1, min(col_cap, max_cols_per_core))

    # 1) split every matrix into tiles
    all_tiles: List[Tile] = []
    for r in reqs:
        for i in range(math.ceil(r.rows / row_cap)):
            for j in range(math.ceil(r.cols / col_cap)):
                all_tiles.append(Tile(
                    layer=r.name, row0=i * row_cap, col0=j * col_cap,
                    rows=min(row_cap, r.rows - i * row_cap),
                    cols=min(col_cap, r.cols - j * col_cap)))
    n = len(all_tiles)
    merged: List[Tuple[str, ...]] = []

    if n > spec.n_cores:
        # merge low-intensity, narrow tiles: diagonal merge (parallel) when
        # both extents fit a core, horizontal merge (sequential) otherwise
        inten = {r.name: r.intensity for r in reqs}
        order = sorted(range(n), key=lambda i: (inten[all_tiles[i].layer],
                                                all_tiles[i].rows *
                                                all_tiles[i].cols))
        groups: List[List[int]] = []
        placed = [False] * n
        budget_excess = n - spec.n_cores
        for idx in order:
            if placed[idx]:
                continue
            group = [idx]
            placed[idx] = True
            if budget_excess > 0:
                for jdx in order:
                    if placed[jdx] or budget_excess <= 0:
                        continue
                    rs = sum(all_tiles[g].rows for g in group) + all_tiles[jdx].rows
                    cs = sum(all_tiles[g].cols for g in group) + all_tiles[jdx].cols
                    diag_ok = rs <= row_cap and cs <= col_cap
                    horiz_ok = (all_tiles[jdx].rows == all_tiles[group[0]].rows
                                and len(group) < 4)
                    if diag_ok or horiz_ok:
                        group.append(jdx)
                        placed[jdx] = True
                        budget_excess -= 1
            groups.append(group)
        if len(groups) > spec.n_cores:
            raise ValueError(
                f"model needs {len(groups)} cores > {spec.n_cores} available")
        for gi, group in enumerate(groups):
            if len(group) > 1:
                merged.append(tuple(all_tiles[g].layer for g in group))
            for slot, g in enumerate(group):
                all_tiles[g].core = gi
                all_tiles[g].seq_slot = slot
        n_used = len(groups)
        dup: Dict[str, int] = {}
    else:
        for ci, t in enumerate(all_tiles):
            t.core = ci
        # 2) duplicate hottest layers into spare cores (data parallelism)
        dup = {}
        spare = spec.n_cores - n
        extra: List[Tile] = []
        for r in sorted(reqs, key=lambda r: -r.intensity):
            if spare <= 0 or r.intensity <= 1.0:
                break
            base = [t for t in all_tiles if t.layer == r.name]
            copies = min(spare // max(len(base), 1),
                         max(int(r.intensity) - 1, 0))
            for c in range(copies):
                if spare < len(base):
                    raise AssertionError(
                        f"replica overruns core budget ({spare=} < "
                        f"{len(base)=})")
                for t in base:
                    extra.append(dataclasses.replace(
                        t, core=spec.n_cores - spare, replica=c + 1))
                    spare -= 1
            if copies:
                dup[r.name] = copies
        all_tiles += extra
        n_used = spec.n_cores - spare

    return Plan(tiles=all_tiles, n_cores_used=n_used, duplicated=dup,
                merged=merged)


# ------------------------------------------------------------- stage 2: schedule

@dataclasses.dataclass(frozen=True)
class TileSchedule:
    """Stage 2 (SCHEDULE): one layer's tiles serialized into ordered passes.

    order: pass-major slot -> index into the layer's replica-0 tile list
           (None = idle slot). n_passes: number of sequential passes.
    pass_len: tiles per pass, after padding to the widest pass.
    """
    order: Tuple[Optional[int], ...]
    n_passes: int
    pass_len: int


def schedule_tiles(tiles: Sequence[Tile]) -> TileSchedule:
    """Serialize same-core `seq_slot` tiles into ordered passes, each pass
    sorted by output then input block; narrower passes pad idle slots."""
    tiles = [t for t in tiles if t.replica == 0]
    if not tiles:
        raise ValueError("schedule_tiles needs at least one tile")
    slots = sorted({t.seq_slot for t in tiles})
    rank = {s: i for i, s in enumerate(slots)}
    passes: List[List[int]] = [[] for _ in slots]
    for i, t in enumerate(tiles):
        passes[rank[t.seq_slot]].append(i)
    for p in passes:
        p.sort(key=lambda i: (tiles[i].col0, tiles[i].row0))
    pass_len = max(len(p) for p in passes)
    order: List[Optional[int]] = []
    for p in passes:
        order += p + [None] * (pass_len - len(p))
    return TileSchedule(order=tuple(order), n_passes=len(passes),
                        pass_len=pass_len)


@dataclasses.dataclass
class PackedPlan:
    """One layer's tile plan as data: padded stacked tile tensors + static
    index maps, executable as a single kernel launch.

    Tensors (on the device the layer serves from):
      gd_tiles:       (T, bk, bn) zero-padded per-tile G+ - G- blocks (or
                      raw weights for the generic executor).
      inv_norm_tiles: (T, 1, bn)  per-tile per-column 1/sum(G+ + G-); 0 in
                      padded columns.
      v_decr_tiles:   (T,)        per-tile ADC charge-decrement step.
      denorm_tiles:   (T, 1, bn)  digital accumulation factor of each
                      tile's counts: the valid-column mask, or mask * norm
                      * v_decr (fold_norm, de-normalized charge units).
    Made from the static maps on that device when the plan is built, for
    the kernels to read:
      row_index:      (T,) int32  row_block (the input block per slot).
      col_start:      (n_col_blocks + 1,) int32 CSR offsets: column block
                      j's tiles are slots [col_start[j], col_start[j+1]).
                      None when col_block is not non-decreasing (a
                      multi-pass plan) and for transpose plans; the
                      single-pass kernel refuses both.
      run_start:      (n_runs + 1,) int32 CSR offsets of each fused run's
                      slots (out_slot is non-decreasing).
      col_run_start / col_runs: CSR of each output column block's live
                      runs, in run order (runs with out_col -1 left out).
      live_slots:     (L,) int32 the slots of live runs, in slot order:
                      the term blocks of the kernels' split route (idle
                      slots, a pass's padding, are neither computed nor
                      read).
      tile_index:     (T,) int32 tile_slot for transpose plans, else None.

    Static geometry (as in the reference): row_block / col_block (slot ->
    input / output block), seq_slot (slot -> pass), n_passes, transpose,
    tile_slot (slot -> stack position; identity for forward plans),
    out_slot / out_col (the fused run layout of multi-pass plans).
    """
    layer: str
    bk: int
    bn: int
    n_rows: int
    n_cols: int
    row_block: Tuple[int, ...]
    col_block: Tuple[int, ...]
    seq_slot: Tuple[int, ...]
    n_passes: int
    transpose: bool
    tile_slot: Tuple[int, ...]
    out_slot: Tuple[int, ...]
    out_col: Tuple[int, ...]
    gd_tiles: torch.Tensor
    inv_norm_tiles: torch.Tensor
    v_decr_tiles: torch.Tensor
    denorm_tiles: torch.Tensor
    row_index: torch.Tensor = dataclasses.field(init=False)
    col_start: Optional[torch.Tensor] = dataclasses.field(init=False)
    run_start: torch.Tensor = dataclasses.field(init=False)
    col_run_start: torch.Tensor = dataclasses.field(init=False)
    col_runs: torch.Tensor = dataclasses.field(init=False)
    live_slots: torch.Tensor = dataclasses.field(init=False)
    tile_index: Optional[torch.Tensor] = dataclasses.field(init=False)

    def __post_init__(self):
        dev = self.gd_tiles.device

        def table(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)
        self.row_index = table(self.row_block)
        starts = None if self.transpose else col_block_offsets(self.col_block)
        self.col_start = None if starts is None else table(starts)
        run_start, col_run_start, col_runs = run_tables(
            self.out_slot, self.out_col, self.n_col_blocks)
        self.run_start = table(run_start)
        self.col_run_start = table(col_run_start)
        self.col_runs = table(col_runs)
        self.live_slots = table(live_slots(self.out_slot, self.out_col))
        self.tile_index = table(self.tile_slot) if self.transpose else None

    def route(self, scheduled=None) -> str:
        """The kernel this plan launches: 'cim_mvm_transposed' for a
        transpose plan, else 'cim_mvm_scheduled' iff the plan has more than
        one pass (or `scheduled` forces it), else 'cim_mvm_packed'."""
        if self.transpose:
            return "cim_mvm_transposed"
        if scheduled is None:
            scheduled = self.n_passes > 1
        if self.n_passes > 1 and not scheduled:
            raise ValueError(
                f"plan '{self.layer}' has {self.n_passes} sequential passes; "
                "the tile-grid kernel cannot serialize merged cores")
        return "cim_mvm_scheduled" if scheduled else "cim_mvm_packed"

    def run_layout(self, fused: bool = True):
        """(run_start, col_run_start, col_runs, n_run_ranks, n_run_len): the
        run tables the scheduled and transposed kernels walk and their
        plain version's loop bounds. fused=False gives the reference's
        per-slot partial baseline (out_slot = range(T), out_col =
        col_block): each slot its own run, a column block's runs in slot
        order, each summed from zero and folded in run order; idle slots
        stay idle runs."""
        if fused:
            return (self.run_start, self.col_run_start, self.col_runs,
                    self.n_run_ranks, self.n_run_len)
        return self._unfused_layout

    @functools.cached_property
    def _unfused_layout(self):
        out_col = [c if self.out_col[r] >= 0 else -1
                   for c, r in zip(self.col_block, self.out_slot)]
        live = [c for c in out_col if c >= 0]
        tables = run_tables(range(self.n_tiles), out_col, self.n_col_blocks)
        dev = self.gd_tiles.device
        return (*(torch.tensor(t, dtype=torch.int32, device=dev)
                  for t in tables),
                max(collections.Counter(live).values()) if live else 0,
                1 if live else 0)

    @functools.cached_property
    def n_ranks(self) -> int:
        """The most tiles one output column block holds (the row-split
        depth the plain version loops over)."""
        return max(collections.Counter(self.col_block).values())

    @functools.cached_property
    def n_run_ranks(self) -> int:
        """The most live runs one output column block folds."""
        live = [c for c in self.out_col if c >= 0]
        return max(collections.Counter(live).values()) if live else 0

    @functools.cached_property
    def n_run_len(self) -> int:
        """The most slots one live run holds."""
        lens = collections.Counter(self.out_slot)
        return max((lens[r] for r, c in enumerate(self.out_col) if c >= 0),
                   default=0)

    @property
    def n_tiles(self) -> int:
        return len(self.row_block)

    @property
    def pass_len(self) -> int:
        return self.n_tiles // self.n_passes

    @functools.cached_property
    def n_row_blocks(self) -> int:
        return max(self.row_block) + 1

    @functools.cached_property
    def n_col_blocks(self) -> int:
        return max(self.col_block) + 1


def col_block_offsets(col_block: Sequence[int]) -> Optional[List[int]]:
    """CSR offsets of a slot -> column-block map: entry j is the first slot
    of column block j, the last entry the slot count. None when col_block
    is not non-decreasing (its blocks are not contiguous ranges)."""
    if any(b < a for a, b in zip(col_block, col_block[1:])):
        return None
    n_cb = max(col_block) + 1
    starts = [0] * (n_cb + 1)
    for b in col_block:
        starts[b + 1] += 1
    for j in range(n_cb):
        starts[j + 1] += starts[j]
    return starts


def run_tables(out_slot: Sequence[int], out_col: Sequence[int],
               n_col_blocks: int) -> Tuple[List[int], List[int], List[int]]:
    """The kernels' run tables of a fused layout: (run_start, CSR offsets
    of each run's slots; col_run_start and col_runs, CSR of each column
    block's live runs in run order). out_slot must be non-decreasing (the
    verifier's `fused-runs` invariant); runs with out_col -1 are idle."""
    run_start = [0] * (len(out_col) + 1)
    for r in out_slot:
        if 0 <= r < len(out_col):
            run_start[r + 1] += 1
    for r in range(len(out_col)):
        run_start[r + 1] += run_start[r]
    per_col: List[List[int]] = [[] for _ in range(n_col_blocks)]
    for r, c in enumerate(out_col):
        if 0 <= c < n_col_blocks:
            per_col[c].append(r)
    col_run_start = [0]
    for runs in per_col:
        col_run_start.append(col_run_start[-1] + len(runs))
    return run_start, col_run_start, [r for runs in per_col for r in runs]


def live_slots(out_slot: Sequence[int], out_col: Sequence[int]
               ) -> List[int]:
    """The slots of live runs (out_col >= 0), in slot order."""
    return [s for s, r in enumerate(out_slot) if out_col[r] >= 0]


def _slot_order(tiles: Sequence[Tile], schedule: Optional[TileSchedule]
                ) -> Tuple[List[Optional[int]], int, int]:
    """The slot -> tile-index order a (scheduled) pack executes in.
    Returns (order, n_passes, pass_len); idle slots are None."""
    if schedule is None:
        order: List[Optional[int]] = sorted(
            range(len(tiles)),
            key=lambda i: (tiles[i].col0, tiles[i].row0, tiles[i].seq_slot))
        return order, 1, len(tiles)
    # the non-idle slots must be exactly a permutation of the tiles
    covered = sorted(i for i in schedule.order if i is not None)
    if covered != list(range(len(tiles))):
        raise ValueError("schedule does not cover this tile sequence "
                         f"exactly once ({schedule.order=} vs "
                         f"{len(tiles)} tiles)")
    return list(schedule.order), schedule.n_passes, schedule.pass_len


def _fused_layout(blocks: Sequence[Optional[int]], pass_len: int
                  ) -> Tuple[List[int], Tuple[int, ...], Tuple[int, ...]]:
    """Fused slot layout: re-sort each pass's slots STABLY by output block
    (idle slots to the pass tail). Returns (perm, out_slot, out_col):
    perm maps grid position -> original slot, out_slot grid position ->
    output RUN (a maximal stretch of consecutive positions sharing one
    output block), out_col run -> output block (-1 = all-idle run)."""
    perm: List[int] = []
    for p0 in range(0, len(blocks), pass_len):
        chunk = list(range(p0, min(p0 + pass_len, len(blocks))))
        chunk.sort(key=lambda i: (1, 0) if blocks[i] is None
                   else (0, blocks[i]))
        perm += chunk
    out_slot: List[int] = []
    out_col: List[int] = []
    for pos in perm:
        blk = -1 if blocks[pos] is None else blocks[pos]
        if not out_col or out_col[-1] != blk:
            out_col.append(blk)
        out_slot.append(len(out_col) - 1)
    return perm, tuple(out_slot), tuple(out_col)


def transpose_tiles(tiles: Sequence[Tile]) -> List[Tile]:
    """The SAME physical tiles viewed in the transpose (BL->SL) direction:
    row/col offsets and extents swap; core, replica and seq_slot stay."""
    return [dataclasses.replace(t, row0=t.col0, col0=t.row0,
                                rows=t.cols, cols=t.rows) for t in tiles]


def block_view(mat, bk: int, bn: int):
    """(R, C) -> (ceil(R/bk), ceil(C/bn), bk, bn) blocks, zero-padded at
    the ragged edge. A view when the matrix divides evenly."""
    r, c = mat.shape
    pr, pc = -r % bk, -c % bn
    if pr or pc:
        mat = F.pad(mat, (0, pc, 0, pr))
    return mat.reshape(mat.shape[0] // bk, bk, mat.shape[1] // bn,
                       bn).permute(0, 2, 1, 3)


def tile_blocks(tiles: Sequence[Tile], mat, bk: int, bn: int):
    """Gather each tile's (bk, bn) block of `mat`, zero outside the tile's
    own extent (exactly the reference's per-tile zero-padded slice).
    Returns (len(tiles), bk, bn), plus the (len(tiles), bn) column mask."""
    dev = mat.device
    rb = torch.tensor([t.row0 // bk for t in tiles], device=dev)
    cb = torch.tensor([t.col0 // bn for t in tiles], device=dev)
    rows = torch.tensor([t.rows for t in tiles], device=dev)
    cols = torch.tensor([t.cols for t in tiles], device=dev)
    rmask = torch.arange(bk, device=dev)[None, :] < rows[:, None]
    cmask = torch.arange(bn, device=dev)[None, :] < cols[:, None]
    blk = block_view(mat, bk, bn)[rb, cb]
    keep = rmask[:, :, None] & cmask[:, None, :]
    return torch.where(keep, blk, torch.zeros((), dtype=blk.dtype,
                                              device=dev)), cmask


def pack_tiles(tiles: Sequence[Tile], gd, *, gsum=None, v_decr=1.0,
               fold_norm: bool = False,
               schedule: Optional[TileSchedule] = None) -> PackedPlan:
    """Stage 5 (PACK): gather one layer's (scheduled) tiles into a PackedPlan.

    gd: (R, C) folded differential conductances G+ - G- (or raw weights).
    gsum: optional (R, C) G+ + G- whose per-tile column sums give the
        voltage-mode normalizer; None means normalizer 1 (raw matmul).
    v_decr: scalar, or (T,) per-tile ADC steps aligned with the replica-0
        tiles in the ORDER GIVEN.
    fold_norm: fold mask * norm * v_decr into denorm_tiles (de-normalized
        charge units, the serving path); False keeps raw summed counts.
    schedule: optional TileSchedule over the same tiles; None packs a
        single-pass plan in output-block order.
    """
    tiles = [t for t in tiles if t.replica == 0]
    if not tiles:
        raise ValueError("pack_tiles needs at least one tile")
    bk = max(t.rows for t in tiles)
    bn = max(t.cols for t in tiles)
    for t in tiles:
        if t.row0 % bk or t.col0 % bn:
            raise ValueError(
                f"tile offsets ({t.row0},{t.col0}) not aligned to "
                f"({bk},{bn}) blocks — not a splitter-produced plan")
    order, n_passes, pass_len = _slot_order(tiles, schedule)
    blocks = [None if i is None else tiles[i].col0 // bn for i in order]
    perm, out_slot, out_col = _fused_layout(blocks, pass_len)
    order = [order[p] for p in perm]
    n_rows = max(t.row0 + t.rows for t in tiles)
    n_cols = max(t.col0 + t.cols for t in tiles)

    gd = gd.to(torch.float32)
    dev = gd.device
    v_decr = torch.broadcast_to(
        torch.as_tensor(v_decr, dtype=torch.float32, device=dev),
        (len(tiles),))
    live = [s for s, i in enumerate(order) if i is not None]
    idx = [order[s] for s in live]
    ts = [tiles[i] for i in idx]
    gd_live, cmask = tile_blocks(ts, gd, bk, bn)
    mask = cmask.to(torch.float32)
    if gsum is None:
        inv = norm = mask                   # normalizer 1 on valid columns
    else:
        gs_live, _ = tile_blocks(ts, gsum.to(torch.float32), bk, bn)
        norm = torch.sum(gs_live, dim=1)    # zero in padded columns
        inv = torch.where(norm > 0, 1.0 / torch.clamp(norm, min=1e-30),
                          torch.zeros((), device=dev))
    vd_live = v_decr[torch.tensor(idx, device=dev)]
    den = (mask * norm * vd_live[:, None]) if fold_norm else mask

    n_slots = len(order)
    if len(live) == n_slots:
        gd_tiles, inv_t, den_t, vd_t = gd_live, inv, den, vd_live
    else:                                   # idle slots: inert zero tiles
        sel = torch.tensor(live, device=dev)
        gd_tiles = torch.zeros((n_slots, bk, bn), device=dev)
        gd_tiles[sel] = gd_live
        inv_t = torch.zeros((n_slots, bn), device=dev)
        inv_t[sel] = inv
        den_t = torch.zeros((n_slots, bn), device=dev)
        den_t[sel] = den
        vd_t = torch.ones((n_slots,), device=dev)
        vd_t[sel] = vd_live
    row_block = tuple(0 if i is None else tiles[i].row0 // bk for i in order)
    col_block = tuple(0 if i is None else tiles[i].col0 // bn for i in order)
    return PackedPlan(
        layer=tiles[0].layer, bk=bk, bn=bn, n_rows=n_rows, n_cols=n_cols,
        row_block=row_block, col_block=col_block,
        seq_slot=tuple(s // pass_len for s in range(n_slots)),
        n_passes=n_passes, transpose=False,
        tile_slot=tuple(range(n_slots)), out_slot=out_slot, out_col=out_col,
        gd_tiles=gd_tiles, inv_norm_tiles=inv_t[:, None, :],
        v_decr_tiles=vd_t, denorm_tiles=den_t[:, None, :])


def pack_tiles_transposed(tiles: Sequence[Tile], packed: PackedPlan, *,
                          gsum=None, v_decr=1.0, fold_norm: bool = False,
                          schedule: Optional[TileSchedule] = None
                          ) -> PackedPlan:
    """Stage 5 (PACK), transpose direction: the BL->SL view of a packed
    forward plan. It shares `packed.gd_tiles` (the forward stack, by
    reference) and builds only this direction's per-ROW normalizer, ADC
    steps and denorms, in this direction's own fused slot order; tile_slot
    maps each slot to its position in the shared stack.

    tiles / schedule: the SAME forward-space inputs given to `pack_tiles`.
    gsum: (R, C) G+ + G- in the forward orientation; None means raw
    matmul. v_decr: scalar or (T,) transpose-direction ADC steps aligned
    with the replica-0 tiles in the order given.
    """
    tiles = [t for t in tiles if t.replica == 0]
    if not tiles:
        raise ValueError("pack_tiles_transposed needs at least one tile")
    if packed.transpose:
        raise ValueError("packed must be the forward-direction plan")
    order, n_passes, pass_len = _slot_order(tiles, schedule)
    if len(order) != packed.n_tiles or n_passes != packed.n_passes:
        raise ValueError(
            f"tiles/schedule do not match the forward pack "
            f"({len(order)} slots vs {packed.n_tiles}, "
            f"{n_passes} passes vs {packed.n_passes})")
    bk_f, bn_f = packed.bk, packed.bn
    # the forward pack built gd_tiles in ITS fused order: reproduce that
    # permutation to locate each slot in the shared stack, then fuse this
    # direction's slots by its own output blocks (forward ROW blocks)
    blocks_f = [None if i is None else tiles[i].col0 // bn_f for i in order]
    perm_f, _, _ = _fused_layout(blocks_f, pass_len)
    stack_pos = {p: g for g, p in enumerate(perm_f)}
    blocks_b = [None if i is None else tiles[i].row0 // bk_f for i in order]
    perm_b, out_slot, out_col = _fused_layout(blocks_b, pass_len)
    tile_slot = tuple(stack_pos[p] for p in perm_b)
    order = [order[p] for p in perm_b]

    dev = packed.gd_tiles.device
    v_decr = torch.broadcast_to(
        torch.as_tensor(v_decr, dtype=torch.float32, device=dev),
        (len(tiles),))
    live = [s for s, i in enumerate(order) if i is not None]
    idx = [order[s] for s in live]
    ts = [tiles[i] for i in idx]
    rows = torch.tensor([t.rows for t in ts], device=dev)
    mask = (torch.arange(bk_f, device=dev)[None, :]
            < rows[:, None]).to(torch.float32)
    if gsum is None:
        inv = norm = mask                   # normalizer 1 on valid rows
    else:
        gs_live, _ = tile_blocks(ts, gsum.to(torch.float32), bk_f, bn_f)
        norm = torch.sum(gs_live, dim=2)    # zero in padded rows
        inv = torch.where(norm > 0, 1.0 / torch.clamp(norm, min=1e-30),
                          torch.zeros((), device=dev))
    vd_live = v_decr[torch.tensor(idx, device=dev)]
    den = (mask * norm * vd_live[:, None]) if fold_norm else mask

    n_slots = len(order)
    if len(live) == n_slots:
        inv_t, den_t, vd_t = inv, den, vd_live
    else:                                   # idle slots: inert zero rows
        sel = torch.tensor(live, device=dev)
        inv_t = torch.zeros((n_slots, bk_f), device=dev)
        inv_t[sel] = inv
        den_t = torch.zeros((n_slots, bk_f), device=dev)
        den_t[sel] = den
        vd_t = torch.ones((n_slots,), device=dev)
        vd_t[sel] = vd_live
    return PackedPlan(
        layer=packed.layer, bk=bn_f, bn=bk_f,
        n_rows=packed.n_cols, n_cols=packed.n_rows,
        row_block=tuple(packed.col_block[g] for g in tile_slot),
        col_block=tuple(packed.row_block[g] for g in tile_slot),
        seq_slot=packed.seq_slot, n_passes=n_passes, transpose=True,
        tile_slot=tile_slot, out_slot=out_slot, out_col=out_col,
        gd_tiles=packed.gd_tiles,           # SHARED: one conductance set
        inv_norm_tiles=inv_t[:, None, :], v_decr_tiles=vd_t,
        denorm_tiles=den_t[:, None, :])


def multicore_mvm_packed(x, packed: PackedPlan, cfg=None, *, seed: int = 0,
                         bm=None, scheduled=None, fused: bool = True,
                         impl: str = "auto"):
    """A whole layer's tile plan in ONE kernel launch (the packed,
    scheduled or transposed kernel, by the plan; `scheduled` forces the
    scheduled kernel onto a single-pass plan).

    With a CIMConfig, the CIM datapath on integer-valued x (ADC counts
    accumulated per the plan's denorm_tiles). With cfg None, the exact
    tiled matmul x @ W (identity epilogue, n_max 1, v_read 1.0): each
    tile's dot in FP64, rounded once to f32, the tiles summed in f32 in
    slot order. On the card the split route (packed and scheduled plans,
    M <= 16) reads any float x; the walk (M > 16, and every transposed
    launch) reads x as int8, so there x must hold integers |x| <= 127 and
    anything else raises. fused=False runs the per-slot partial baseline
    (`PackedPlan.run_layout`; bit for bit the fused sums on integer
    counts); bm keys the stochastic neuron's draws (`ops.packed_call`).
    impl="plain" forces the plain version."""
    from ..kernels.cim_mvm import kernel as K
    from ..kernels.cim_mvm.ops import cim_mvm_packed, packed_call
    if cfg is not None:
        return cim_mvm_packed(x, packed, cfg, seed=seed, bm=bm,
                              scheduled=scheduled, fused=fused, impl=impl)
    walk = packed.transpose or not K.split_route(x.shape[0])
    if impl != "plain" and x.device.type == "cuda" and walk and not bool(
            ((x == torch.round(x)) & (x.abs() <= 127)).all()):
        raise ValueError(
            f"the walk ({x.shape[0]} rows, plan '{packed.layer}') reads x "
            "as int8: an exact matmul there takes integers |x| <= 127")
    return packed_call(x, packed, activation="identity", n_max=1,
                       v_read=1.0, seed=seed, bm=bm, scheduled=scheduled,
                       fused=fused, impl=impl)


def multicore_mvm(x, weight, plan_tiles: Sequence[Tile], matmul_fn):
    """y = x @ weight tile by tile with digital partial sums: the
    reference's readable per-tile loop (one product per tile, plain
    PyTorch; `multicore_mvm_packed` is the one-launch path).

    matmul_fn(x_tile, w_tile, tile) -> (B, tile.cols) performs one core's
    MVM (exact, noisy or chip-simulated); row-split partial sums
    accumulate in f32, tile by tile in plan order."""
    b = x.shape[0]
    y = torch.zeros((b, weight.shape[1]), dtype=torch.float32,
                    device=x.device)
    for t in plan_tiles:
        cols = slice(t.col0, t.col0 + t.cols)
        yt = matmul_fn(x[:, t.row0:t.row0 + t.rows],
                       weight[t.row0:t.row0 + t.rows, cols], t)
        y[:, cols] = y[:, cols] + yt
    return y


def interleave_assignment(n_units: int, n_cores: int, device=None):
    """Paper Fig. 4f: adjacent pixels (visible units) go to different
    cores, so each core sees a down-sampled version of the whole image.
    Returns the core index per unit."""
    return torch.arange(n_units, device=device) % n_cores
