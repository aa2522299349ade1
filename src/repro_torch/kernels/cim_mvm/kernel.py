"""The CIM MVM kernels: hand-written CUDA kernels for Hopper and their plain
PyTorch versions (port of `repro/kernels/cim_mvm/kernel.py`).

`cim_mvm` (replaces `cim_mvm_pallas`) runs ONE programmed matrix: q =
(x @ gd) * v_read * inv_norm, then the epilogue, with the stochastic
neuron hashed at the reference's block-local coordinates (row % bm_ref,
col % bn_ref) and salts (seed, row // bm_ref, col // bn_ref) for the
reference's block (bm_ref, bn_ref). `cim_forward` is the same kernel with
the per-matrix path's glue fused in (`core/cim.forward`): float patches in
(bias rows appended as a constant), quantized on load; offset cancellation
and dequantization in the epilogue; float out. Its plain version,
`cim_forward_plain`, is the composition quantize_to_int -> cim_mvm_plain
-> offset -> dequantize_output. Both run on the FP64 tensor cores over a
persistent grid; `mvm_launch_geometry` picks the tiling by the runtime's
occupancy of each candidate (`mvm_geometry`, `csrc/cim_mvm.cu`).

Three kernels execute a packed tile plan (core/mapping.PackedPlan) in one
launch each; for every output column block j and every tile t of j, in the
reference's order,

    q      = x[:, in_block[t]] @ tile(t) * v_read * inv_norm[t]
    counts = epilogue(q)          ADC charge-decrement count + activation
    out[:, j] += counts * weight[t]

  * `cim_mvm_packed` (replaces `cim_mvm_packed_pallas`): single-pass plans;
    column block j's tiles are the slot range [col_start[j],
    col_start[j+1]), summed left to right.
  * `cim_mvm_scheduled` (replaces `cim_mvm_scheduled_pallas`): merged-core
    plans on the pass-major slot order. Each fused RUN (a stretch of
    consecutive slots of one column block) sums its slots into a partial
    from zero, and column block j folds its live runs in run order — the
    reference's in-kernel run accumulation followed by `_fold_runs`.
    Idle runs (`out_col == -1`) are never read.
  * `cim_mvm_transposed` (replaces `cim_mvm_transposed_pallas`): the
    BL->SL direction over the SHARED forward stack: slot t reads
    gd_tiles[tile_slot[t]] contracted on its stored column axis, with the
    direction's per-row normalizer; runs fold as in the scheduled kernel.

The epilogue is the reference's `_epilogue` (none, relu, tanh, sigmoid,
identity, stochastic) and the weight its `_acc_weight`: the plan's denorm,
or the valid-column mask (inv_norm > 0) for stochastic comparator bits.
The stochastic neuron draws `hash_uniform` (kernels/prng.py) at the
reference's coordinates: row r % bm_ref, column inside the tile's output
block, salts (seed, r // bm_ref, j) with j the slot (the stack position
for the transposed kernel) and bm_ref = min(bm, M) for the caller's batch
block bm (default HASH_BM = 256, the reference's default).

The packed and scheduled kernels have two routes on the card, picked from
the batch rows M by `split_route`: at decode (M up to SPLIT_ROWS[-1]) the
split route (`csrc/cim_split.cuh`) computes every live tile's terms
counts * weight in parallel, one block per tile, into a scratch tensor,
then folds each output's terms in the order above (`cim_terms_plain` and
`cim_fold_plain` are its two kernels' plain versions); above, the walk
(`csrc/cim_walk.cuh`): a persistent grid of 4-warp blocks, each owning
items of up to 64 rows x 64 columns of one output column block
(`walk_geometry`), walks that block's tiles in that order with the tile
dots on the FP64 tensor cores. The transposed kernel takes the walk at
every M, with the stored tile read on its column axis (its TRANS flag).
Both routes are the function of `cim_runs_plain`, bit for bit. A caller
may pin the route and the walk's item layout (`Route`: what
`autotune.tune` sweeps); a pinned route changes no output.

Each wrapper takes the plain version for a CPU tensor and launches its
kernel (`csrc/*.cu`) for a CUDA tensor, or raises — nothing falls back.
The kernels are compiled with nvcc at first use into `build/kernels/`, one
library per source, all built in parallel (`kernels/build.py`), and bound
with ctypes (plain C entry points, no torch headers). `LAUNCHES` (shared
by every kernel of the port) counts each kernel's launches, and only
those.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch

from .. import build as _build
from ..prng import bits_to_uniform, hash_bits_at
from ...core.quant import quantize_to_int
from .ref import dequantize_output

KERNELS = ("cim_mvm_packed", "cim_mvm_scheduled", "cim_mvm_transposed",
           "cim_mvm")
LAUNCHES = _build.LAUNCHES                 # kernel launches, per kernel

ACTIVATIONS = {"none": 0, "relu": 1, "tanh": 2, "sigmoid": 3, "identity": 4,
               "stochastic": 5}
# the kernels with a split route beside the walk
SPLIT_KERNELS = ("cim_mvm_packed", "cim_mvm_scheduled")
# the walk (csrc/cim_walk.cuh): the rows and columns of an item (a block
# of 4 warps) per layout, and the layout's ring stages
WALK_ITEMS = ((64, 64), (32, 64), (32, 32))
WALK_STAGES = (2, 2, 4)
WALK_MAX_CHUNK = 128  # tile rows per stage, at most
WALK_BARRIER_BYTES = 128  # the stages' mbarriers, padded
SPLIT_ROWS = (4, 16)  # the split route's row blocks (it takes M <= 16)
SPLIT_THREADS = 256   # most tile columns of the split route (one thread each)
SPLIT_CHUNK_ROWS = 16  # tile rows per bulk copy of the split route
SPLIT_STAGES = 3      # bulk copies in flight per term block
SPLIT_BARRIER_BYTES = 128  # the stages' mbarriers, padded
SMEM_LIMIT = 232_448  # shared memory a Hopper block can use, bytes
H100_SMS = 132        # SMs of an H100 SXM (the verifier's geometry)
MVM_WARPS = 4         # warps of a single-matrix block
MVM_BARRIER_BYTES = 128  # its stages' mbarriers, padded
MVM_STAGES = (4, 3, 2)   # ring depths tried, deepest first
# the warp layouts (wc warps across the tile's columns, rf 8-row fragments
# per warp, in pairs for m16n8k4) `mvm_geometry` chooses from, by the
# 8-column groups of a tile
MVM_LAYOUTS = {1: ((1, 4), (1, 2)), 2: ((1, 4), (1, 2), (2, 2)),
               4: ((1, 2), (2, 2), (4, 2)), 8: ((2, 2), (4, 2))}
HASH_BM = 256         # the reference's default batch block (autotune.py)
REF_BLOCK = (256, 256, 256)   # the reference cim_mvm's default (bm, bk, bn)

_lib: Dict[str, ctypes.CDLL] = {}
# (m, k, n) launches whose geometry's shared memory is checked against the
# built kernel at load: both ring layouts, every column tiling
_MVM_CHECK_SHAPES = ((200704, 145, 16), (12544, 577, 64), (256, 577, 10),
                     (1, 300, 500), (4096, 9000, 8), (257, 33, 32))
# (m, bk, bn, n_cb) walk launches checked the same way: every layout, a
# ragged chunk and bn = 47; transposed, also contractions off the 16-byte
# grid (one chunk of all of them) and one past 128 columns
_WALK_CHECK_SHAPES = ((256, 128, 256, 16), (256, 128, 256, 8),
                      (17, 128, 256, 8), (64, 35, 47, 10), (256, 128, 47, 1))
_WALK_CHECK_SHAPES_T = ((256, 256, 128, 28), (64, 121, 128, 7),
                        (17, 47, 128, 8), (64, 250, 70, 3))


def split_route(m: int) -> bool:
    """Whether a packed or scheduled launch of m rows takes the split route
    (term pass over the live tiles, then the fold) rather than the walk:
    m <= SPLIT_ROWS[-1] = 16, decode. The edge is measured (chip_smoke.py
    `route-edge`): on a full-width gemma2-9b layer the split route beats
    the walk at every batch it runs, 4 and 16 rows."""
    return m <= SPLIT_ROWS[-1]


class Route(NamedTuple):
    """A launch route of the packed kernels: kind "split" (the term pass
    and the fold, M <= 16; packed and scheduled kernels), "walk" with its
    item layout (an index into WALK_ITEMS; None: the one `walk_geometry`
    picks), or "rule" (`RULE`: the route and layout the rules pick, as
    route=None does)."""
    kind: str
    layout: Optional[int] = None

    def __str__(self):
        if self.kind != "walk":
            return self.kind
        if self.layout is None:
            return "walk"
        return "walk %dx%d" % WALK_ITEMS[self.layout]


RULE = Route("rule")


def _takes_split(kernel: str, m: int, route: Optional[Route]) -> bool:
    """Whether a launch takes the split route: by rule, or as pinned."""
    if route is None or route.kind == "rule":
        return kernel in SPLIT_KERNELS and split_route(m)
    if route.kind not in ("split", "walk"):
        raise ValueError(f"unknown route kind {route.kind!r}")
    if route.kind == "split" and kernel not in SPLIT_KERNELS:
        raise ValueError(f"{kernel} has no split route")
    return route.kind == "split"


def split_rows(m: int) -> int:
    """Rows of x per term block of the split route: 4 or 16."""
    return next(b for b in SPLIT_ROWS if b >= m)


def split_shared_bytes(bm: int, bk: int, bn: int) -> int:
    """Dynamic shared memory of one term block of the split route at bm
    rows of a (bk, bn) tile: the mbarriers, the ring of SPLIT_STAGES
    chunks of SPLIT_CHUNK_ROWS tile rows (each with 16 bytes of slack: the
    bulk copy moves a chunk's 16-byte-aligned cover), and the block's x
    rows as doubles (checked against the built kernels when the libraries
    load)."""
    return (SPLIT_BARRIER_BYTES
            + SPLIT_STAGES * (SPLIT_CHUNK_ROWS * bn * 4 + 16) + bk * bm * 8)


# ------------------------------------------------------------------ the walk

class WalkGeometry(ctypes.Structure):
    """The walk's tiling (csrc/cim_walk.cuh `WalkGeometry`, field for
    field). A block of 4 warps owns an item: bm rows of x times bn_blk
    columns (a strip) of one output column block (layout: its index in
    WALK_ITEMS). gd and x stream through `stages` stages of kc of the
    contraction (tile rows; transposed, stored columns). Items: n_rbk row
    blocks x n_strips strips x the column blocks, the row blocks of one
    strip consecutive. trans: 1 for the transposed walk."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "layout", "bm", "bn_blk", "n_rbk", "n_strips", "kc", "stages",
        "n_items", "trans")]

    def as_dict(self):
        return {f: getattr(self, f) for f, _ in self._fields_}


class WalkArgs(ctypes.Structure):
    """The walk's arguments (csrc/cim_walk.cuh `WalkArgs`; x int8)."""
    _p, _i = ctypes.c_void_p, ctypes.c_int
    _fields_ = [("x", _p), ("M", _i), ("K", _i), ("gd", _p),
                ("inv_norm", _p), ("denorm", _p), ("v_decr", _p),
                ("row_block", _p), ("tile_slot", _p), ("run_start", _p),
                ("col_run_start", _p), ("col_runs", _p), ("n_tiles", _i),
                ("n_col_blocks", _i), ("bk", _i), ("bn", _i), ("out", _p)]


def walk_x_pitch(kc: int) -> int:
    """Bytes per staged x row: the 16-byte cover of kc int8 values, 16 mod
    32 (its 2-byte fragment loads meet no bank conflict)."""
    p = kc + 16
    return p + (48 - p % 32) % 32


def walk_g_pitch(bn_blk: int) -> int:
    """Words per staged gd row: the 16-byte cover of bn_blk values, 4 mod
    8 (the rows a k-step's four lane slots read, two apart, land in four
    bank octets)."""
    p = bn_blk + 4
    return p + (12 - p % 8) % 8


def walk_shared_bytes(g: WalkGeometry) -> int:
    """Dynamic shared memory of one walk block: the mbarriers and the ring
    of `stages` stages, each bm int8 x rows and the gd rows at their
    pitches: kc tile rows of the strip, or (transposed) the strip's bn_blk
    stored rows of the chunk (checked against the built kernels at
    load)."""
    g_rows, g_pitch = ((g.bn_blk, walk_g_pitch(g.kc)) if g.trans
                       else (g.kc, walk_g_pitch(g.bn_blk)))
    stage = g.bm * walk_x_pitch(g.kc) + g_rows * g_pitch * 4
    return WALK_BARRIER_BYTES + g.stages * stage


def walk_geometry(m: int, bk: int, bn: int, n_cb: int, *,
                  trans: bool = False, n_sm: int = None,
                  layout: Optional[int] = None) -> WalkGeometry:
    """The walk's tiling of an m-row launch over a plan of tiles that
    contract bk inputs into bn outputs (stored (bk, bn); transposed, trans,
    stored (bn, bk)) and n_cb output column blocks, on a card of n_sm SMs
    (default: an H100's). Of the items 64 x 64, 32 x 64 and 32 x 32 (rows
    x columns, WALK_ITEMS), the largest that gives every SM one, and none
    taller than m where 32 rows cover it; where none gives every SM one,
    the smallest. A stage holds kc = min(128, bk rounded up to 16) of the
    contraction; transposed, where the stored rows are off the 16-byte
    grid (bk % 4; no tensor copy), one stage holds all of it (bk <= 256);
    the ring has the layout's WALK_STAGES stages. layout pins the item
    (an index into WALK_ITEMS) instead of the rule."""
    if not (m >= 1 and bk >= 1 and bn >= 1 and n_cb >= 1):
        raise ValueError(f"no walk geometry for m={m}, bk={bk}, bn={bn}, "
                         f"n_cb={n_cb}")
    n_sm = H100_SMS if n_sm is None else n_sm
    kc = min(WALK_MAX_CHUNK, _round16(bk))
    if trans and bk % 4:
        if bk > 2 * WALK_MAX_CHUNK:
            raise ValueError(f"the transposed walk takes at most "
                             f"{2 * WALK_MAX_CHUNK} stored columns off the "
                             f"16-byte grid, the plan has {bk}")
        kc = _round16(bk)
    cands = []
    for lay, (bm, bc) in enumerate(WALK_ITEMS):
        if layout is None and bm > 32 and m <= 32:
            continue
        n_rbk, n_strips = _cdiv(m, bm), _cdiv(bn, bc)
        cands.append(WalkGeometry(lay, bm, bc, n_rbk, n_strips, kc,
                                  WALK_STAGES[lay],
                                  n_rbk * n_strips * n_cb, int(trans)))
    if layout is not None:
        if not 0 <= layout < len(WALK_ITEMS):
            raise ValueError(f"no walk layout {layout}: there are "
                             f"{len(WALK_ITEMS)}")
        return cands[layout]
    return next((g for g in cands if g.n_items >= n_sm), cands[-1])


def walk_layouts(m: int):
    """The walk's item layouts that fit an m-row launch: every one above
    32 rows, the 32-row items at or below (`walk_geometry`'s rule)."""
    return tuple(lay for lay, (bm, _) in enumerate(WALK_ITEMS)
                 if not (bm > 32 and m <= 32))


# ------------------------------------------- single-matrix kernel geometry

class MvmGeometry(ctypes.Structure):
    """The single-matrix kernel's tiling (csrc/cim_mvm.cu `Geometry`, field
    for field). A block's 4 warps cover a chunk of cr rows and a column
    tile of bn = 8 * gf * wc columns: wc warps split the tile's 8-column
    groups (gf each), 4 / wc warp rows take rf row fragments of 8 rows
    each. K runs in slices of bk rows (a multiple of 16); the n_slices
    slices form n_ks splits of spb slices, each its own work item. A
    contiguous geometry has one slice, whose stage is one copy of the
    chunk's whole rows; otherwise each row's slice is a copy. kg = 2 adds
    a second group of 4 warps taking every other 16-row block of K."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "gf", "wc", "rf", "bn", "n_ct", "cr", "n_rc", "bk", "n_slices",
        "spb", "n_ks", "stages", "contiguous", "kg")]

    def as_dict(self):
        return {f: getattr(self, f) for f, _ in self._fields_}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round16(v: int) -> int:
    return _cdiv(v, 16) * 16


def mvm_stage_bytes(g: MvmGeometry, k_x: int) -> int:
    """Bytes of one ring stage: the chunk's rows of x (k_x columns) as one
    16-byte aligned cover, or one cover per row of a slice; with two warp
    groups at least the second group's FP64 sums (8 bytes per output of
    the chunk), which an item's last stage carries to the first."""
    x = (_round16(g.cr * k_x * 4) + 16 if g.contiguous
         else g.cr * (g.bk * 4 + 16))
    return max(x, MVM_WARPS * 32 * g.rf * g.gf * 2 * 8) if g.kg == 2 else x


def mvm_shared_bytes(g: MvmGeometry, k_x: int) -> int:
    """Dynamic shared memory of one block: the mbarriers, gd's slice (bk x
    bn f32) and the ring (checked against the built kernel at load)."""
    return MVM_BARRIER_BYTES + g.bk * g.bn * 4 \
        + g.stages * mvm_stage_bytes(g, k_x)


Occupancy = Callable[[MvmGeometry, int], int]


def one_block(g: MvmGeometry, k_x: int) -> int:
    """The occupancy taken where no card is asked (the verifier, the
    load-time check): every tiling that fits counts as one resident
    block, so the geometry is one that fits."""
    return 1


def mvm_geometry(m: int, k: int, n: int, k_x=None, *,
                 occupancy: Occupancy, n_sm: int) -> MvmGeometry:
    """The single-matrix kernel's tiling of an (m, k) x (k, n) launch whose
    x has k_x <= k columns (the rest are the fused forward's bias rows), on
    a card of n_sm SMs. occupancy(g, k_x): blocks of tiling g resident on
    one SM (0: it cannot launch) — on the card the runtime's own count for
    the instantiation g selects (`mvm_launch_geometry`).

    The column tile is the smallest of 8, 16, 32, 64 columns covering n
    (64-column tiles past that). gd stays resident (one slice of all k)
    when it and at least two stages of whole-row chunks fit; of the warp
    layouts (MVM_LAYOUTS) and ring depths that fit, the one with the most
    blocks resident per SM is taken (the kernel hides its latencies with
    warps), then the fewest warps sharing a row, the most rows per warp
    and the shallowest ring. A launch with fewer than n_sm / 2 work items
    (small m) or whose chunks do not fit splits k instead, into slices
    copied row by row, and spreads the slices over the SMs as separate
    items. Where one block fills an SM, a second warp group joins it."""
    k_x = k if k_x is None else k_x
    if not (m >= 1 and n >= 1 and k >= 1 and 0 <= k_x <= k):
        raise ValueError(f"no geometry for m={m}, k={k}, n={n}, k_x={k_x}")
    groups = 1
    while groups * 8 < n and groups < 8:
        groups *= 2
    bn = 8 * groups

    def make(layout, bk, contiguous, stages, splits):
        wc, rf = layout
        cr = (MVM_WARPS // wc) * 8 * rf
        n_slices = _cdiv(k, bk)
        spb = _cdiv(n_slices, min(n_slices, splits))
        return MvmGeometry(groups // wc, wc, rf, bn, _cdiv(n, bn), cr,
                           _cdiv(m, cr), bk, n_slices, spb,
                           _cdiv(n_slices, spb), stages, contiguous, 1)

    def resident(g):
        return occupancy(g, k_x) if mvm_shared_bytes(g, k_x) <= SMEM_LIMIT \
            else 0

    layouts = MVM_LAYOUTS[groups]
    fits = [(resident(g), g) for g in (make(lay, _round16(k), 1, s, 1)
                                       for lay in layouts
                                       for s in MVM_STAGES)]
    fits = [(b, g) for b, g in fits if b >= 1]
    if fits:
        blocks, whole = max(fits, key=lambda bg: (
            bg[0], -bg[1].wc, bg[1].rf, -bg[1].stages))
        if whole.n_ct * whole.n_rc >= n_sm // 2 or k <= 16:
            return _two_groups(whole, blocks, resident)
    # split k: the layout of fewest rows, slices as large as the items
    # allow and the shared memory holds
    lay = layouts[-1]
    base = make(lay, 16, 0, 2, 1)
    items = base.n_ct * base.n_rc
    splits = _cdiv(n_sm, items) if items < n_sm // 2 else 1
    bk = _round16(_cdiv(k, splits))
    while bk > 16 and mvm_shared_bytes(make(lay, bk, 0, 2, 1), k_x) \
            > SMEM_LIMIT:
        bk -= 16
    stages = next((s for s in MVM_STAGES
                   if mvm_shared_bytes(make(lay, bk, 0, s, 1), k_x)
                   <= SMEM_LIMIT), 2)
    g = make(lay, bk, 0, stages, splits)
    return _two_groups(g, resident(g), resident)


def _two_groups(g: MvmGeometry, blocks: int, resident) -> MvmGeometry:
    """g with a second warp group where only one block of g is resident
    per SM: twice the warps hide the latencies."""
    if blocks > 1:
        return g
    two = MvmGeometry(*(getattr(g, f) for f, _ in g._fields_[:-1]), 2)
    return two if resident(two) >= 1 else g


def mvm_units(g: MvmGeometry, grid: int, block: int):
    """The (column tile, row chunk, slice) units that `block` of a
    `grid`-block launch runs, in its order (the kernel's walk: items
    block, block + grid, ...; each item's slices in order)."""
    out = []
    for item in range(block, g.n_ct * g.n_rc * g.n_ks, grid):
        ct, r = divmod(item, g.n_rc * g.n_ks)
        rc, ks = divmod(r, g.n_ks)
        for s in range(min(g.spb, g.n_slices - ks * g.spb)):
            out.append((ct, rc, ks * g.spb + s))
    return out


def mvm_copies(g: MvmGeometry, m: int, k_x: int, rc: int, sl: int,
               base: int = 0):
    """The bulk copies of unit (row chunk rc, slice sl) for x at byte
    address `base`: (source byte, bytes, stage offset, offset of the first
    wanted byte in the stage) each, as the kernel makes them."""
    r0 = rc * g.cr
    rows = min(g.cr, m - r0)
    if g.contiguous:
        spans = [(base + r0 * k_x * 4, rows * k_x * 4, 0)]
    else:
        k0 = sl * g.bk
        n = min(g.bk, k_x - k0)
        spans = [] if n <= 0 else [
            (base + ((r0 + r) * k_x + k0) * 4, n * 4, r * (g.bk * 4 + 16))
            for r in range(rows)]
    out = []
    for src, nbytes, dst in spans:
        lo = src & ~15
        hi = (src + nbytes + 15) & ~15
        if hi > lo:
            out.append((lo, hi - lo, dst, dst + src - lo))
    return out


def pwl_knots(n_max: int):
    """PWL tanh knots (k0, k1, k2, st0, st1, st2), computed in double as
    the reference does and rounded to f32 where they meet f32 data."""
    s = float(n_max) / 47.0
    k0, k1, k2 = 35.0 * s, 40.0 * s, 43.0 * s
    st1 = k0 + 2.0 * (k1 - k0)
    return k0, k1, k2, k0, st1, st1 + 3.0 * (k2 - k1)


# ------------------------------------------------------------ plain version

def _pwl_tanh(steps, n_max: float):
    """PWL tanh counter schedule — same math as ref.pwl_tanh_counts."""
    k0, k1, k2, st0, st1, st2 = pwl_knots(int(n_max))
    out = torch.where(
        steps <= st0, steps,
        torch.where(steps <= st1, k0 + (steps - st0) * 0.5,
                    torch.where(steps <= st2, k1 + (steps - st1) / 3.0,
                                k2 + (steps - st2) * 0.25)))
    return torch.clamp(torch.floor(out), max=n_max)


def _epilogue(q, vd, activation: str, n_max: int, u=None):
    """ADC epilogue of the reference kernel; vd broadcasts against q. u:
    the stochastic neuron's uniform draws in [0, 1], shaped like q."""
    if activation == "identity":
        return q                   # raw charge passthrough (exact matmul)
    if activation == "stochastic":
        return (q + (u * 2.0 - 1.0) * (vd * n_max) > 0).to(torch.float32)
    sign = torch.sign(q)
    steps = torch.floor(torch.abs(q) / vd + 0.5)
    if activation == "relu":
        return torch.clamp(steps, max=float(n_max)) * (sign > 0)
    if activation in ("tanh", "sigmoid"):
        mag = _pwl_tanh(torch.clamp(steps, max=4.0 * n_max), float(n_max))
        out = sign * mag
        if activation == "sigmoid":
            out = torch.floor((out + n_max) * 0.5)
        return out
    return sign * torch.clamp(steps, max=float(n_max))


def matrix_uniform(m: int, n: int, seed: int, bm_ref: int, bn_ref: int,
                   device):
    """The single-matrix kernel's stochastic draws, (m, n) in [0, 1]: the
    reference's hash_uniform((bm_ref, bn_ref), seed, i, j) of each
    (row block i, column block j) at block-local coordinates."""
    rows = torch.arange(m, device=device)[:, None]
    cols = torch.arange(n, device=device)[None, :]
    return bits_to_uniform(hash_bits_at(rows % bm_ref, cols % bn_ref, seed,
                                        rows // bm_ref, cols // bn_ref))


def cim_mvm_plain(x, gd, inv_norm, v_decr, *, activation: str, n_max: int,
                  v_read: float, seed: int = 0, bm_ref: int, bn_ref: int):
    """The plain PyTorch version of the single-matrix kernel: the dot in
    FP64 (exact for integer x and gd on the 2^-23 grid, so it is the
    kernel's dot bit for bit) rounded once to f32, then q = acc * v_read *
    inv_norm and the epilogue. Returns (M, N) f32."""
    acc = (x.to(torch.float64) @ gd.to(torch.float64)).to(torch.float32)
    q = acc * v_read * inv_norm
    u = None
    if activation == "stochastic":
        u = matrix_uniform(q.shape[0], q.shape[1], seed, bm_ref, bn_ref,
                           x.device)
    return _epilogue(q, v_decr, activation, n_max, u)


def cim_forward_plain(x, gd, inv_norm, v_decr, off_counts, norm, w_max,
                      in_alpha, cfg, bias=None, *, bias_rows: int = 0):
    """The plain PyTorch version of the fused per-matrix forward under
    `cfg` (a CIMConfig): the bias rows appended (`bias` in every row),
    quantize_to_int, the single-matrix plain version, offset cancellation
    for activation 'none', and dequantize_output. Returns (M, N) f32 in
    x @ W units (neuron units for tanh / sigmoid). The stochastic neuron,
    the only reader of the hash block, is not taken (`cim_forward`)."""
    if bias_rows:
        x = torch.cat([x, bias.expand(x.shape[0], bias_rows).to(x.dtype)],
                      dim=-1)
    x_int, scale = quantize_to_int(x, in_alpha, cfg.in_bits, signed=True)
    counts = cim_mvm_plain(x_int.to(torch.float32), gd, inv_norm, v_decr,
                           activation=cfg.activation,
                           n_max=cfg.out_mag_levels, v_read=cfg.v_read,
                           bm_ref=1, bn_ref=1)
    if cfg.activation == "none":
        counts = counts - off_counts[None, :]
    return dequantize_output(counts, v_decr, norm, w_max, scale, cfg)


def _x_blocks(x, n_in_blocks: int, width: int):
    """(M, K) -> (n_in_blocks, M, width), zero-padded at the ragged edge."""
    m, k = x.shape
    xp = torch.nn.functional.pad(x, (0, n_in_blocks * width - k))
    return xp.reshape(m, n_in_blocks, width).permute(1, 0, 2)


def _walk(tables, n_run_ranks: int, n_run_len: int):
    """The kernels' order over one layer, vectorised over output column
    blocks: for run rank k of each column block and slot rank s inside
    that run, in that order, yields (s, slot, slot_valid, run_valid); slot
    is (n_cb,) clamped in range, slot_valid / run_valid (n_cb,) bool."""
    run_start, col_run_start, col_runs = (t.long() for t in tables)
    n_slots = int(run_start[-1])
    lo, hi = col_run_start[:-1], col_run_start[1:]
    for k in range(n_run_ranks):
        kr = lo + k
        run_valid = kr < hi
        run = col_runs[torch.clamp(kr, max=max(col_runs.numel() - 1, 0))] \
            if col_runs.numel() else torch.zeros_like(kr)
        for s in range(n_run_len):
            slot = run_start[run] + s
            valid = run_valid & (slot < run_start[run + 1])
            yield s, torch.clamp(slot, max=n_slots - 1), valid, run_valid


def _dot(xb, gd_tiles, in_index, slot, stack, transpose: bool):
    """Each column block's tile dot at `slot`, in FP64 (exact for integer x
    and conductance-difference tiles, so it is the kernel's dot bit for
    bit), rounded once to f32."""
    g = gd_tiles[stack[slot].long() if stack is not None else slot]
    g = g.to(torch.float64)
    if transpose:
        g = g.transpose(1, 2)
    return torch.bmm(xb[in_index[slot].long()], g).to(torch.float32)


def _uniform(q_shape, m: int, slot_salt, seed: int, device,
             bm: int = HASH_BM):
    """The stochastic draws of one (n_cb, M, bn) step at the reference's
    hash coordinates for batch block bm (see the module docstring)."""
    bm = min(bm, m)
    rows = torch.arange(m, device=device)[None, :, None]
    cols = torch.arange(q_shape[-1], device=device)[None, None, :]
    bits = hash_bits_at(rows % bm, cols, seed, rows // bm,
                        slot_salt.long()[:, None, None])
    return bits_to_uniform(bits)


def _term(q, inv, den, vd, salt, *, activation: str, n_max: int,
          seed: int, bm: int = HASH_BM):
    """counts * weight of n tile steps: q (n, M, w), inv / den (n, 1, w),
    vd and the hash's tile salts (n,). The stochastic bit is weighted by
    the valid-column mask (inv > 0), every other count by den."""
    vd = vd[:, None, None]
    if activation == "stochastic":
        u = _uniform(q.shape, q.shape[1], salt, seed, q.device, bm)
        return _epilogue(q, vd, activation, n_max, u) \
            * (inv > 0).to(torch.float32)
    return _epilogue(q, vd, activation, n_max) * den


def cim_runs_plain(x, gd_tiles, inv_norm_tiles, denorm_tiles, v_decr_tiles,
                   in_index, run_start, col_run_start, col_runs, *,
                   tile_index=None, n_run_ranks: int, n_run_len: int,
                   activation: str, n_max: int, v_read: float,
                   seed: int = 0, bm: int = HASH_BM):
    """The plain PyTorch version of all three kernels: vectorised over
    output column blocks, looping over run rank and slot rank, so each
    block sums every run's slots from zero in slot order and folds the
    runs in run order, as the kernels do. tile_index (transposed plans):
    slot -> stack position, the tile is read transposed and j of the hash
    is its stack position; bm the stochastic neuron's hash block. Returns
    (M, n_col_blocks * out_block)."""
    m = x.shape[0]
    transpose = tile_index is not None
    _, rows_s, cols_s = gd_tiles.shape
    width, out_w = (cols_s, rows_s) if transpose else (rows_s, cols_s)
    n_cb = col_run_start.shape[0] - 1
    n_in = int(in_index.max()) + 1 if in_index.numel() else 1
    xb = _x_blocks(x.to(torch.float64), max(n_in, -(-x.shape[1] // width)),
                   width)
    total = torch.zeros((n_cb, m, out_w), dtype=torch.float32,
                        device=x.device)
    part = total
    tables = (run_start, col_run_start, col_runs)
    for s, slot, valid, run_valid in _walk(tables, n_run_ranks, n_run_len):
        if s == 0:
            part = torch.zeros_like(total)
        q = _dot(xb, gd_tiles, in_index, slot, tile_index, transpose) \
            * v_read * inv_norm_tiles[slot]
        term = _term(q, inv_norm_tiles[slot], denorm_tiles[slot],
                     v_decr_tiles[slot],
                     tile_index[slot] if transpose else slot,
                     activation=activation, n_max=n_max, seed=seed, bm=bm)
        part = torch.where(valid[:, None, None], part + term, part)
        if s == n_run_len - 1:
            total = torch.where(run_valid[:, None, None], total + part,
                                total)
    return total.permute(1, 0, 2).reshape(m, n_cb * out_w)


def cim_terms_plain(x, gd_tiles, inv_norm_tiles, denorm_tiles, v_decr_tiles,
                    in_index, live_slots=None, *, activation: str,
                    n_max: int, v_read: float, seed: int = 0,
                    bm: int = HASH_BM):
    """The plain version of the split route's term pass (forward plans):
    terms[t] = counts * weight of tile t for every live slot t (None: every
    slot), each tile dot in FP64 rounded once to f32 as the kernels do.
    Returns (T, M, bn) f32, zero at idle slots (the kernel leaves them
    unwritten; nothing reads them)."""
    n_tiles, bk, bn = gd_tiles.shape
    live = (torch.arange(n_tiles, device=x.device) if live_slots is None
            else live_slots.long())
    n_in = int(in_index.max()) + 1 if in_index.numel() else 1
    xb = _x_blocks(x.to(torch.float64), max(n_in, -(-x.shape[1] // bk)), bk)
    terms = torch.zeros((n_tiles, x.shape[0], bn), dtype=torch.float32,
                        device=x.device)
    if live.numel():
        q = _dot(xb, gd_tiles, in_index, live, None, False) * v_read \
            * inv_norm_tiles[live]
        terms[live] = _term(q, inv_norm_tiles[live], denorm_tiles[live],
                            v_decr_tiles[live], live, activation=activation,
                            n_max=n_max, seed=seed, bm=bm)
    return terms


def cim_fold_plain(terms, run_start, col_run_start, col_runs, *,
                   n_run_ranks: int, n_run_len: int):
    """The plain version of the split route's fold: for each output column
    block, each live run's terms summed from zero in slot order, the runs
    folded from zero in run order (the walk's order, vectorised over
    column blocks). terms: (T, M, bn). Returns (M, n_cb * bn)."""
    _, m, bn = terms.shape
    n_cb = col_run_start.shape[0] - 1
    total = torch.zeros((n_cb, m, bn), dtype=torch.float32,
                        device=terms.device)
    part = total
    tables = (run_start, col_run_start, col_runs)
    for s, slot, valid, run_valid in _walk(tables, n_run_ranks, n_run_len):
        if s == 0:
            part = torch.zeros_like(total)
        part = torch.where(valid[:, None, None], part + terms[slot], part)
        if s == n_run_len - 1:
            total = torch.where(run_valid[:, None, None], total + part,
                                total)
    return total.permute(1, 0, 2).reshape(m, n_cb * bn)


def boundary_counts(x, gd_tiles, inv_norm_tiles, v_decr_tiles, in_index,
                    run_start, col_run_start, col_runs, *, tile_index=None,
                    n_run_ranks: int, n_run_len: int, v_read: float,
                    activation: str = "none", n_max: int = 127,
                    seed: int = 0, bm: int = HASH_BM):
    """For each output element, how many of its tiles sit where two
    correct f32 executions of the same dot may decide differently.

    q is taken in float64; its band is the forward error bound of an f32
    dot of `width` terms followed by the two scalings, doubled because
    both executions err: 2 * (width + 2) * 2^-24 * (|x| @ |gd|) * v_read
    * |inv| — wide enough for an f32 summation in any order (the
    reference's), of which the port's exact dot is one. A count is near
    when |q| / v_decr lies within band / v_decr of a .5 boundary; a
    stochastic bit when |q + u * v_decr * n_max| lies within the band plus
    one rounding of the noise term. Returns int32 (M, n_cb * out_block)."""
    m = x.shape[0]
    transpose = tile_index is not None
    _, rows_s, cols_s = gd_tiles.shape
    width, out_w = (cols_s, rows_s) if transpose else (rows_s, cols_s)
    n_cb = col_run_start.shape[0] - 1
    n_in = int(in_index.max()) + 1 if in_index.numel() else 1
    xb = _x_blocks(x.double(), max(n_in, -(-x.shape[1] // width)), width)
    hits = torch.zeros((n_cb, m, out_w), dtype=torch.int32, device=x.device)
    u32 = 2.0 ** -24
    tables = (run_start, col_run_start, col_runs)
    for _, slot, valid, _ in _walk(tables, n_run_ranks, n_run_len):
        g = gd_tiles[tile_index[slot].long() if transpose else slot].double()
        if transpose:
            g = g.transpose(1, 2)
        xr = xb[in_index[slot].long()]
        inv = inv_norm_tiles[slot].double()
        vd = v_decr_tiles[slot].double()[:, None, None]
        q = torch.bmm(xr, g) * v_read * inv
        band = 2 * (width + 2) * u32 * torch.bmm(xr.abs(), g.abs()) \
            * v_read * inv.abs()
        if activation == "stochastic":
            salt = tile_index[slot] if transpose else slot
            u = _uniform(q.shape, m, salt, seed, x.device, bm).double()
            noise = (u * 2.0 - 1.0) * (vd * n_max)
            near = (q + noise).abs() <= band + 2 * u32 * noise.abs()
        else:
            v = q.abs() / vd
            near = (v - (torch.floor(v) + 0.5)).abs() <= band / vd
        hits += (near & valid[:, None, None]).to(torch.int32)
    return hits.permute(1, 0, 2).reshape(m, n_cb * out_w)


def matrix_boundary_counts(x, gd, inv_norm, v_decr, *, v_read: float,
                           activation: str = "none", n_max: int = 127,
                           seed: int = 0, bm_ref: int = HASH_BM,
                           bn_ref: int = HASH_BM):
    """`boundary_counts` of the single-matrix kernel: for each output, 1
    where two correct f32 executions of its K-term dot (the reference's
    blocked f32 sum, the port's exact one) may decide differently, else 0.
    The band is 2 * (K + 2) * 2^-24 * (|x| @ |gd|) * v_read * |inv|.
    Returns int32 (M, N)."""
    u32 = 2.0 ** -24
    xd, gdd = x.double(), gd.double()
    inv = inv_norm.double()
    vd = torch.as_tensor(v_decr).double()
    q = xd @ gdd * v_read * inv
    band = 2 * (gd.shape[0] + 2) * u32 * (xd.abs() @ gdd.abs()) * v_read \
        * inv.abs()
    if activation == "stochastic":
        u = matrix_uniform(q.shape[0], q.shape[1], seed, bm_ref, bn_ref,
                           x.device).double()
        noise = (u * 2.0 - 1.0) * (vd * n_max)
        near = (q + noise).abs() <= band + 2 * u32 * noise.abs()
    else:
        v = q.abs() / vd
        near = (v - (torch.floor(v) + 0.5)).abs() <= band / vd
    return near.to(torch.int32)


# ------------------------------------------------------------- CUDA kernels

class Epilogue(ctypes.Structure):
    """The kernels' `Epilogue` (csrc/cim_epilogue.cuh), field for field."""
    _fields_ = [("act", ctypes.c_int), ("v_read", ctypes.c_float),
                ("n_max", ctypes.c_float), ("n_max4", ctypes.c_float),
                ("k0", ctypes.c_float), ("k1", ctypes.c_float),
                ("k2", ctypes.c_float), ("st0", ctypes.c_float),
                ("st1", ctypes.c_float), ("st2", ctypes.c_float),
                ("seed", ctypes.c_uint32), ("bm_ref", ctypes.c_int)]


class MvmArgs(ctypes.Structure):
    """The single-matrix kernel's arguments (csrc/cim_mvm.cu `Args`)."""
    _p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _fields_ = [("x", _p), ("M", _i), ("K", _i), ("Kx", _i), ("N", _i),
                ("gd", _p), ("inv_norm", _p), ("v_decr", _p),
                ("bn_ref", _i), ("out", _p), ("partial", _p),
                ("arrived", _p), ("in_alpha", _p), ("bias", _p),
                ("levels", _f), ("inv_levels", _f), ("off_counts", _p),
                ("norm", _p), ("w_max", _p), ("inv_out_div", _f)]


@functools.lru_cache(maxsize=None)
def _f32_inverse(v: float) -> float:
    """1 / v in f32, as PyTorch's CUDA division by a Python scalar forms
    it (the reciprocal of the f32 scalar, then a multiply)."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one / torch.tensor(v, dtype=torch.float32))


def _epilogue_args(activation: str, n_max: int, v_read: float, seed: int,
                   bm_ref: int) -> Epilogue:
    return Epilogue(ACTIVATIONS[activation], v_read, float(n_max),
                    4.0 * n_max, *pwl_knots(n_max), int(seed) & 0xFFFFFFFF,
                    bm_ref)


def load() -> Dict[str, ctypes.CDLL]:
    """Build (at first use) and bind every CIM kernel's C entry points;
    checks each kernel's shared memory against the verifier's model."""
    if _lib:
        return _lib
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name in KERNELS:
        lib = _build.library(name)
        launch = getattr(lib, f"{name}_launch")
        launch.restype = i
        smem = getattr(lib, f"{name}_shared_bytes")
        smem.restype = i
        if name == "cim_mvm":
            # args, geometry, epilogue, fused, grid, stream
            launch.argtypes = [ctypes.POINTER(MvmArgs),
                               ctypes.POINTER(MvmGeometry),
                               ctypes.POINTER(Epilogue), i, i, p]
            occ = lib.cim_mvm_occupancy      # geometry, k_x, fused
            occ.argtypes, occ.restype = [ctypes.POINTER(MvmGeometry), i,
                                         i], i
            smem.argtypes = [ctypes.POINTER(MvmGeometry), i]
            for m, k, n in _MVM_CHECK_SHAPES:
                for k_x in (k, k - 1):
                    g = mvm_geometry(m, k, n, k_x, occupancy=one_block,
                                     n_sm=H100_SMS)
                    if smem(ctypes.byref(g), k_x) != \
                            mvm_shared_bytes(g, k_x):
                        raise RuntimeError(
                            f"cim_mvm requests {smem(ctypes.byref(g), k_x)}"
                            f" B of shared memory at m={m}, k={k}, k_x="
                            f"{k_x}, n={n}, the verifier assumes "
                            f"{mvm_shared_bytes(g, k_x)} B")
            libs[name] = lib
            continue
        # the walk: args, geometry, epilogue, grid, stream
        trans = name == "cim_mvm_transposed"
        launch.argtypes = [ctypes.POINTER(WalkArgs),
                           ctypes.POINTER(WalkGeometry),
                           ctypes.POINTER(Epilogue), i, p]
        occ = getattr(lib, f"{name}_occupancy")       # geometry
        occ.argtypes, occ.restype = [ctypes.POINTER(WalkGeometry)], i
        smem.argtypes = [ctypes.POINTER(WalkGeometry)]
        for m, bk, bn, n_cb in (_WALK_CHECK_SHAPES_T if trans
                                else _WALK_CHECK_SHAPES):
            g = walk_geometry(m, bk, bn, n_cb, trans=trans)
            if smem(ctypes.byref(g)) != walk_shared_bytes(g):
                raise RuntimeError(
                    f"{name}'s walk requests {smem(ctypes.byref(g))} B of "
                    f"shared memory at {g.as_dict()}, the verifier assumes "
                    f"{walk_shared_bytes(g)} B")
        if name in SPLIT_KERNELS:
            # x, M, K, gd, inv_norm, denorm, v_decr, row_block, run_start,
            # col_run_start, col_runs, live, n_live, n_col_blocks, bk, bn,
            # terms, out, epilogue, bm, stream
            split = getattr(lib, f"{name}_split_launch")
            split.argtypes = ([p, i, i] + [p] * 9 + [i, i, i, i, p, p,
                                                     ctypes.POINTER(Epilogue),
                                                     i, p])
            split.restype = i
            smem = getattr(lib, f"{name}_split_shared_bytes")
            smem.argtypes, smem.restype = [i, i, i], i
            for bm in SPLIT_ROWS:
                for bk, bn in ((128, 256), (128, 47), (40, 30)):
                    if smem(bm, bk, bn) != split_shared_bytes(bm, bk, bn):
                        raise RuntimeError(
                            f"{name}'s split route requests "
                            f"{smem(bm, bk, bn)} B of shared memory at bm="
                            f"{bm}, bk={bk}, bn={bn}, the verifier assumes "
                            f"{split_shared_bytes(bm, bk, bn)} B")
        libs[name] = lib
    _lib.update(libs)
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_args(activation: str, impl: str):
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")


def _check_plan(x, gd_tiles, tile_tensors, index_tensors, out_w: int):
    """Check x and a plan's tensors as a launch takes them: tile_tensors
    (inv_norm, denorm, v_decr), index_tensors int32 tables (None: absent)."""
    n_tiles = gd_tiles.shape[0]
    dev, f32, i32 = x.device, torch.float32, torch.int32
    inv, den, vd = tile_tensors
    _check("x", x, f32, tuple(x.shape), dev)
    _check("gd_tiles", gd_tiles, f32, tuple(gd_tiles.shape), dev)
    _check("inv_norm_tiles", inv, f32, (n_tiles, 1, out_w), dev)
    _check("denorm_tiles", den, f32, (n_tiles, 1, out_w), dev)
    _check("v_decr_tiles", vd, f32, (n_tiles,), dev)
    for j, t in enumerate(index_tensors):
        if t is not None:
            _check(f"index table {j}", t, i32, tuple(t.shape), dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _walk_plan(kernel: str, m: int, bk: int, bn: int, n_cb: int,
               index: int, layout: Optional[int] = None):
    """walk_launch_geometry on card `index`, memoized: it depends on the
    shape and the pinned layout alone."""
    lib = load()[kernel]
    with torch.cuda.device(index):
        n_sm = torch.cuda.get_device_properties(index).multi_processor_count
        g = walk_geometry(m, bk, bn, n_cb, n_sm=n_sm,
                          trans=kernel == "cim_mvm_transposed",
                          layout=layout)
        blocks = getattr(lib, f"{kernel}_occupancy")(ctypes.byref(g))
    if blocks < 1:
        raise RuntimeError(f"{kernel}'s walk cannot launch geometry "
                           f"{g.as_dict()}: occupancy {blocks}")
    return g, min(g.n_items, n_sm * blocks)


def walk_launch_geometry(kernel: str, m: int, bk: int, bn: int, n_cb: int,
                         device, layout: Optional[int] = None):
    """The walk's tiling and persistent grid for an m-row launch of
    `kernel` over a plan of tiles contracting bk inputs into bn outputs
    and n_cb column blocks on CUDA `device`: `walk_geometry` for the
    card's SMs (transposed for the transposed kernel), the grid the
    runtime's resident blocks per SM times the SMs, at most one block per
    item. layout pins the item layout (None: the rule's)."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    return _walk_plan(kernel, m, bk, bn, n_cb, index, layout)


def launch_walk(kernel: str, x, gd_tiles, tile_tensors, index_tensors,
                n_cb: int, in_w: int, out_w: int, *, activation, n_max,
                v_read, seed, bm: int = HASH_BM,
                layout: Optional[int] = None):
    """Check the plan's tensors, allocate the output and launch `kernel`'s
    walk once on the current stream (the transposed kernel's only route;
    the packed and scheduled kernels' above the split route's edge, and
    at any M for a caller that asks for it). tile_tensors: (inv_norm,
    denorm, v_decr); index_tensors: the int32 tables in the C entry
    point's order (packed: row_index, col_start; scheduled: row_index,
    run_start, col_run_start, col_runs; transposed: in_index, tile_index,
    run_start, col_run_start, col_runs); in_w / out_w: a tile's inputs
    and outputs (transposed: its stored columns and rows); bm the
    stochastic neuron's hash block; layout pins the walk's item layout."""
    if x.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {x.device}")
    _check_plan(x, gd_tiles, tile_tensors, index_tensors, out_w)
    m, k = x.shape
    dev = x.device
    inv, den, vd = tile_tensors
    out = torch.empty((m, n_cb * out_w), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    with torch.cuda.device(dev):    # a shard's chip may lie on another card
        lib = load()[kernel]
        epi = _epilogue_args(activation, n_max, v_read, seed, min(bm, m))
        g, grid = walk_launch_geometry(kernel, m, in_w, out_w, n_cb, dev,
                                       layout)
        if kernel == "cim_mvm_transposed":
            row_index, tile_slot, *runs = index_tensors
        else:
            (row_index, *runs), tile_slot = index_tensors, None
        run_start, col_run_start, col_runs = (runs + [None, None])[:3]
        # the walk reads x as int8: exact for the integer inputs it takes
        # (|x| <= 127), a quarter of the bytes its items re-read
        x8 = x.to(torch.int8)
        args = WalkArgs(x8.data_ptr(), m, k, gd_tiles.data_ptr(),
                        inv.data_ptr(), den.data_ptr(), vd.data_ptr(),
                        row_index.data_ptr(), _ptr(tile_slot),
                        run_start.data_ptr(), _ptr(col_run_start),
                        _ptr(col_runs), gd_tiles.shape[0], n_cb, in_w, out_w,
                        out.data_ptr())
        err = getattr(lib, f"{kernel}_launch")(
            ctypes.byref(args), ctypes.byref(g), ctypes.byref(epi), grid,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
    return out


def launch_split(kernel: str, x, gd_tiles, tile_tensors, row_index,
                 run_tables, live_slots, n_cb: int, *, activation, n_max,
                 v_read, seed, bm: int = HASH_BM):
    """Check the plan's tensors, allocate the term scratch and the output,
    and launch `kernel`'s split route (M <= 16) on the current stream: the
    term pass over the live slots (live_slots None: every slot), then the
    fold. run_tables: (run_start, col_run_start, col_runs); the packed
    kernel passes (col_start, None, None), one run per column block."""
    if x.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {x.device}")
    m, k = x.shape
    if not split_route(m):
        raise ValueError(f"the split route takes at most {SPLIT_ROWS[-1]} "
                         f"rows, x has {m}")
    n_tiles, bk, bn = gd_tiles.shape
    _check_plan(x, gd_tiles, tile_tensors, (row_index, live_slots,
                                            *run_tables), bn)
    inv, den, vd = tile_tensors
    lib = load()[kernel]
    dev, f32 = x.device, torch.float32
    out = torch.empty((m, n_cb * bn), dtype=f32, device=dev)
    if m == 0:
        return out
    terms = torch.empty((n_tiles, m, bn), dtype=f32, device=dev)
    n_live = n_tiles if live_slots is None else live_slots.numel()
    epi = _epilogue_args(activation, n_max, v_read, seed, min(bm, m))
    with torch.cuda.device(dev):    # a shard's chip may lie on another card
        err = getattr(lib, f"{kernel}_split_launch")(
            x.data_ptr(), m, k, gd_tiles.data_ptr(), inv.data_ptr(),
            den.data_ptr(), vd.data_ptr(), row_index.data_ptr(),
            *(_ptr(t) for t in run_tables), _ptr(live_slots), n_live, n_cb,
            bk, bn, terms.data_ptr(), out.data_ptr(), ctypes.byref(epi),
            split_rows(m), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} split launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
    return out


def cim_mvm_packed(x, gd_tiles, inv_norm_tiles, denorm_tiles, v_decr_tiles,
                   row_index, col_start, *, n_row_blocks: int, n_ranks: int,
                   activation: str = "none", n_max: int = 127,
                   v_read: float = 0.5, seed: int = 0, bm: int = HASH_BM,
                   route: Optional[Route] = None, impl: str = "auto"):
    """Whole-layer packed CIM MVM of a single-pass plan: ONE launch (the
    split route's two kernels at M <= 16, the walk above).

    x: (M, K) f32 integer-valued activations; gd_tiles: (T, bk, bn);
    inv_norm_tiles / denorm_tiles: (T, 1, bn); v_decr_tiles: (T,);
    row_index: (T,) int32 input block per slot; col_start: (n_cb + 1,)
    int32 CSR offsets of each output column block's slots. n_row_blocks /
    n_ranks: static plan geometry (input blocks; most tiles in one column
    block). seed / bm: the stochastic neuron's salt and hash block. route:
    pins the launch route (None: `split_route`'s rule). Returns (M, n_cb
    * bn).

    impl: "auto" runs the plain version on a CPU tensor and launches the
    kernel on a CUDA tensor; "plain" forces the plain version (on-card
    comparison only).
    """
    _check_args(activation, impl)
    if col_start is None:
        raise ValueError("col_block is not non-decreasing: the packed "
                         "kernel needs each column block's tiles in one "
                         "contiguous slot range (a single-pass plan)")
    if impl == "plain" or x.device.type == "cpu":
        # the run walk with one run per column block: the same sums in the
        # same order
        n_cb = col_start.shape[0] - 1
        ar = torch.arange(n_cb + 1, dtype=torch.int32, device=x.device)
        return cim_runs_plain(
            x, gd_tiles, inv_norm_tiles, denorm_tiles, v_decr_tiles,
            row_index, col_start, ar, ar[:-1], n_run_ranks=1,
            n_run_len=n_ranks, activation=activation, n_max=n_max,
            v_read=v_read, seed=seed, bm=bm)
    _, bk, bn = gd_tiles.shape
    if x.shape[1] > n_row_blocks * bk:
        raise ValueError(f"x has {x.shape[1]} features, the plan covers "
                         f"{n_row_blocks * bk}")
    kw = dict(activation=activation, n_max=n_max, v_read=v_read, seed=seed,
              bm=bm)
    tiles = (inv_norm_tiles, denorm_tiles, v_decr_tiles)
    n_cb = col_start.shape[0] - 1
    if _takes_split("cim_mvm_packed", x.shape[0], route):
        return launch_split("cim_mvm_packed", x, gd_tiles, tiles, row_index,
                            (col_start, None, None), None, n_cb, **kw)
    return launch_walk("cim_mvm_packed", x, gd_tiles, tiles,
                       (row_index, col_start), n_cb, bk, bn,
                       layout=route and route.layout, **kw)


def cim_mvm_scheduled(x, gd_tiles, inv_norm_tiles, denorm_tiles,
                      v_decr_tiles, row_index, run_start, col_run_start,
                      col_runs, live_slots, *, n_run_ranks: int,
                      n_run_len: int, activation: str = "none",
                      n_max: int = 127, v_read: float = 0.5, seed: int = 0,
                      bm: int = HASH_BM, route: Optional[Route] = None,
                      impl: str = "auto"):
    """Whole-layer scheduled CIM MVM of a merged-core plan: ONE launch (the
    split route's two kernels at M <= 16, the walk above).

    Tensors as `cim_mvm_packed` over the pass-major fused slot order, plus
    the run tables: run_start (n_runs + 1,) CSR slots of each run;
    col_run_start (n_cb + 1,) / col_runs: each column block's live runs
    in run order; live_slots: the slots of live runs, in slot order (the
    split route's term blocks). n_run_ranks / n_run_len: the most live
    runs of one column block and the most slots of one run (the plain
    version's loops). bm and route as `cim_mvm_packed`. Returns (M, n_cb *
    bn)."""
    _check_args(activation, impl)
    tables = (run_start, col_run_start, col_runs)
    kw = dict(activation=activation, n_max=n_max, v_read=v_read, seed=seed,
              bm=bm)
    if impl == "plain" or x.device.type == "cpu":
        return cim_runs_plain(x, gd_tiles, inv_norm_tiles, denorm_tiles,
                              v_decr_tiles, row_index, *tables,
                              n_run_ranks=n_run_ranks, n_run_len=n_run_len,
                              **kw)
    _, bk, bn = gd_tiles.shape
    tiles = (inv_norm_tiles, denorm_tiles, v_decr_tiles)
    n_cb = col_run_start.shape[0] - 1
    if _takes_split("cim_mvm_scheduled", x.shape[0], route):
        return launch_split("cim_mvm_scheduled", x, gd_tiles, tiles,
                            row_index, tables, live_slots, n_cb, **kw)
    return launch_walk("cim_mvm_scheduled", x, gd_tiles, tiles,
                       (row_index, *tables), n_cb, bk, bn,
                       layout=route and route.layout, **kw)


def cim_mvm_transposed(x, gd_tiles, inv_norm_tiles, denorm_tiles,
                       v_decr_tiles, in_index, tile_index, run_start,
                       col_run_start, col_runs, *, n_run_ranks: int,
                       n_run_len: int, activation: str = "none",
                       n_max: int = 127, v_read: float = 0.5, seed: int = 0,
                       bm: int = HASH_BM, route: Optional[Route] = None,
                       impl: str = "auto"):
    """Whole-layer transpose-direction CIM MVM: ONE launch of the walk over
    the shared forward stack gd_tiles (T, bk_f, bn_f), never copied or
    transposed.

    x: (M, K') over the forward COLUMNS; inv_norm_tiles / denorm_tiles:
    (T, 1, bk_f) per-row tensors in this direction's slot order; in_index:
    (T,) forward column block per slot; tile_index: (T,) slot -> stack
    position; run tables as `cim_mvm_scheduled`, over forward row blocks;
    bm as `cim_mvm_packed`, route a walk layout (the walk is the only
    route). Returns (M, n_cb * bk_f)."""
    _check_args(activation, impl)
    tables = (run_start, col_run_start, col_runs)
    kw = dict(activation=activation, n_max=n_max, v_read=v_read, seed=seed,
              bm=bm)
    if impl == "plain" or x.device.type == "cpu":
        return cim_runs_plain(x, gd_tiles, inv_norm_tiles, denorm_tiles,
                              v_decr_tiles, in_index, *tables,
                              tile_index=tile_index, n_run_ranks=n_run_ranks,
                              n_run_len=n_run_len, **kw)
    _takes_split("cim_mvm_transposed", x.shape[0], route)
    _, bk_f, bn_f = gd_tiles.shape
    return launch_walk("cim_mvm_transposed", x, gd_tiles,
                       (inv_norm_tiles, denorm_tiles, v_decr_tiles),
                       (in_index, tile_index, *tables),
                       col_run_start.shape[0] - 1, bn_f, bk_f,
                       layout=route and route.layout, **kw)


@functools.lru_cache(maxsize=None)
def _launch_plan(m: int, k: int, n: int, k_x: int, fused: bool,
                 index: int):
    """mvm_launch_geometry on card `index`, memoized: it depends on the
    shape alone."""
    lib = load()["cim_mvm"]
    with torch.cuda.device(index):
        n_sm = torch.cuda.get_device_properties(index).multi_processor_count

        def occupancy(g, kx):
            blocks = lib.cim_mvm_occupancy(ctypes.byref(g), kx, int(fused))
            if blocks < 0:
                raise RuntimeError(f"cim_mvm occupancy query failed: CUDA "
                                   f"error {-blocks}")
            return blocks
        g = mvm_geometry(m, k, n, k_x, occupancy=occupancy, n_sm=n_sm)
        blocks = occupancy(g, k_x)
    if blocks < 1:
        raise RuntimeError(f"cim_mvm cannot launch geometry {g.as_dict()}: "
                           f"no block of it fits an SM")
    return g, min(g.n_ct * g.n_rc * g.n_ks, n_sm * blocks)


def mvm_launch_geometry(m: int, k: int, n: int, k_x: int, fused: bool,
                        device):
    """The tiling and the persistent grid of the single-matrix kernel's
    (m, k) x (k, n) launch (x of k_x columns; fused: the forward's entry)
    on CUDA `device`: `mvm_geometry` ranked by the runtime's occupancy of
    each candidate, the grid its blocks per SM times the SMs, at most one
    block per work item."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    return _launch_plan(m, k, n, k_x, bool(fused), index)


def _launch_mvm(args: MvmArgs, x, k: int, n: int, epi: Epilogue,
                fused: bool):
    """Allocate the output (and the K splits' zeroed scratch) of an (M, k)
    x (k, n) launch on x's card and launch the single-matrix kernel once on
    the current stream."""
    m, k_x = x.shape
    dev = x.device
    lib = load()["cim_mvm"]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    g, grid = mvm_launch_geometry(m, k, n, k_x, fused, dev)
    scratch = None
    if g.n_ks > 1:
        # (m, n) FP64 partial sums, then n_ct * n_rc int32 counters
        words = m * n + _cdiv(g.n_ct * g.n_rc, 2)
        scratch = torch.zeros(words, dtype=torch.float64, device=dev)
        args.partial = scratch.data_ptr()
        args.arrived = scratch.data_ptr() + m * n * 8
    args.x, args.M, args.K, args.Kx, args.N = x.data_ptr(), m, k, k_x, n
    args.out = out.data_ptr()
    err = lib.cim_mvm_launch(ctypes.byref(args), ctypes.byref(g),
                             ctypes.byref(epi), int(fused), grid,
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cim_mvm launch failed: CUDA error {err} "
                           f"(geometry {g.as_dict()}, grid {grid})")
    LAUNCHES["cim_mvm"] += 1
    return out


def _ref_block(m: int, n: int, block):
    return max(min(block[0], m), 1), max(min(block[2], n), 1)


def cim_mvm(x, gd, inv_norm, v_decr, *, activation: str = "none",
            n_max: int = 127, v_read: float = 0.5, seed: int = 0,
            block=REF_BLOCK, impl: str = "auto"):
    """Single-matrix CIM MVM: ONE launch.

    x: (M, K) f32 integer-valued activations; gd: (K, N) f32 G+ - G-;
    inv_norm: (N,) f32; v_decr: 0-d f32 ADC step (read on the device);
    seed: the stochastic neuron's salt; block: the reference's (bm, bk,
    bn), which keys the stochastic draws (bm_ref = min(bm, M), bn_ref =
    min(bn, N)). Returns (M, N) f32 counts (the raw charge for
    'identity').

    impl: "auto" runs the plain version on a CPU tensor and launches the
    kernel on a CUDA tensor; "plain" forces the plain version (on-card
    comparison only).
    """
    _check_args(activation, impl)
    m, k = x.shape
    if gd.shape[0] != k:
        raise ValueError(f"x has {k} features, gd has {gd.shape[0]} rows")
    n = gd.shape[1]
    bm_ref, bn_ref = _ref_block(m, n, block)
    kw = dict(activation=activation, n_max=n_max, v_read=v_read, seed=seed)
    if impl == "plain" or x.device.type == "cpu":
        return cim_mvm_plain(x, gd, inv_norm, v_decr, bm_ref=bm_ref,
                             bn_ref=bn_ref, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no cim_mvm kernel for device {x.device}")
    dev, f32 = x.device, torch.float32
    _check("x", x, f32, (m, k), dev)
    _check("gd", gd, f32, (k, n), dev)
    _check("inv_norm", inv_norm, f32, (n,), dev)
    _check("v_decr", v_decr, f32, (), dev)
    args = MvmArgs(gd=gd.data_ptr(), inv_norm=inv_norm.data_ptr(),
                   v_decr=v_decr.data_ptr(), bn_ref=bn_ref)
    epi = _epilogue_args(activation, n_max, v_read, seed, bm_ref)
    return _launch_mvm(args, x, k, n, epi, fused=False)


def cim_forward(x, gd, inv_norm, v_decr, off_counts, norm, w_max, in_alpha,
                cfg, *, bias=None, bias_rows: int = 0, impl: str = "auto"):
    """The per-matrix forward in ONE launch of the single-matrix kernel,
    under `cfg` (a CIMConfig): float x (M, K - bias_rows) quantized on
    load (bias_rows more columns hold `bias`), the dot against gd (K, N),
    the ADC epilogue, offset cancellation (off_counts (N,), activation
    'none') and the dequantization by v_decr, norm (N,), w_max and the
    input scale of in_alpha (0-d each). Returns (M, N) f32 in x @ W units
    (neuron units for tanh / sigmoid). The stochastic neuron is not taken
    (the reference's forward needs its oracle for it).

    impl: "auto" runs the plain version (`cim_forward_plain`) on a CPU
    tensor and launches the kernel on a CUDA tensor; "plain" forces the
    plain version (on-card comparison only)."""
    act = cfg.activation
    _check_args(act, impl)
    if act == "stochastic":
        raise ValueError("the fused forward does not take the stochastic "
                         "neuron")
    m, k_x = x.shape
    k, n = gd.shape
    if k_x + bias_rows != k:
        raise ValueError(f"x has {k_x} features and {bias_rows} bias rows, "
                         f"gd has {k} rows")
    tensors = (gd, inv_norm, v_decr, off_counts, norm, w_max, in_alpha)
    if impl == "plain" or x.device.type == "cpu":
        return cim_forward_plain(x, *tensors, cfg, bias, bias_rows=bias_rows)
    if x.device.type != "cuda":
        raise ValueError(f"no cim_mvm kernel for device {x.device}")
    dev, f32 = x.device, torch.float32
    if bias is None:
        bias = in_alpha
    for name, t, shape in (("x", x, (m, k_x)), ("gd", gd, (k, n)),
                           ("inv_norm", inv_norm, (n,)),
                           ("v_decr", v_decr, ()),
                           ("off_counts", off_counts, (n,)),
                           ("norm", norm, (n,)), ("w_max", w_max, ()),
                           ("in_alpha", in_alpha, ()), ("bias", bias, ())):
        _check(name, t, f32, shape, dev)
    levels = max((1 << (cfg.in_bits - 1)) - 1, 1)   # quantize_to_int's n
    # the hash block and seed: read only by the stochastic neuron
    args = MvmArgs(gd=gd.data_ptr(), inv_norm=inv_norm.data_ptr(),
                   v_decr=v_decr.data_ptr(), bn_ref=1,
                   in_alpha=in_alpha.data_ptr(), bias=bias.data_ptr(),
                   levels=float(levels), inv_levels=_f32_inverse(levels),
                   off_counts=off_counts.data_ptr(), norm=norm.data_ptr(),
                   w_max=w_max.data_ptr(),
                   inv_out_div=_f32_inverse(cfg.v_read * cfg.device.g_max))
    epi = _epilogue_args(act, cfg.out_mag_levels, cfg.v_read, 0, 1)
    return _launch_mvm(args, x, k, n, epi, fused=True)
