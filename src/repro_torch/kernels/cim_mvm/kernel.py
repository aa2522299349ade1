"""The CIM MVM kernels: hand-written CUDA kernels for Hopper and their plain
PyTorch versions (port of `repro/kernels/cim_mvm/kernel.py`).

`cim_mvm` (replaces `cim_mvm_pallas`) runs ONE programmed matrix, the
per-matrix path of `core/cim.forward`: q = (x @ gd) * v_read * inv_norm,
then the epilogue, with the stochastic neuron hashed at the reference's
block-local coordinates (row % bm_ref, col % bn_ref) and salts (seed,
row // bm_ref, col // bn_ref) for the reference's block (bm_ref, bn_ref).

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
for the transposed kernel) and bm_ref = min(256, M), the reference's
default batch block.

The packed and scheduled kernels have two routes on the card, picked from
the batch rows M by `split_route`: at decode (M <= 16) the split route
(`csrc/cim_split.cuh`) computes every live tile's terms counts * weight in
parallel, one block per tile, into a scratch tensor, then folds each
output's terms in the order above (`cim_terms_plain` and `cim_fold_plain`
are its two kernels' plain versions); at prefill (M > 16) the walk, a block
per output column block walking its tiles in that order. Both are the
function of `cim_runs_plain`, bit for bit.

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
from typing import Dict

import torch

from .. import build as _build
from ..prng import bits_to_uniform, hash_bits_at

KERNELS = ("cim_mvm_packed", "cim_mvm_scheduled", "cim_mvm_transposed",
           "cim_mvm")
LAUNCHES = _build.LAUNCHES                 # kernel launches, per kernel

ACTIVATIONS = {"none": 0, "relu": 1, "tanh": 2, "sigmoid": 3, "identity": 4,
               "stochastic": 5}
K_CHUNK = 128         # x columns staged per shared-memory pass (forward)
T_CHUNK = 32          # tile columns staged per pass (transposed kernel)
THREADS = 128         # output columns per CUDA block
BLOCK_ROWS = (4, 32)  # the walk kernels' row blocks: M <= 4, and above
SPLIT_KERNELS = ("cim_mvm_packed", "cim_mvm_scheduled")
SPLIT_ROWS = (4, 16)  # the split route's row blocks (it takes M <= 16)
SPLIT_THREADS = 256   # most tile columns of the split route (one thread each)
SPLIT_CHUNK_ROWS = 16  # tile rows per bulk copy of the split route
SPLIT_STAGES = 3      # bulk copies in flight per term block
SPLIT_BARRIER_BYTES = 128  # the stages' mbarriers, padded
SMEM_LIMIT = 232_448  # shared memory a Hopper block can use, bytes
HASH_BM = 256         # the reference's default batch block (autotune.py)
REF_BLOCK = (256, 256, 256)   # the reference cim_mvm's default (bm, bk, bn)

_lib: Dict[str, ctypes.CDLL] = {}


def block_rows(m: int) -> int:
    """Rows of x per CUDA block: the smallest tiling that covers m, at
    most 32 (the kernel's register budget)."""
    return next((b for b in BLOCK_ROWS if b >= m), BLOCK_ROWS[-1])


def split_route(m: int) -> bool:
    """Whether a packed or scheduled launch of m rows takes the split route
    (term pass over the live tiles, then the fold) rather than the walk:
    m <= 16, decode. At m = 16 the term pass's FP64 multiply-adds on the
    CUDA cores take about 80% of the time its bytes take; above, prefill's
    FP64 work keeps the walk."""
    return m <= SPLIT_ROWS[-1]


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


def shared_bytes(kernel: str, bm: int) -> int:
    """Static shared memory of one walk block of `kernel` at `bm` rows: the
    staged x chunk, [chunk][bm + 2] doubles, and for the transposed kernel
    the staged tile chunk, [THREADS][T_CHUNK + 1] floats (checked against
    the built kernels' own attributes when the libraries load). The
    single-matrix `cim_mvm` stages x as the packed kernel does."""
    if kernel == "cim_mvm_transposed":
        return T_CHUNK * (bm + 2) * 8 + THREADS * (T_CHUNK + 1) * 4
    return K_CHUNK * (bm + 2) * 8


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


def _uniform(q_shape, m: int, slot_salt, seed: int, device):
    """The stochastic draws of one (n_cb, M, bn) step at the reference's
    hash coordinates (see the module docstring)."""
    bm = min(HASH_BM, m)
    rows = torch.arange(m, device=device)[None, :, None]
    cols = torch.arange(q_shape[-1], device=device)[None, None, :]
    bits = hash_bits_at(rows % bm, cols, seed, rows // bm,
                        slot_salt.long()[:, None, None])
    return bits_to_uniform(bits)


def _term(q, inv, den, vd, salt, *, activation: str, n_max: int,
          seed: int):
    """counts * weight of n tile steps: q (n, M, w), inv / den (n, 1, w),
    vd and the hash's tile salts (n,). The stochastic bit is weighted by
    the valid-column mask (inv > 0), every other count by den."""
    vd = vd[:, None, None]
    if activation == "stochastic":
        u = _uniform(q.shape, q.shape[1], salt, seed, q.device)
        return _epilogue(q, vd, activation, n_max, u) \
            * (inv > 0).to(torch.float32)
    return _epilogue(q, vd, activation, n_max) * den


def cim_runs_plain(x, gd_tiles, inv_norm_tiles, denorm_tiles, v_decr_tiles,
                   in_index, run_start, col_run_start, col_runs, *,
                   tile_index=None, n_run_ranks: int, n_run_len: int,
                   activation: str, n_max: int, v_read: float,
                   seed: int = 0):
    """The plain PyTorch version of all three kernels: vectorised over
    output column blocks, looping over run rank and slot rank, so each
    block sums every run's slots from zero in slot order and folds the
    runs in run order, as the kernels do. tile_index (transposed plans):
    slot -> stack position, the tile is read transposed and j of the hash
    is its stack position. Returns (M, n_col_blocks * out_block)."""
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
                     activation=activation, n_max=n_max, seed=seed)
        part = torch.where(valid[:, None, None], part + term, part)
        if s == n_run_len - 1:
            total = torch.where(run_valid[:, None, None], total + part,
                                total)
    return total.permute(1, 0, 2).reshape(m, n_cb * out_w)


def cim_terms_plain(x, gd_tiles, inv_norm_tiles, denorm_tiles, v_decr_tiles,
                    in_index, live_slots=None, *, activation: str,
                    n_max: int, v_read: float, seed: int = 0):
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
                            n_max=n_max, seed=seed)
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
                    seed: int = 0):
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
            u = _uniform(q.shape, m, salt, seed, x.device).double()
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


def _epilogue_args(activation: str, n_max: int, v_read: float, seed: int,
                   bm_ref: int) -> Epilogue:
    return Epilogue(ACTIVATIONS[activation], v_read, float(n_max),
                    4.0 * n_max, *pwl_knots(n_max), int(seed) & 0xFFFFFFFF,
                    bm_ref)


def load() -> Dict[str, ctypes.CDLL]:
    """Build (at first use) and bind every CIM kernel's C entry points;
    checks each kernel's static shared memory against the verifier's
    model."""
    if _lib:
        return _lib
    p, i = ctypes.c_void_p, ctypes.c_int
    n_tables = {"cim_mvm_packed": 2, "cim_mvm_scheduled": 4,
                "cim_mvm_transposed": 5}
    libs = {}
    for name in KERNELS:
        lib = _build.library(name)
        launch = getattr(lib, f"{name}_launch")
        if name == "cim_mvm":
            # x, M, K, gd, N, inv_norm, v_decr, bn_ref, out, epilogue, bm,
            # stream
            launch.argtypes = [p, i, i, p, i, p, p, i, p,
                               ctypes.POINTER(Epilogue), i, p]
        else:
            # x, M, K, gd, inv_norm, denorm, v_decr, the index tables,
            # n_col_blocks, in width, out width, out, epilogue, bm, stream
            launch.argtypes = ([p, i, i] + [p] * (4 + n_tables[name])
                               + [i, i, i, p, ctypes.POINTER(Epilogue), i, p])
        launch.restype = i
        smem = getattr(lib, f"{name}_shared_bytes")
        smem.argtypes, smem.restype = [i], i
        for bm in BLOCK_ROWS:        # the verifier's shared-memory model
            if smem(bm) != shared_bytes(name, bm):
                raise RuntimeError(
                    f"{name} uses {smem(bm)} B of shared memory at bm={bm}, "
                    f"the verifier assumes {shared_bytes(name, bm)} B")
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


def launch_walk(kernel: str, x, gd_tiles, tile_tensors, index_tensors,
                n_cb: int, in_w: int, out_w: int, *, activation, n_max,
                v_read, seed):
    """Check the plan's tensors, allocate the output and launch `kernel`'s
    walk once on the current stream (the transposed kernel's only route;
    the packed and scheduled kernels' at M > 16). tile_tensors: (inv_norm,
    denorm, v_decr); index_tensors: the int32 tables in the C entry
    point's order."""
    if x.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {x.device}")
    _check_plan(x, gd_tiles, tile_tensors, index_tensors, out_w)
    m, k = x.shape
    dev = x.device
    inv, den, vd = tile_tensors
    lib = load()[kernel]
    out = torch.empty((m, n_cb * out_w), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    epi = _epilogue_args(activation, n_max, v_read, seed, min(HASH_BM, m))
    err = getattr(lib, f"{kernel}_launch")(
        x.data_ptr(), m, k, gd_tiles.data_ptr(), inv.data_ptr(),
        den.data_ptr(), vd.data_ptr(), *(t.data_ptr() for t in index_tensors),
        n_cb, in_w, out_w, out.data_ptr(), ctypes.byref(epi), block_rows(m),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
    return out


def launch_split(kernel: str, x, gd_tiles, tile_tensors, row_index,
                 run_tables, live_slots, n_cb: int, *, activation, n_max,
                 v_read, seed):
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
    epi = _epilogue_args(activation, n_max, v_read, seed, min(HASH_BM, m))
    err = getattr(lib, f"{kernel}_split_launch")(
        x.data_ptr(), m, k, gd_tiles.data_ptr(), inv.data_ptr(),
        den.data_ptr(), vd.data_ptr(), row_index.data_ptr(),
        *(_ptr(t) for t in run_tables), _ptr(live_slots), n_live, n_cb, bk,
        bn, terms.data_ptr(), out.data_ptr(), ctypes.byref(epi),
        split_rows(m), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} split launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
    return out


def cim_mvm_packed(x, gd_tiles, inv_norm_tiles, denorm_tiles, v_decr_tiles,
                   row_index, col_start, *, n_row_blocks: int, n_ranks: int,
                   activation: str = "none", n_max: int = 127,
                   v_read: float = 0.5, seed: int = 0, impl: str = "auto"):
    """Whole-layer packed CIM MVM of a single-pass plan: ONE launch (the
    split route's two kernels at M <= 16, the walk above).

    x: (M, K) f32 integer-valued activations; gd_tiles: (T, bk, bn);
    inv_norm_tiles / denorm_tiles: (T, 1, bn); v_decr_tiles: (T,);
    row_index: (T,) int32 input block per slot; col_start: (n_cb + 1,)
    int32 CSR offsets of each output column block's slots. n_row_blocks /
    n_ranks: static plan geometry (input blocks; most tiles in one column
    block). seed: the stochastic neuron's salt. Returns (M, n_cb * bn).

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
            v_read=v_read, seed=seed)
    _, bk, bn = gd_tiles.shape
    if x.shape[1] > n_row_blocks * bk:
        raise ValueError(f"x has {x.shape[1]} features, the plan covers "
                         f"{n_row_blocks * bk}")
    kw = dict(activation=activation, n_max=n_max, v_read=v_read, seed=seed)
    tiles = (inv_norm_tiles, denorm_tiles, v_decr_tiles)
    n_cb = col_start.shape[0] - 1
    if split_route(x.shape[0]):
        return launch_split("cim_mvm_packed", x, gd_tiles, tiles, row_index,
                            (col_start, None, None), None, n_cb, **kw)
    return launch_walk("cim_mvm_packed", x, gd_tiles, tiles,
                       (row_index, col_start), n_cb, bk, bn, **kw)


def cim_mvm_scheduled(x, gd_tiles, inv_norm_tiles, denorm_tiles,
                      v_decr_tiles, row_index, run_start, col_run_start,
                      col_runs, live_slots, *, n_run_ranks: int,
                      n_run_len: int, activation: str = "none",
                      n_max: int = 127, v_read: float = 0.5, seed: int = 0,
                      impl: str = "auto"):
    """Whole-layer scheduled CIM MVM of a merged-core plan: ONE launch (the
    split route's two kernels at M <= 16, the walk above).

    Tensors as `cim_mvm_packed` over the pass-major fused slot order, plus
    the run tables: run_start (n_runs + 1,) CSR slots of each run;
    col_run_start (n_cb + 1,) / col_runs: each column block's live runs
    in run order; live_slots: the slots of live runs, in slot order (the
    split route's term blocks). n_run_ranks / n_run_len: the most live
    runs of one column block and the most slots of one run (the plain
    version's loops). Returns (M, n_cb * bn)."""
    _check_args(activation, impl)
    tables = (run_start, col_run_start, col_runs)
    kw = dict(activation=activation, n_max=n_max, v_read=v_read, seed=seed)
    if impl == "plain" or x.device.type == "cpu":
        return cim_runs_plain(x, gd_tiles, inv_norm_tiles, denorm_tiles,
                              v_decr_tiles, row_index, *tables,
                              n_run_ranks=n_run_ranks, n_run_len=n_run_len,
                              **kw)
    _, bk, bn = gd_tiles.shape
    tiles = (inv_norm_tiles, denorm_tiles, v_decr_tiles)
    n_cb = col_run_start.shape[0] - 1
    if split_route(x.shape[0]):
        return launch_split("cim_mvm_scheduled", x, gd_tiles, tiles,
                            row_index, tables, live_slots, n_cb, **kw)
    return launch_walk("cim_mvm_scheduled", x, gd_tiles, tiles,
                       (row_index, *tables), n_cb, bk, bn, **kw)


def cim_mvm_transposed(x, gd_tiles, inv_norm_tiles, denorm_tiles,
                       v_decr_tiles, in_index, tile_index, run_start,
                       col_run_start, col_runs, *, n_run_ranks: int,
                       n_run_len: int, activation: str = "none",
                       n_max: int = 127, v_read: float = 0.5, seed: int = 0,
                       impl: str = "auto"):
    """Whole-layer transpose-direction CIM MVM: ONE launch over the shared
    forward stack gd_tiles (T, bk_f, bn_f), never copied or transposed.

    x: (M, K') over the forward COLUMNS; inv_norm_tiles / denorm_tiles:
    (T, 1, bk_f) per-row tensors in this direction's slot order; in_index:
    (T,) forward column block per slot; tile_index: (T,) slot -> stack
    position; run tables as `cim_mvm_scheduled`, over forward row blocks.
    Returns (M, n_cb * bk_f)."""
    _check_args(activation, impl)
    tables = (run_start, col_run_start, col_runs)
    kw = dict(activation=activation, n_max=n_max, v_read=v_read, seed=seed)
    if impl == "plain" or x.device.type == "cpu":
        return cim_runs_plain(x, gd_tiles, inv_norm_tiles, denorm_tiles,
                              v_decr_tiles, in_index, *tables,
                              tile_index=tile_index, n_run_ranks=n_run_ranks,
                              n_run_len=n_run_len, **kw)
    _, bk_f, bn_f = gd_tiles.shape
    return launch_walk("cim_mvm_transposed", x, gd_tiles,
                        (inv_norm_tiles, denorm_tiles, v_decr_tiles),
                        (in_index, tile_index, *tables),
                        col_run_start.shape[0] - 1, bn_f, bk_f, **kw)


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
    bm_ref, bn_ref = max(min(block[0], m), 1), max(min(block[2], n), 1)
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
    lib = load()["cim_mvm"]
    out = torch.empty((m, n), dtype=f32, device=dev)
    if m == 0 or n == 0:
        return out
    epi = _epilogue_args(activation, n_max, v_read, seed, bm_ref)
    err = lib.cim_mvm_launch(
        x.data_ptr(), m, k, gd.data_ptr(), n, inv_norm.data_ptr(),
        v_decr.data_ptr(), bn_ref, out.data_ptr(), ctypes.byref(epi),
        block_rows(m), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cim_mvm launch failed: CUDA error {err}")
    LAUNCHES["cim_mvm"] += 1
    return out
