"""The packed whole-layer CIM MVM: a hand-written CUDA kernel for Hopper and
its plain PyTorch version (port of
`repro/kernels/cim_mvm/kernel.py::cim_mvm_packed_pallas`).

A single-pass tile plan (core/mapping.PackedPlan) executes as one launch:
for every tile t, in slot order,

    q      = x[:, row_block[t]] @ gd_tiles[t] * v_read * inv_norm[t]
    counts = epilogue(q)         ADC charge-decrement count + activation
    out[:, col_block[t]] += counts * denorm[t]

`cim_mvm_packed` is the wrapper: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (`csrc/cim_mvm_packed.cu`) or raises —
nothing falls back. The kernel is compiled with nvcc at first use into
`build/kernels/` and bound with ctypes (a plain C entry point, no torch
headers). `LAUNCHES` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

LAUNCHES = 0          # kernel launches made by `cim_mvm_packed`

ACTIVATIONS = {"none": 0, "relu": 1, "tanh": 2, "sigmoid": 3, "identity": 4}
K_CHUNK = 128         # x columns staged per shared-memory pass
BLOCK_ROWS = (4, 32)  # decode (M <= 4) and prefill row blocks
SMEM_LIMIT = 232_448  # shared memory a Hopper block can use, bytes

_SRC = Path(__file__).resolve().parent / "csrc" / "cim_mvm_packed.cu"
_REPO = Path(__file__).resolve().parents[4]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_lib = None


def block_rows(m: int) -> int:
    """Rows of x per CUDA block: the smallest tiling that covers m, at
    most 32 (the kernel's register budget)."""
    return next((b for b in BLOCK_ROWS if b >= m), BLOCK_ROWS[-1])


def shared_bytes(bm: int) -> int:
    """Static shared memory of one block at `bm` rows: the staged x chunk,
    [K_CHUNK][bm + 2] doubles (checked against the built kernel's own
    attribute when the library loads)."""
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


def _epilogue(q, vd, activation: str, n_max: int):
    """ADC epilogue of the reference kernel; vd broadcasts against q."""
    if activation == "identity":
        return q                   # raw charge passthrough (exact matmul)
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


def _rank_tiles(col_start, n_ranks: int):
    """(n_ranks, n_col_blocks) slot of each column block's r-th tile, and
    whether that tile exists (column blocks may hold unequal counts)."""
    start, end = col_start[:-1].long(), col_start[1:].long()
    r = torch.arange(n_ranks, device=col_start.device)[:, None]
    slot = start[None, :] + r
    return torch.minimum(slot, (end - 1).clamp(min=0)[None, :]), slot < end


def _x_blocks(x, n_row_blocks: int, bk: int):
    """(M, K) -> (n_row_blocks, M, bk), zero-padded at the ragged edge."""
    m, k = x.shape
    xp = torch.nn.functional.pad(x, (0, n_row_blocks * bk - k))
    return xp.reshape(m, n_row_blocks, bk).permute(1, 0, 2)


def cim_mvm_packed_plain(x, gd_tiles, inv_norm_tiles, denorm_tiles,
                         v_decr_tiles, row_index, col_start, *,
                         n_row_blocks: int, n_ranks: int, activation: str,
                         n_max: int, v_read: float):
    """The plain PyTorch version: vectorised over column blocks, looping
    over the row-split rank, so each column block folds its tiles left to
    right in slot order, as the kernel does. Each tile's dot is an FP64
    batched matmul rounded once to f32 — exact for integer x and
    conductance-difference tiles, so it is the kernel's dot bit for bit.
    Returns (M, n_col_blocks*bn)."""
    m = x.shape[0]
    _, bk, bn = gd_tiles.shape
    n_cb = col_start.shape[0] - 1
    xb = _x_blocks(x.to(torch.float64), n_row_blocks, bk)
    slots, valid = _rank_tiles(col_start, n_ranks)
    out = torch.zeros((n_cb, m, bn), dtype=torch.float32, device=x.device)
    for r in range(n_ranks):
        t = slots[r]
        dot = torch.bmm(xb[row_index[t].long()], gd_tiles[t].to(torch.float64))
        q = dot.to(torch.float32) * v_read * inv_norm_tiles[t]
        counts = _epilogue(q, v_decr_tiles[t][:, None, None], activation,
                           n_max)
        out = torch.where(valid[r][:, None, None],
                          out + counts * denorm_tiles[t], out)
    return out.permute(1, 0, 2).reshape(m, n_cb * bn)


def boundary_counts(x, gd_tiles, inv_norm_tiles, v_decr_tiles, row_index,
                    col_start, *, n_row_blocks: int, n_ranks: int,
                    v_read: float):
    """For each output element, how many of its tiles put |q|/v_decr
    within f32 rounding of a .5 boundary, where two correct f32
    executions of the same dot may round to different ADC counts.

    q is taken in float64. The band is the forward error bound of an f32
    dot of bk terms followed by the two scalings, doubled because both
    executions err: 2 * (bk + 2) * 2^-24 * (|x| @ |gd|) * v_read * |inv|,
    over v_decr: wide enough for an f32 summation in any order (the
    reference's), of which the port's exact dot is one. Returns int32
    (M, n_col_blocks*bn)."""
    m = x.shape[0]
    _, bk, bn = gd_tiles.shape
    n_cb = col_start.shape[0] - 1
    xb = _x_blocks(x.double(), n_row_blocks, bk)
    slots, valid = _rank_tiles(col_start, n_ranks)
    hits = torch.zeros((n_cb, m, bn), dtype=torch.int32, device=x.device)
    u = 2.0 ** -24
    for r in range(n_ranks):
        t = slots[r]
        xr = xb[row_index[t].long()]
        g = gd_tiles[t].double()
        inv = inv_norm_tiles[t].double()
        vd = v_decr_tiles[t].double()[:, None, None]
        v = (torch.bmm(xr, g) * v_read * inv).abs() / vd
        band = 2 * (bk + 2) * u * torch.bmm(xr.abs(), g.abs()) * v_read \
            * inv.abs() / vd
        near = (v - (torch.floor(v) + 0.5)).abs() <= band
        hits += (near & valid[r][:, None, None]).to(torch.int32)
    return hits.permute(1, 0, 2).reshape(m, n_cb * bn)


# ------------------------------------------------------------- CUDA kernel

def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernel needs "
                           "the CUDA toolkit")
    return path


def build() -> Path:
    """Compile csrc/cim_mvm_packed.cu into a shared library under
    build/kernels/ (once per source content) and return its path."""
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out_dir = _REPO / "build" / "kernels"
    lib = out_dir / f"cim_mvm_packed-{tag}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load():
    """Build (at first use) and bind the kernel's C entry points."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cim_mvm_packed_launch.argtypes = [
        p, i, i, p, p, p, p, p, p, i, i, i, p, i,
        f, f, f, f, f, f, f, f, f, i, p]
    lib.cim_mvm_packed_launch.restype = i
    lib.cim_mvm_packed_shared_bytes.argtypes = [i]
    lib.cim_mvm_packed_shared_bytes.restype = i
    for bm in BLOCK_ROWS:            # the verifier's shared-memory model
        got = lib.cim_mvm_packed_shared_bytes(bm)
        if got != shared_bytes(bm):
            raise RuntimeError(
                f"kernel uses {got} B of shared memory at bm={bm}, the "
                f"verifier assumes {shared_bytes(bm)} B")
    _lib = lib
    return lib


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


def cim_mvm_packed(x, gd_tiles, inv_norm_tiles, denorm_tiles, v_decr_tiles,
                   row_index, col_start, *, n_row_blocks: int, n_ranks: int,
                   activation: str = "none", n_max: int = 127,
                   v_read: float = 0.5, impl: str = "auto"):
    """Whole-layer packed CIM MVM: ONE launch over every tile.

    x: (M, K) f32 integer-valued activations; gd_tiles: (T, bk, bn);
    inv_norm_tiles / denorm_tiles: (T, 1, bn); v_decr_tiles: (T,);
    row_index: (T,) int32 input block per slot; col_start: (n_cb + 1,)
    int32 CSR offsets of each output column block's slots (the plan's
    col_block must be non-decreasing). n_row_blocks / n_ranks: static
    plan geometry (input blocks; most tiles in one column block).
    Returns (M, n_cb * bn) f32.

    impl: "auto" runs the plain version on a CPU tensor and launches the
    kernel on a CUDA tensor; "plain" forces the plain version (on-card
    comparison only).
    """
    global LAUNCHES
    if activation not in ACTIVATIONS:
        if activation == "stochastic":
            raise NotImplementedError(
                "the stochastic neuron needs the hash PRNG in the kernel, "
                "not ported yet (ROADMAP B3)")
        raise ValueError(f"unknown activation {activation!r}")
    if col_start is None:
        raise ValueError("col_block is not non-decreasing: the packed "
                         "kernel needs each column block's tiles in one "
                         "contiguous slot range (a single-pass plan)")
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    args = (x, gd_tiles, inv_norm_tiles, denorm_tiles, v_decr_tiles,
            row_index, col_start)
    if impl == "plain" or x.device.type == "cpu":
        return cim_mvm_packed_plain(
            *args, n_row_blocks=n_row_blocks, n_ranks=n_ranks,
            activation=activation, n_max=n_max, v_read=v_read)
    if x.device.type != "cuda":
        raise ValueError(f"no packed CIM kernel for device {x.device}")

    m, k = x.shape
    n_tiles, bk, bn = gd_tiles.shape
    n_cb = col_start.shape[0] - 1
    dev = x.device
    f32, i32 = torch.float32, torch.int32
    _check("x", x, f32, (m, k), dev)
    _check("gd_tiles", gd_tiles, f32, (n_tiles, bk, bn), dev)
    _check("inv_norm_tiles", inv_norm_tiles, f32, (n_tiles, 1, bn), dev)
    _check("denorm_tiles", denorm_tiles, f32, (n_tiles, 1, bn), dev)
    _check("v_decr_tiles", v_decr_tiles, f32, (n_tiles,), dev)
    _check("row_index", row_index, i32, (n_tiles,), dev)
    _check("col_start", col_start, i32, (n_cb + 1,), dev)
    if k > n_row_blocks * bk:
        raise ValueError(f"x has {k} features, the plan covers "
                         f"{n_row_blocks * bk}")
    lib = load()
    out = torch.empty((m, n_cb * bn), dtype=f32, device=dev)
    if m == 0:
        return out
    k0, k1, k2, st0, st1, st2 = pwl_knots(n_max)
    err = lib.cim_mvm_packed_launch(
        x.data_ptr(), m, k, gd_tiles.data_ptr(), inv_norm_tiles.data_ptr(),
        denorm_tiles.data_ptr(), v_decr_tiles.data_ptr(),
        row_index.data_ptr(), col_start.data_ptr(), n_cb, bk, bn,
        out.data_ptr(), ACTIVATIONS[activation], v_read, float(n_max),
        4.0 * n_max, k0, k1, k2, st0, st1, st2, block_rows(m),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cim_mvm_packed launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
