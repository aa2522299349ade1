"""The noise-injection training matmul: hand-written CUDA kernels for Hopper
and their plain PyTorch version (port of
`repro/kernels/noisy_matmul/kernel.py`, `noisy_matmul_pallas`).

    y = x @ (w + sigma_abs * eps)

Noise-resilient training (paper Fig. 3c) perturbs every weight with fresh
Gaussian noise each forward pass. eps is `hash_normal` (kernels/prng.py)
at the reference's coordinates: the reference draws hash_normal((bk_ref,
bn_ref), seed, k, j) per weight tile, so weight element (kk, n) takes row
kk % bk_ref, column n % bn_ref and salts (seed, kk // bk_ref, n //
bn_ref); (bk_ref, bn_ref) = (min(bk, K), min(bn, N)) of the reference's
block. The noise is a function of (seed, element) only: one noisy weight
matrix per call.

On the card the call is two kernels (`csrc/noisy_matmul.cu`, built at
first use with the port's other kernels, `kernels/build.py`): the weight
pass draws each element's eps once and writes w' (`noisy_weight_plain` is
its plain version) into a zero-padded scratch, then an FP32 SGEMM
multiplies x by it at the tiling `sgemm_geometry` picks. The wrapper takes
the plain version for a CPU tensor and launches both kernels for a CUDA
tensor, or raises. Each call that launches them counts one in
`LAUNCHES["noisy_matmul"]`, and nothing else does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import build as _build
from ..prng import hash_normal_at

LAUNCHES = _build.LAUNCHES
REF_BLOCK = (256, 256, 256)   # the reference's default (bm, bk, bn)
# the SGEMM's tilings: rows, columns, k per k-tile and ring stages of a
# block tile (csrc/noisy_matmul.cu kTile)
SGEMM_TILES = ((128, 256), (64, 64))
SGEMM_BK = (32, 8)
SGEMM_STAGES = (2, 4)
H100_SMS = 132                # SMs of an H100 SXM
_lib: Optional[ctypes.CDLL] = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sgemm_geometry(m: int, n: int, n_sm: int = H100_SMS) -> int:
    """The SGEMM's tiling of an (m, n) output, an index into SGEMM_TILES:
    the largest tile whose grid gives every SM a block, else the one with
    the most blocks (the smallest)."""
    if m < 1 or n < 1:
        raise ValueError(f"no SGEMM geometry for m={m}, n={n}")
    blocks = [_cdiv(m, bm) * _cdiv(n, bn) for bm, bn in SGEMM_TILES]
    return next((t for t, b in enumerate(blocks) if b >= n_sm),
                len(SGEMM_TILES) - 1)


def sgemm_blocks(m: int, n: int, tile: int) -> int:
    """Blocks of the SGEMM's grid at `tile`."""
    bm, bn = SGEMM_TILES[tile]
    return _cdiv(m, bm) * _cdiv(n, bn)


def padded_shape(k: int, n: int, tile: int):
    """The noisy weight scratch (Kp, Np): k up to the SGEMM's k-tile, n up
    to its column tile, so its loads are aligned and never masked."""
    return _cdiv(k, SGEMM_BK[tile]) * SGEMM_BK[tile], \
        _cdiv(n, SGEMM_TILES[tile][1]) * SGEMM_TILES[tile][1]


def shared_bytes(tile: int) -> int:
    """Dynamic shared memory of one SGEMM block at `tile`: its stages of
    the x tile [k][rows + 4] and the weight tile [k][cols], f32 (checked
    against the built kernel when the library loads)."""
    bm, bn = SGEMM_TILES[tile]
    return SGEMM_STAGES[tile] * SGEMM_BK[tile] * ((bm + 4) + bn) * 4


def weight_noise_eps(k: int, n: int, seed: int, bk_ref: int, bn_ref: int,
                     device=None):
    """eps (K, N): hash_normal at every weight element's reference
    coordinates (the module docstring)."""
    rows = torch.arange(k, device=device)[:, None]
    cols = torch.arange(n, device=device)[None, :]
    return hash_normal_at(rows % bk_ref, cols % bn_ref, seed,
                          rows // bk_ref, cols // bn_ref)


def noisy_weight_plain(w, sigma_abs, *, seed: int, bk_ref: int,
                       bn_ref: int):
    """The plain version of the weight pass: w + sigma_abs * eps."""
    eps = weight_noise_eps(w.shape[0], w.shape[1], seed, bk_ref, bn_ref,
                           w.device)
    return w + sigma_abs * eps


def noisy_matmul_plain(x, w, sigma_abs, *, seed: int, bk_ref: int,
                       bn_ref: int):
    """The plain version: materialises the noisy weight, then an f32
    matmul (TF32 off, as `device.resolve_device` sets it)."""
    return x @ noisy_weight_plain(w, sigma_abs, seed=seed, bk_ref=bk_ref,
                                  bn_ref=bn_ref)


def load() -> ctypes.CDLL:
    """Build (at first use) and bind the kernels' C entry points; checks
    the SGEMM's shared memory against `shared_bytes`."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.library("noisy_matmul")
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    # w, K, N, sigma, seed, bk_ref, bn_ref, wn, Kp, Np, tile, stream
    lib.noisy_weight_launch.argtypes = [p, i, i, p, u, i, i, p, i, i, i, p]
    # x, M, K, N, wn, Kp, Np, tile, out, stream
    lib.noisy_sgemm_launch.argtypes = [p, i, i, i, p, i, i, i, p, p]
    lib.noisy_sgemm_shared_bytes.argtypes = [i]
    for fn in (lib.noisy_weight_launch, lib.noisy_sgemm_launch,
               lib.noisy_sgemm_shared_bytes):
        fn.restype = i
    for tile in range(len(SGEMM_TILES)):
        got = lib.noisy_sgemm_shared_bytes(tile)
        if got != shared_bytes(tile):
            raise RuntimeError(f"noisy_sgemm uses {got} B of shared memory "
                               f"at tile {SGEMM_TILES[tile]}, the model "
                               f"assumes {shared_bytes(tile)} B")
    _lib = lib
    return lib


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ref_block(k: int, n: int, block):
    return max(min(block[1], k), 1), max(min(block[2], n), 1)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise(what: str, err: int):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _tile(m: int, n: int, dev) -> int:
    return sgemm_geometry(
        m, n, torch.cuda.get_device_properties(dev).multi_processor_count)


def _weight(w, sigma_abs, seed: int, bk_ref: int, bn_ref: int, tile: int):
    """The weight pass on the current stream: w' into a new zero-padded
    (Kp, Np) scratch for SGEMM tiling `tile` (`padded_shape`)."""
    k, n = w.shape
    kp, np_ = padded_shape(k, n, tile)
    wn = torch.empty((kp, np_), dtype=torch.float32, device=w.device)
    _raise("noisy_weight", load().noisy_weight_launch(
        w.data_ptr(), k, n, sigma_abs.data_ptr(), seed, bk_ref, bn_ref,
        wn.data_ptr(), kp, np_, tile, _stream(w.device)))
    return wn


def _sgemm(x, wn, n: int, tile: int):
    """The SGEMM on the current stream: x @ wn[:K, :n]."""
    m, k = x.shape
    kp, np_ = padded_shape(k, n, tile)
    _check("wn", wn, (kp, np_), x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _raise("noisy_sgemm", load().noisy_sgemm_launch(
        x.data_ptr(), m, k, n, wn.data_ptr(), kp, np_, tile, out.data_ptr(),
        _stream(x.device)))
    return out


def noisy_matmul(x, w, sigma_abs, *, seed: int = 0, block=REF_BLOCK,
                 impl: str = "auto"):
    """y = x @ (w + sigma_abs * eps): ONE call, the weight pass and the
    SGEMM launched back to back.

    x: (M, K) f32; w: (K, N) f32; sigma_abs: 0-d f32 noise std (read on
    the device); seed: the noise's salt; block: the reference's (bm, bk,
    bn), which keys eps. impl: "auto" runs the plain version on a CPU
    tensor and launches the kernels on a CUDA tensor; "plain" forces the
    plain version (on-card comparison only)."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"x has {k} features, w has {w.shape[0]} rows")
    n = w.shape[1]
    bk_ref, bn_ref = _ref_block(k, n, block)
    seed = int(seed) & 0xFFFFFFFF
    if impl == "plain" or x.device.type == "cpu":
        return noisy_matmul_plain(x, w, sigma_abs, seed=seed, bk_ref=bk_ref,
                                  bn_ref=bn_ref)
    if x.device.type != "cuda":
        raise ValueError(f"no noisy_matmul kernel for device {x.device}")
    dev = x.device
    _check("x", x, (m, k), dev)
    _check("w", w, (k, n), dev)
    _check("sigma_abs", sigma_abs, (), dev)
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.float32, device=dev)
    if k == 0:                       # an empty sum, as the plain version
        return torch.zeros((m, n), dtype=torch.float32, device=dev)
    tile = _tile(m, n, dev)
    out = _sgemm(x, _weight(w, sigma_abs, seed, bk_ref, bn_ref, tile), n,
                 tile)
    LAUNCHES["noisy_matmul"] += 1
    return out
