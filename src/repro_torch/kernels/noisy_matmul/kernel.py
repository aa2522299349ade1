"""The noise-injection training matmul: a hand-written CUDA kernel for
Hopper and its plain PyTorch version (port of
`repro/kernels/noisy_matmul/kernel.py`, `noisy_matmul_pallas`).

    y = x @ (w + sigma_abs * eps)

Noise-resilient training (paper Fig. 3c) perturbs every weight with fresh
Gaussian noise each forward pass. eps is `hash_normal` (kernels/prng.py)
at the reference's coordinates: the reference draws hash_normal((bk_ref,
bn_ref), seed, k, j) per weight tile, so weight element (kk, n) takes row
kk % bk_ref, column n % bn_ref and salts (seed, kk // bk_ref, n //
bn_ref); (bk_ref, bn_ref) = (min(bk, K), min(bn, N)) of the reference's
block. The noise is a function of (seed, element) only: one noisy weight
matrix per step.

The wrapper takes the plain version for a CPU tensor and launches the
kernel (`csrc/noisy_matmul.cu`, built at first use with the port's other
kernels, `kernels/build.py`) for a CUDA tensor, or raises. Its launches
count in `LAUNCHES["noisy_matmul"]`, and only those.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import build as _build
from ..prng import hash_normal_at

LAUNCHES = _build.LAUNCHES
REF_BLOCK = (256, 256, 256)   # the reference's default (bm, bk, bn)
BLOCK_M, BLOCK_N, BLOCK_K = 128, 64, 16   # the CUDA kernel's tiling
_lib: Optional[ctypes.CDLL] = None


def shared_bytes() -> int:
    """Static shared memory of one block: the x tile [BLOCK_K][BLOCK_M + 4]
    and the noisy weight tile [BLOCK_K][BLOCK_N + 4], f32 (checked against
    the built kernel when the library loads)."""
    return BLOCK_K * (BLOCK_M + 4) * 4 + BLOCK_K * (BLOCK_N + 4) * 4


def weight_noise_eps(k: int, n: int, seed: int, bk_ref: int, bn_ref: int,
                     device=None):
    """eps (K, N): hash_normal at every weight element's reference
    coordinates (the module docstring)."""
    rows = torch.arange(k, device=device)[:, None]
    cols = torch.arange(n, device=device)[None, :]
    return hash_normal_at(rows % bk_ref, cols % bn_ref, seed,
                          rows // bk_ref, cols // bn_ref)


def noisy_matmul_plain(x, w, sigma_abs, *, seed: int, bk_ref: int,
                       bn_ref: int):
    """The plain version: materialises w + sigma_abs * eps, then an f32
    matmul (TF32 off, as `device.resolve_device` sets it)."""
    eps = weight_noise_eps(w.shape[0], w.shape[1], seed, bk_ref, bn_ref,
                           w.device)
    return x @ (w + sigma_abs * eps)


def load() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel's C entry points; checks
    its static shared memory against `shared_bytes`."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.library("noisy_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    # x, w, M, K, N, sigma, seed, bk_ref, bn_ref, out, stream
    lib.noisy_matmul_launch.argtypes = [p, p, i, i, i, p, ctypes.c_uint,
                                        i, i, p, p]
    lib.noisy_matmul_launch.restype = i
    lib.noisy_matmul_shared_bytes.argtypes = []
    lib.noisy_matmul_shared_bytes.restype = i
    got = lib.noisy_matmul_shared_bytes()
    if got != shared_bytes():
        raise RuntimeError(f"noisy_matmul uses {got} B of shared memory, "
                           f"the model assumes {shared_bytes()} B")
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


def noisy_matmul(x, w, sigma_abs, *, seed: int = 0, block=REF_BLOCK,
                 impl: str = "auto"):
    """y = x @ (w + sigma_abs * eps): ONE launch.

    x: (M, K) f32; w: (K, N) f32; sigma_abs: 0-d f32 noise std (read on
    the device); seed: the noise's salt; block: the reference's (bm, bk,
    bn), which keys eps. impl: "auto" runs the plain version on a CPU
    tensor and launches the kernel on a CUDA tensor; "plain" forces the
    plain version (on-card comparison only)."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"x has {k} features, w has {w.shape[0]} rows")
    n = w.shape[1]
    bk_ref, bn_ref = max(min(block[1], k), 1), max(min(block[2], n), 1)
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
    lib = load()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    err = lib.noisy_matmul_launch(
        x.data_ptr(), w.data_ptr(), m, k, n, sigma_abs.data_ptr(), seed,
        bk_ref, bn_ref, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"noisy_matmul launch failed: CUDA error {err}")
    LAUNCHES["noisy_matmul"] += 1
    return out
