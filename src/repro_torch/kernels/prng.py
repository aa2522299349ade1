"""Counter-based hash PRNG of the CIM kernels (PyTorch port of
`repro/kernels/prng.py`).

A Murmur3 finalizer over element coordinates plus integer salts: stateless
and deterministic in (salts, row, column), the software analogue of the
chip's spatially uncorrelated XOR'd LFSR chains. The CUDA kernels carry the
same hash as device code (`csrc/hash_prng.cuh`); these are its plain
versions. uint32 wraparound is written out in int64 arithmetic masked
to 32 bits, with every product split so that it stays below 2^63.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
ROW_MUL, COL_MUL = 0x9E3779B9, 0x7F4A7C15
SALT_MUL = 0x6C62272E          # salt k is multiplied by SALT_MUL + 2k


def _mul32(h, c: int):
    """(h * c) mod 2^32 for int64 h in [0, 2^32)."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * c + ((hi * c) << 16)) & MASK


def _mix(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_bits_at(rows, cols, *salts):
    """uint32 hash bits (int64 values in [0, 2^32)) at broadcastable int
    tensors of row and column coordinates; salts are ints or int tensors
    that broadcast against them (negative salts wrap as uint32)."""
    rows = torch.as_tensor(rows, dtype=torch.int64)
    cols = torch.as_tensor(cols, dtype=torch.int64, device=rows.device)
    h = (_mul32(rows & MASK, ROW_MUL) + _mul32(cols & MASK, COL_MUL)) & MASK
    for k, s in enumerate(salts):
        s = torch.as_tensor(s, dtype=torch.int64, device=rows.device)
        h = _mix((h + _mul32(s & MASK, SALT_MUL + 2 * k)) & MASK)
    return _mix(h)


def _iota(shape, device):
    rows = torch.arange(shape[0], device=device).reshape(
        (shape[0],) + (1,) * (len(shape) - 1))
    cols = torch.arange(shape[-1], device=device)
    return rows, cols


def hash_bits(shape, *salts, device=None):
    """Hash bits of `shape`: row = index along dim 0, column = index along
    the last dim, as the reference's block-local iota."""
    rows, cols = _iota(shape, device)
    return torch.broadcast_to(hash_bits_at(rows, cols, *salts), shape)


def bits_to_uniform(bits):
    """uint32 bits -> float32 in [0, 1]: the conversion rounds to nearest,
    then an exact scale by 2^-32."""
    return bits.to(torch.float32) * (1.0 / 4294967296.0)


def hash_uniform(shape, *salts, device=None):
    """Uniform in [0, 1)."""
    return bits_to_uniform(hash_bits(shape, *salts, device=device))


def _box_muller(u1, u2):
    u1 = torch.clamp(u1, min=1e-7)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def hash_normal(shape, *salts, device=None):
    """Standard normal via Box-Muller on two hashed uniforms."""
    return _box_muller(hash_uniform(shape, *salts, 1, device=device),
                       hash_uniform(shape, *salts, 2, device=device))


def hash_normal_at(rows, cols, *salts):
    """`hash_normal` at broadcastable row and column coordinates, as
    `hash_bits_at` takes them."""
    return _box_muller(bits_to_uniform(hash_bits_at(rows, cols, *salts, 1)),
                       bits_to_uniform(hash_bits_at(rows, cols, *salts, 2)))
