"""Activation quantization (PACT) and the integer formats of the CIM
datapath (PyTorch port of `repro/core/quant.py`).

`torch.round` rounds half to even, as `jnp.round` does, so both packages
put a value that sits exactly on a .5 tie on the same integer. PACT's clip
is `jnp.clip`'s composition, a maximum then a minimum, so its gradient
splits a tie with a bound evenly as JAX's does (`torch.clamp` gives the
whole gradient to x there, and none to alpha).
"""
from __future__ import annotations

import torch


def _round_ste(x):
    """Round with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def pact_quantize(x, alpha, bits: int, signed: bool = False):
    """PACT quantization. Returns float values on the quantized grid.

    unsigned: levels {0..2^bits-1} scaled to [0, alpha]
    signed:   levels {-(2^(b-1)-1)..2^(b-1)-1} scaled to [-alpha, alpha]
    """
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    if signed:
        # binary (1-bit) inputs keep one magnitude level {-1, 0, 1}
        n = max((1 << (bits - 1)) - 1, 1)
        xc = torch.minimum(torch.maximum(x, -alpha), alpha)
        return _round_ste(xc * n / alpha) * alpha / n
    n = (1 << bits) - 1
    xc = torch.minimum(torch.maximum(x, torch.zeros_like(alpha)), alpha)
    return _round_ste(xc * n / alpha) * alpha / n


def quantize_to_int(x, alpha, bits: int, signed: bool = True):
    """Map float x to the integer grid the chip drives on its input wires.

    Returns (x_int int32 in [-in_max, in_max] (or [0, 2^bits-1] unsigned),
    scale) such that x ~= x_int * scale. `scale` is a float32 0-d tensor.
    """
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    if signed:
        n = max((1 << (bits - 1)) - 1, 1)   # 1-bit: ternary {-1, 0, 1}
        scale = alpha / n
        xi = torch.clamp(torch.round(x / scale), -n, n).to(torch.int32)
    else:
        n = (1 << bits) - 1
        scale = alpha / n
        xi = torch.clamp(torch.round(x / scale), 0, n).to(torch.int32)
    return xi, scale


def dequantize(x_int, scale):
    """x ~= x_int * scale in float32 (the inverse of `quantize_to_int`)."""
    return x_int.to(torch.float32) * scale


def int_bit_planes(x_int, mag_bits: int):
    """Decompose signed ints into ternary bit-plane pulses (paper Methods).

    Pulse k (k = mag_bits-1 .. 0, MSB first) is sign(x) * bit_k(|x|), in
    {-1, 0, +1}. Returns int32 (mag_bits,) + x_int.shape, MSB first.
    """
    sign = torch.sign(x_int)
    mag = torch.abs(x_int)
    planes = [(sign * ((mag >> k) & 1)).to(torch.int32)
              for k in range(mag_bits - 1, -1, -1)]
    return torch.stack(planes, dim=0)
