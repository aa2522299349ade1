"""Weight <-> differential RRAM conductance mapping (PyTorch port of
`repro/core/conductance.py`).

Each weight W is encoded by two cells on adjacent rows of the same column:
    g_pos = max(g_max * W / w_max, g_min)
    g_neg = max(-g_max * W / w_max, g_min)
and the voltage-mode output is normalized by the total column conductance
norm_j = sum_i (g_pos_ij + g_neg_ij), which the chip multiplies back
digitally.

`program_conductances` adds the programming noise (write-verify residual
plus conductance relaxation) drawn from a `torch.Generator`; the pulse-level
write-verify simulation is `core/writeverify.py`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .noise import apply_relaxation
from .types import DeviceConfig


class Conductances(NamedTuple):
    g_pos: torch.Tensor   # (R, C) uS
    g_neg: torch.Tensor   # (R, C) uS
    w_max: torch.Tensor   # 0-d — per-matrix weight scale
    norm: torch.Tensor    # (C,) uS — per-column total conductance


def weights_to_conductances(w, dev: DeviceConfig) -> Conductances:
    """Ideal (noise-free) differential encoding of a weight matrix (R, C)."""
    w = w.to(torch.float32)
    w_max = torch.clamp(torch.max(torch.abs(w)), min=1e-12)
    scaled = dev.g_max * w / w_max
    g_pos = torch.clamp(scaled, min=dev.g_min)
    g_neg = torch.clamp(-scaled, min=dev.g_min)
    norm = torch.sum(g_pos + g_neg, dim=0)
    return Conductances(g_pos, g_neg, w_max, norm)


def program_conductances(generator: torch.Generator, w, dev: DeviceConfig,
                         iterations: int = 3) -> Conductances:
    """Encoding followed by programming noise (write-verify residual +
    conductance relaxation): what sits in the array at inference time.
    norm is recomputed from the actual (noisy) cells, since the chip
    measures the programmed conductances. G+ is drawn before G-."""
    ideal = weights_to_conductances(w, dev)
    g_pos = apply_relaxation(generator, ideal.g_pos, dev, iterations)
    g_neg = apply_relaxation(generator, ideal.g_neg, dev, iterations)
    norm = torch.sum(g_pos + g_neg, dim=0)
    return Conductances(g_pos, g_neg, ideal.w_max, norm)


def conductances_to_weights(c: Conductances, dev: DeviceConfig):
    """Decode: the effective weight realized by the (possibly noisy) array."""
    return (c.g_pos - c.g_neg) * c.w_max / dev.g_max
