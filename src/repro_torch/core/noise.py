"""RRAM stochastic non-ideality models (PyTorch port of
`repro/core/noise.py`: the noise-resilient-training weight noise; the
conductance relaxation model arrives with ROADMAP A11)."""
from __future__ import annotations

import torch


def weight_noise(generator: torch.Generator, w, noise_frac: float):
    """Noise-resilient-training noise: w + N(0, (noise_frac * max|w|)^2),
    drawn from `generator` (the paper trains at 10-30% of the per-layer
    max |w|)."""
    wmax = torch.max(torch.abs(w))
    return w + noise_frac * wmax * torch.randn(
        w.shape, generator=generator, device=w.device, dtype=w.dtype)
