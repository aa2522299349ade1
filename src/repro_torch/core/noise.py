"""RRAM stochastic non-ideality models (PyTorch port of
`repro/core/noise.py`).

Conductance relaxation (paper Extended Data Fig. 3d): after write-verify the
conductance drifts; the drift is Gaussian at all states except near g_min,
with a conductance-dependent sigma peaking ~3.87 uS near ~12 uS and ~2 uS
std after 3 programming iterations. sigma(g) is a smooth bump plus floor,
scaled down with iterative-programming iterations (29% at 3 iterations).

Every draw comes from an explicit `torch.Generator` on the tensor's device.
`lfsr_noise` is the bit-serial oracle's stochastic neuron; the kernels'
stochastic epilogue draws its uniforms from the counter hash instead
(`kernels/prng.py`).
"""
from __future__ import annotations

import torch

from .types import DeviceConfig


def relaxation_sigma(g, dev: DeviceConfig, iterations: int = 3):
    """Std-dev (uS) of conductance relaxation as a function of state g (uS)."""
    g = torch.as_tensor(g, dtype=torch.float32)
    # smooth bump centered at relax_sigma_peak_g, width ~ half the g range
    width = 0.45 * (dev.g_max - dev.g_min)
    bump = torch.exp(-0.5 * ((g - dev.relax_sigma_peak_g) / width) ** 2)
    sigma1 = dev.relax_sigma_floor \
        + (dev.relax_sigma_peak - dev.relax_sigma_floor) * bump
    # iterative programming narrows the tail (paper: 29% decrease)
    shrink = 1.0 / (1.0 + 0.21 * (iterations - 1))
    # cells parked at g_min barely relax upward (floor state)
    at_floor = (g <= dev.g_min + 1e-6).to(torch.float32)
    return sigma1 * shrink * (1.0 - 0.8 * at_floor)


def apply_relaxation(generator: torch.Generator, g, dev: DeviceConfig,
                     iterations: int = 3):
    """Sample post-relaxation conductances, clipped to the physical range."""
    sigma = relaxation_sigma(g, dev, iterations)
    noise = sigma * torch.randn(g.shape, generator=generator,
                                device=g.device, dtype=torch.float32)
    return torch.clamp(g + noise, dev.g_min, dev.g_max)


def weight_noise(generator: torch.Generator, w, noise_frac: float):
    """Noise-resilient-training noise: w + N(0, (noise_frac * max|w|)^2),
    drawn from `generator` (the paper trains at 10-30% of the per-layer
    max |w|)."""
    wmax = torch.max(torch.abs(w))
    return w + noise_frac * wmax * torch.randn(
        w.shape, generator=generator, device=w.device, dtype=w.dtype)


def lfsr_noise(generator: torch.Generator, shape, scale):
    """Pseudo-random injection emulating the XOR'd counter-propagating
    LFSR chains of stochastic neuron sampling (paper Extended Data Fig.
    1d): spatially uncorrelated uniform(-scale, +scale) noise added to the
    integrator charge, drawn from `generator` on its device. `scale` may
    be a 0-d tensor."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -scale + u * (2 * scale)
