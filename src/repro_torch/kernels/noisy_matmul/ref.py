"""Statistical reference of the noise-injection training matmul (PyTorch
port of `repro/kernels/noisy_matmul/ref.py`).

y = x @ (w + sigma_frac * wmax * eps),  eps ~ N(0, 1)

eps comes from a `torch.Generator`, so this agrees with the kernel (whose
eps is the hash PRNG's) exactly at sigma = 0 and in distribution above it.
"""
from __future__ import annotations

import torch


def noisy_matmul_ref(x, w, sigma_frac: float, generator: torch.Generator):
    wmax = torch.max(torch.abs(w))
    eps = torch.randn(w.shape, generator=generator, device=w.device,
                      dtype=torch.float32)
    return x @ (w + sigma_frac * wmax * eps)
