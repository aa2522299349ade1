"""Entry point of the noise-injection training matmul (PyTorch port of
`repro/kernels/noisy_matmul/ops.py`)."""
from __future__ import annotations

import torch

from . import kernel as K


def noisy_matmul(x, w, sigma_frac: float, seed: int = 0, *,
                 block=K.REF_BLOCK, impl: str = "auto"):
    """y = x @ (w + sigma_frac * max|w| * eps), eps drawn in the kernel at
    the reference's weight-tile coordinates of `block` (bm, bk, bn)."""
    x = x.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    sigma_abs = sigma_frac * torch.max(torch.abs(w))
    return K.noisy_matmul(x, w, sigma_abs, seed=seed, block=block, impl=impl)
