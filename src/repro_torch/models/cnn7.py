"""7-layer CNN (PyTorch port of `repro/models/cnn7.py`; paper Table 1:
MNIST, 6 conv + 1 fc, max-pool between, 3-bit unsigned activations
everywhere, 0.98% error on chip).

Works on any (B, H, W, C) input; the paper's geometry is 28x28x1
(`data.cluster_images` makes matched synthetic images). `deploy` programs
every layer onto the simulated chip (default `relaxed`), calibrating each
on the chip outputs of the previous ones; `chip_apply` runs inference
fully through the CIM datapath, one single-matrix kernel launch per layer
(6 during deploy, 7 per inference). The chip-in-the-loop staged interface
of the reference (`chip_prefix`, `soft_suffix`, `deploy_upto`) comes with
the training slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import nn
from ..core.types import CIMConfig

_CHANNELS = [16, 16, 32, 32, 64, 64]
_POOL_AFTER = {1, 3, 5}          # pool after conv idx 1, 3, 5
ACT_BITS = 3                      # 3-b unsigned


def init(generator: torch.Generator, in_ch: int = 1) -> Dict:
    """Conv weights and PACT clips; the fc layer is shaped by
    `init_full`."""
    params: Dict = {}
    c_prev = in_ch
    for i, c in enumerate(_CHANNELS):
        params[f"conv{i}"] = nn.conv_init(generator, 3, 3, c_prev, c)
        c_prev = c
    params["alpha"] = torch.full((len(_CHANNELS) + 1,), 2.0,
                                 device=generator.device)
    return params


def apply(params, x, *, generator: Optional[torch.Generator] = None,
          noise_frac: float = 0.0):
    """Software path. x: (B, H, W, C) in [0, 1]; weight noise from
    `generator` when noise_frac > 0."""
    h = nn.quant_act(x, 1.0, ACT_BITS, signed=False)
    for i in range(len(_CHANNELS)):
        h = nn.noisy_conv(generator, params[f"conv{i}"], h, noise_frac)
        h = torch.relu(h)
        h = nn.quant_act(h, params["alpha"][i], ACT_BITS, signed=False)
        if i in _POOL_AFTER:
            h = nn.max_pool(h)
    h = h.reshape(h.shape[0], -1)
    return nn.noisy_linear(generator, params["fc"], h, noise_frac)


def init_full(generator: torch.Generator, sample_x, n_classes: int = 10):
    """init + the fc layer shaped by tracing the feature dims of
    `sample_x` (B, H, W, C)."""
    params = init(generator, in_ch=sample_x.shape[-1])
    h = sample_x
    for i in range(len(_CHANNELS)):
        h = nn.noisy_conv(None, params[f"conv{i}"], h, 0.0)
        if i in _POOL_AFTER:
            h = nn.max_pool(h)
    params["fc"] = nn.linear_init(
        generator, h.shape[1] * h.shape[2] * h.shape[3], n_classes)
    return params


# ---------------------------------------------------------------- chip path

def deploy(params, cfg: CIMConfig, x_cal, mode: str = "relaxed",
           generator: Optional[torch.Generator] = None):
    """Program every layer onto the simulated chip, calibrating each layer
    with the previous layers' chip outputs on training data (model-driven
    calibration). Programming noise from `generator` (a fresh one seeded 0
    on x_cal's device if None)."""
    gen = generator or torch.Generator(x_cal.device).manual_seed(0)
    states = {}
    h = nn.quant_act(x_cal, 1.0, ACT_BITS, signed=False)
    for i in range(len(_CHANNELS)):
        alpha_in = 1.0 if i == 0 else params["alpha"][i - 1]
        cols = nn.im2col(h, 3, 3)
        states[f"conv{i}"] = nn.deploy_linear(
            params[f"conv{i}"], cfg, alpha_in,
            x_cal=cols.reshape(-1, cols.shape[-1]), mode=mode, generator=gen)
        h = nn.chip_conv(states[f"conv{i}"], h, cfg, 3, 3)
        h = torch.relu(h)
        h = nn.quant_act(h, params["alpha"][i], ACT_BITS, signed=False)
        if i in _POOL_AFTER:
            h = nn.max_pool(h)
    hf = h.reshape(h.shape[0], -1)
    states["fc"] = nn.deploy_linear(params["fc"], cfg, params["alpha"][5],
                                    x_cal=hf, mode=mode, generator=gen)
    return states


def chip_apply(states, params, x, cfg: CIMConfig, impl: str = "auto"):
    """Chip inference: every layer through the CIM datapath (impl="plain":
    the kernel's plain version)."""
    h = nn.quant_act(x, 1.0, ACT_BITS, signed=False)
    for i in range(len(_CHANNELS)):
        h = nn.chip_conv(states[f"conv{i}"], h, cfg, 3, 3, seed=i, impl=impl)
        h = torch.relu(h)
        h = nn.quant_act(h, params["alpha"][i], ACT_BITS, signed=False)
        if i in _POOL_AFTER:
            h = nn.max_pool(h)
    h = h.reshape(h.shape[0], -1)
    return nn.chip_linear(states["fc"], h, cfg, seed=6, impl=impl)
