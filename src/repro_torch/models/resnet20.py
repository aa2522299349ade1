"""ResNet-20 (PyTorch port of `repro/models/resnet20.py`; paper Table 1:
CIFAR-10, 21 conv + 1 fc, batch norm folded into the weights for chip
deployment, 3-b unsigned activations, 4-b first layer).

The He et al. CIFAR variant: stem conv(16), 3 stages x 3 blocks x 2 convs
of widths (16, 32, 64), two 1x1 projection shortcuts, global average pool,
fc. `deploy` programs the 21 convolutions and the fc (one single-matrix
kernel launch per convolution during deploy, 22 per inference).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import nn
from ..core.types import CIMConfig

STAGES = [(16, 1), (32, 2), (64, 2)]   # (width, first-block stride)
BLOCKS_PER_STAGE = 3
ACT_BITS = 3
FIRST_ACT_BITS = 4


def init(generator: torch.Generator, in_ch: int = 3,
         n_classes: int = 10) -> Dict:
    dev = generator.device
    params: Dict = {"alpha": torch.full((24,), 2.0, device=dev)}
    params["stem"] = nn.conv_init(generator, 3, 3, in_ch, 16)
    params["stem_bn"] = nn.bn_init(16, dev)
    c_prev = 16
    for s, (c, _) in enumerate(STAGES):
        for b in range(BLOCKS_PER_STAGE):
            pre = f"s{s}b{b}"
            params[pre + "c1"] = nn.conv_init(generator, 3, 3, c_prev, c)
            params[pre + "bn1"] = nn.bn_init(c, dev)
            params[pre + "c2"] = nn.conv_init(generator, 3, 3, c, c)
            params[pre + "bn2"] = nn.bn_init(c, dev)
            if b == 0 and c != c_prev:
                params[pre + "proj"] = nn.conv_init(generator, 1, 1, c_prev,
                                                    c)
                params[pre + "bnp"] = nn.bn_init(c, dev)
            c_prev = c
    params["fc"] = nn.linear_init(generator, 64, n_classes)
    return params


def _block(params, pre, h, stride, generator, noise_frac, train, alpha,
           new_p):
    identity = h
    y = nn.noisy_conv(generator, params[pre + "c1"], h, noise_frac,
                      stride=stride)
    y, new_p[pre + "bn1"] = nn.batch_norm(params[pre + "bn1"], y, train)
    y = nn.quant_act(torch.relu(y), alpha, ACT_BITS, signed=False)
    y = nn.noisy_conv(generator, params[pre + "c2"], y, noise_frac)
    y, new_p[pre + "bn2"] = nn.batch_norm(params[pre + "bn2"], y, train)
    if pre + "proj" in params:
        identity = nn.noisy_conv(generator, params[pre + "proj"], h,
                                 noise_frac, stride=stride)
        identity, new_p[pre + "bnp"] = nn.batch_norm(params[pre + "bnp"],
                                                     identity, train)
    elif stride != 1:
        identity = identity[:, ::stride, ::stride, :]
    return nn.quant_act(torch.relu(y + identity), alpha, ACT_BITS,
                        signed=False)


def apply(params, x, *, generator: Optional[torch.Generator] = None,
          noise_frac: float = 0.0, train: bool = False
          ) -> Tuple[torch.Tensor, Dict]:
    """Software path. Returns (logits, params with updated BN stats);
    train=True normalizes with batch statistics."""
    new_p = dict(params)
    h = nn.quant_act(x, 1.0, FIRST_ACT_BITS, signed=False)
    h = nn.noisy_conv(generator, params["stem"], h, noise_frac)
    h, new_p["stem_bn"] = nn.batch_norm(params["stem_bn"], h, train)
    h = nn.quant_act(torch.relu(h), params["alpha"][0], ACT_BITS,
                     signed=False)
    ai = 1
    for s, (_, stride) in enumerate(STAGES):
        for b in range(BLOCKS_PER_STAGE):
            h = _block(params, f"s{s}b{b}", h, stride if b == 0 else 1,
                       generator, noise_frac, train, params["alpha"][ai],
                       new_p)
            ai += 1
    h = nn.avg_pool_global(h)
    return nn.noisy_linear(generator, params["fc"], h, noise_frac), new_p


def conv_layers(params) -> List[str]:
    """Deployment order of all weight layers."""
    names = ["stem"]
    for s in range(len(STAGES)):
        for b in range(BLOCKS_PER_STAGE):
            pre = f"s{s}b{b}"
            names += [pre + "c1", pre + "c2"]
            if pre + "proj" in params:
                names.append(pre + "proj")
    names.append("fc")
    return names


def folded_params(params) -> Dict:
    """BN-folded weights for chip deployment (paper Fig. 4c)."""
    fold = {"stem": nn.fold_bn(params["stem"], params["stem_bn"])}
    for s in range(len(STAGES)):
        for b in range(BLOCKS_PER_STAGE):
            pre = f"s{s}b{b}"
            fold[pre + "c1"] = nn.fold_bn(params[pre + "c1"],
                                          params[pre + "bn1"])
            fold[pre + "c2"] = nn.fold_bn(params[pre + "c2"],
                                          params[pre + "bn2"])
            if pre + "proj" in params:
                fold[pre + "proj"] = nn.fold_bn(params[pre + "proj"],
                                                params[pre + "bnp"])
    fold["fc"] = params["fc"]
    return fold


def chip_apply(states, params, x, cfg: CIMConfig, impl: str = "auto"):
    """Full-chip inference with all layers programmed (BN pre-folded);
    impl="plain" runs the kernel's plain version."""
    h = nn.quant_act(x, 1.0, FIRST_ACT_BITS, signed=False)
    h = nn.chip_conv(states["stem"], h, cfg, 3, 3, seed=0, impl=impl)
    h = nn.quant_act(torch.relu(h), params["alpha"][0], ACT_BITS,
                     signed=False)
    ai, seed = 1, 1
    for s, (_, stride) in enumerate(STAGES):
        for b in range(BLOCKS_PER_STAGE):
            pre = f"s{s}b{b}"
            st = stride if b == 0 else 1
            identity = h
            y = nn.chip_conv(states[pre + "c1"], h, cfg, 3, 3, stride=st,
                             seed=seed, impl=impl)
            y = nn.quant_act(torch.relu(y), params["alpha"][ai], ACT_BITS,
                             signed=False)
            y = nn.chip_conv(states[pre + "c2"], y, cfg, 3, 3, seed=seed + 1,
                             impl=impl)
            if pre + "proj" in states:
                identity = nn.chip_conv(states[pre + "proj"], h, cfg, 1, 1,
                                        stride=st, seed=seed + 2, impl=impl)
            elif st != 1:
                identity = identity[:, ::st, ::st, :]
            h = nn.quant_act(torch.relu(y + identity), params["alpha"][ai],
                             ACT_BITS, signed=False)
            ai += 1
            seed += 3
    h = nn.avg_pool_global(h)
    return nn.chip_linear(states["fc"], h, cfg, seed=99, impl=impl)


def deploy(params, cfg: CIMConfig, x_cal, mode: str = "relaxed",
           generator: Optional[torch.Generator] = None):
    """Program every layer in order, calibrating each on the chip outputs
    of the previous ones. Programming noise from `generator` (a fresh one
    seeded 0 on x_cal's device if None). The reference's `upto` (a partial
    deploy for chip-in-the-loop training) waits for the training slice."""
    gen = generator or torch.Generator(x_cal.device).manual_seed(0)
    fold = folded_params(params)
    states: Dict = {}

    def conv(name, x, k, alpha_in, stride=1):
        """Deploy `name` on x's patches, then run it on the chip."""
        cols = nn.im2col(x, k, k, stride=stride)
        states[name] = nn.deploy_linear(
            fold[name], cfg, alpha_in, x_cal=cols.reshape(-1, cols.shape[-1]),
            mode=mode, generator=gen)
        return nn.chip_conv(states[name], x, cfg, k, k, stride=stride)

    # calibration activations flow through the chip as it is built
    h = nn.quant_act(x_cal, 1.0, FIRST_ACT_BITS, signed=False)
    h = nn.quant_act(torch.relu(conv("stem", h, 3, 1.0)), params["alpha"][0],
                     ACT_BITS, signed=False)
    ai = 1
    for s, (_, stride) in enumerate(STAGES):
        for b in range(BLOCKS_PER_STAGE):
            pre = f"s{s}b{b}"
            st = stride if b == 0 else 1
            identity = h
            y = nn.quant_act(
                torch.relu(conv(pre + "c1", h, 3, params["alpha"][ai - 1],
                                st)),
                params["alpha"][ai], ACT_BITS, signed=False)
            y = conv(pre + "c2", y, 3, params["alpha"][ai])
            if pre + "proj" in fold:
                identity = conv(pre + "proj", h, 1, params["alpha"][ai - 1],
                                st)
            elif st != 1:
                identity = identity[:, ::st, ::st, :]
            h = nn.quant_act(torch.relu(y + identity), params["alpha"][ai],
                             ACT_BITS, signed=False)
            ai += 1
    states["fc"] = nn.deploy_linear(
        fold["fc"], cfg, params["alpha"][ai - 1],
        x_cal=nn.avg_pool_global(h), mode=mode, generator=gen)
    return states
