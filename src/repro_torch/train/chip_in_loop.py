"""Chip-in-the-loop progressive fine-tuning (PyTorch port of
`repro/train/chip_in_loop.py`; paper Fig. 3d/f, Extended Data Fig. 7a).

Program the network one stage at a time onto the (simulated) chip. After
programming stage n, run the training set through the chip up to stage n
and fine-tune stages n+1..N in software on those measured activations
(reduced lr, the same noise injection and input quantization). The
programmed prefix's non-linear errors (IR drop, ADC offsets) are absorbed
by the still-trainable suffix; no weight is re-programmed.

Generic over a staged model interface (`models/cnn7.py` has one):
    deploy_upto(generator, params, cfg, x_cal, upto) -> chip states
    chip_prefix(states, params, x, upto)             -> chip activation
    soft_suffix(params, h, frm, generator, noise_frac) -> logits
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from .noisy import accuracy, value_and_grad, xent
from .optimizer import adamw_init, adamw_update, clip_grads


def stage_generator(generator: torch.Generator) -> torch.Generator:
    """A fresh generator on `generator`'s device, seeded from one draw of
    it: what one stage programs its prefix with."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    return torch.Generator(generator.device).manual_seed(seed)


def progressive_finetune(
    generator: torch.Generator,
    params: Dict,
    cfg,
    x_train, y_train,
    *,
    deploy_upto: Callable,
    chip_prefix: Callable,
    soft_suffix: Callable,
    n_stages: int,
    noise_frac: float = 0.1,
    ft_steps: int = 30,
    lr: float = 1e-5,
    batch: int = 64,
):
    """Returns (final chip states, fine-tuned params, per-stage train
    accuracy of the last fine-tuning step).

    Every stage re-programs the whole prefix, calibrated on x_train[:64],
    with its own generator (`stage_generator`): conductances and ADC
    offsets are drawn afresh at each stage, as the reference's
    re-split key does (its comment says they stay identical; they do not).
    Then the prefix runs on all of x_train, and the suffix takes ft_steps
    AdamW steps (fresh state, no weight decay) on batches drawn from
    `generator`, as does the weight noise."""
    accs: List[float] = []
    states = {}
    for stage in range(1, n_stages + 1):
        with torch.no_grad():
            states = deploy_upto(stage_generator(generator), params, cfg,
                                 x_train[:64], stage)
            h_meas = chip_prefix(states, params, x_train, stage)

        def ft_step(p, opt, hb, yb):
            def loss_fn(pp):
                logits = soft_suffix(pp, hb, stage, generator, noise_frac)
                return xent(logits, yb), logits.detach()
            _, logits, grads = value_and_grad(loss_fn, p)
            with torch.no_grad():
                grads, _ = clip_grads(grads, 1.0)
                p2, opt = adamw_update(grads, opt, p, lr)
            return p2, opt, accuracy(logits, yb)

        opt = adamw_init(params)
        n = x_train.shape[0]
        acc = 0.0
        for _ in range(ft_steps):
            idx = torch.randint(0, n, (min(batch, n),), generator=generator,
                                device=generator.device)
            params, opt, acc = ft_step(params, opt, h_meas[idx],
                                       y_train[idx])
        accs.append(float(acc))
    return states, params, accs
