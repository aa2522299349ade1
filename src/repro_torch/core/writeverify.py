"""Incremental-pulse write-verify RRAM programming simulator (PyTorch port
of `repro/core/writeverify.py`).

Paper Methods and Extended Data Fig. 3: starting from the device's initial
state, alternate read / incremental SET (or RESET) pulses — SET from 1.2 V,
RESET from 1.5 V, +0.1 V per consecutive pulse, reversing polarity on
overshoot — until the cell is within +-1 uS of target or 30 polarity
reversals time out. The paper measures 99% convergence and 8.52 pulses per
cell on average.

A pulse at voltage V moves the conductance by k * (V - Vth) with ~50%
lognormal cycle-to-cycle variation. The reference's `lax.while_loop` is a
loop over the whole array here; it stops once every cell is done, which it
checks every `CHECK_EVERY` steps (a step after every cell is done changes
nothing, so the result is the same as checking every step, with fewer host
syncs on the card). Draws come from an explicit `torch.Generator`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .noise import apply_relaxation
from .types import DeviceConfig


class ProgramResult(NamedTuple):
    g: torch.Tensor           # final conductances (uS)
    n_pulses: torch.Tensor    # pulses used per cell (int32)
    converged: torch.Tensor   # bool per cell


# device response constants (uS per volt overdrive)
_K_SET = 6.0
_K_RESET = 7.0
_VTH_SET = 0.9
_VTH_RESET = 1.1
_CYCLE_VAR = 0.5         # lognormal sigma of pulse response
_MAX_STEPS = 400
CHECK_EVERY = 8          # steps between checks of the exit condition


def write_verify(generator: torch.Generator, g_target, dev: DeviceConfig
                 ) -> ProgramResult:
    """Program an array of cells to g_target (uS), elementwise."""
    g_target = torch.as_tensor(g_target, dtype=torch.float32)
    shape, device = g_target.shape, g_target.device
    g = dev.g_min + (8.0 - dev.g_min) * torch.rand(
        shape, generator=generator, device=device)
    v_set = torch.full(shape, dev.set_v0, device=device)
    v_reset = torch.full(shape, dev.reset_v0, device=device)
    reversals = torch.zeros(shape, dtype=torch.int32, device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    n_pulses = torch.zeros(shape, dtype=torch.int32, device=device)
    zero = torch.zeros((), device=device)
    for step in range(_MAX_STEPS):
        if step % CHECK_EVERY == 0 and bool(done.all()):
            break
        err = g_target - g
        need_set = err > dev.accept_range
        need_reset = err < -dev.accept_range
        in_range = ~(need_set | need_reset)
        done = done | in_range | (reversals > dev.max_reversals)
        active = ~done

        eta = torch.exp(_CYCLE_VAR * torch.randn(shape, generator=generator,
                                                 device=device))
        dg_set = _K_SET * torch.clamp(v_set - _VTH_SET, min=0.0) * eta
        dg_reset = _K_RESET * torch.clamp(v_reset - _VTH_RESET, min=0.0) * eta
        delta = torch.where(need_set, dg_set,
                            torch.where(need_reset, -dg_reset, zero))
        g_new = torch.clamp(g + delta * active, dev.g_min, dev.g_max * 1.2)

        # overshoot (the sign of the error flips) -> polarity reversal: the
        # pulse amplitude restarts at v0 and the reversal counter bumps
        err_new = g_target - g_new
        flipped = (torch.sign(err_new) != torch.sign(err)) & active \
            & ~in_range
        v_set = torch.where(flipped, torch.full_like(v_set, dev.set_v0),
                            torch.where(need_set & active,
                                        v_set + dev.v_increment, v_set))
        v_reset = torch.where(flipped, torch.full_like(v_reset, dev.reset_v0),
                              torch.where(need_reset & active,
                                          v_reset + dev.v_increment, v_reset))
        reversals = reversals + flipped.to(torch.int32)
        n_pulses = n_pulses + active.to(torch.int32)
        g = g_new
    converged = torch.abs(g_target - g) <= dev.accept_range
    return ProgramResult(g, n_pulses, converged)


def iterative_program(generator: torch.Generator, g_target,
                      dev: DeviceConfig, iterations: int = 3):
    """Full programming flow: write-verify, then `iterations` rounds of
    relaxation + re-programming of drifted cells (paper: 3 iterations
    narrow relaxation sigma by ~29%). Returns the conductances as they
    stand >= 30 min after the last pulse (final relaxation applied)."""
    g = write_verify(generator, g_target, dev).g
    for it in range(iterations):
        # later iterations see less residual drift: the iteration-aware sigma
        g_relaxed = apply_relaxation(generator, g, dev, iterations=it + 1)
        drifted = torch.abs(g_relaxed - g_target) > dev.accept_range
        if it < iterations - 1:
            g_reprog = write_verify(generator, g_target, dev).g
            g = torch.where(drifted, g_reprog, g_relaxed)
        else:
            g = g_relaxed
    return g
