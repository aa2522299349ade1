"""Fault tolerance and straggler mitigation (PyTorch port of the
single-process half of `repro/distributed/fault.py`).

The failure model: (a) a hard fault kills the run, which restarts from
the latest complete checkpoint; (b) stragglers: a per-step wall-time
watchdog flags slow steps and, past a budget, triggers a pre-emptive
checkpoint.

  * FaultTolerantTrainer wraps a step fn with async checkpointing every
    ckpt_every steps, resume-from-latest, the straggler watchdog (an EMA of
    step times; a step slower than `straggler_factor` x the EMA is counted
    and, past `straggler_budget`, forces an early checkpoint), and an
    optional fault injector the tests use to prove restart-equivalence.
    Each step's time includes waiting for the device (the reference's
    block_until_ready on the state's first leaf).

  * elastic_reshard places a tree onto a new mesh: each leaf moves to the
    device its placement names (a torch.device, or a tuple of devices
    from `distributed/sharding.named_shardings` that names one), or is
    cut into the blocks of a `distributed/sharding.Sharded` placement
    (the production mesh's params and moments, `launch/train.py`). A
    tuple naming several distinct devices raises: it says where blocks
    go, not how to cut them.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..checkpoint import AsyncCheckpointer, restore_checkpoint
from ..obs.clock import now
from ..train.optimizer import tree_leaves


def _placement_device(placement) -> torch.device:
    """The one device a placement names (a device, a device string, or a
    tuple of them that all name one device)."""
    if isinstance(placement, (tuple, list)):
        devs = {torch.device(d) for d in placement}
        if len(devs) != 1:
            raise ValueError(
                f"placement {placement} splits a leaf across devices; the "
                "port places whole tensors (shard stacks are placed by "
                "models/nn.place_packed_stack)")
        return devs.pop()
    return torch.device(placement)


def elastic_reshard(tree: Any, shardings: Any):
    """`tree` with each tensor leaf on the device its placement names:
    `shardings` is a tree of the same structure with a placement per leaf
    (module docstring), or one device (or device string) for every leaf.
    Non-tensor leaves are kept."""
    from ..train.optimizer import tree_map
    if isinstance(shardings, (torch.device, str)):
        dev = torch.device(shardings)
        return tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                        else t, tree)
    from .sharding import Sharded

    def put(t, s):
        if not isinstance(t, torch.Tensor):
            return t
        if isinstance(s, Sharded):
            return s.place(t)
        return t.to(_placement_device(s))
    return tree_map(put, tree, shardings)


def _wait_for_device(state: Any):
    """Block until the device of the state's first tensor is done."""
    leaf = next((t for t in tree_leaves(state)
                 if isinstance(t, torch.Tensor)), None)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


class FaultTolerantTrainer:
    def __init__(self, step_fn: Callable, ckpt_dir: str, ckpt_every: int = 50,
                 straggler_factor: float = 3.0, straggler_budget: int = 3,
                 fault_injector: Optional[Callable[[int], bool]] = None):
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.straggler_factor = straggler_factor
        self.straggler_budget = straggler_budget
        self.fault_injector = fault_injector
        self.ema_step_time = None
        self.straggler_hits = 0
        self.events = []          # (step, kind) log for tests/observability

    def resume(self, state: Any, device=None, shardings: Any = None):
        """(state, step): the latest complete checkpoint restored into
        `state`'s structure and dtypes (placed by `shardings`, else on
        `device`, else where each leaf of `state` lies), or (state, 0)
        when there is none."""
        restored, step = restore_checkpoint(self.ckpt_dir, state,
                                            device=device,
                                            shardings=shardings)
        if restored is None:
            return state, 0
        self.events.append((step, "resumed"))
        return restored, step

    def run(self, state: Any, data_iter, n_steps: int, start_step: int = 0):
        """Steps start_step .. n_steps - 1 with a batch each from
        `data_iter`; checkpoints every ckpt_every steps and at the end.
        Returns (state, step)."""
        step = start_step
        try:
            while step < n_steps:
                if self.fault_injector and self.fault_injector(step):
                    self.events.append((step, "fault"))
                    raise RuntimeError(f"injected fault at step {step}")
                t0 = now()
                batch = next(data_iter)
                state = self.step_fn(state, batch)
                _wait_for_device(state)
                dt = now() - t0
                if self.ema_step_time is None:
                    self.ema_step_time = dt
                elif dt > self.straggler_factor * self.ema_step_time:
                    self.straggler_hits += 1
                    self.events.append((step, "straggler"))
                    if self.straggler_hits >= self.straggler_budget:
                        self.ckpt.save(step + 1, state)   # pre-emptive ckpt
                        self.straggler_hits = 0
                        self.events.append((step, "preemptive_ckpt"))
                else:
                    self.ema_step_time = 0.9 * self.ema_step_time + 0.1 * dt
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
                    self.events.append((step, "ckpt"))
        finally:
            self.ckpt.wait()
        self.ckpt.save(step, state)
        self.ckpt.wait()
        return state, step
