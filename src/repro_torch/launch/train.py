"""Fault-tolerant LM training entry point of the port (port of
`repro/launch/train.py`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-72b \
      --smoke --device cpu --steps 30 --batch 8 --seq 128 --ckpt-dir ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-72b \
      --layers 2 --steps 6 --batch 8 --seq 128 --ckpt-every 1000  # card

Trains the arch's LM (`transformer.lm_loss`) with the reference's step
(`steps.make_train_step`: autograd, clip to norm 1, AdamW with f32
moments), resuming from the latest checkpoint under --ckpt-dir and
saving one every --ckpt-every steps (`distributed.FaultTolerantTrainer`'s
resume and async checkpointer). --cim noisy turns on NeuRRAM
noise-resilient training for every linear layer (`cim_linear`'s noisy
mode). --smoke trains the reduced config in float32, otherwise the
config's dtype (bf16 params, f32 moments); --layers cuts the depth.

Runs on the card unless `--device cpu` is given; without CUDA it raises.
Params come from a torch.Generator seeded 0, batch i's tokens (and a
VLM's or an encoder-decoder's stub frontend embeddings, 0.02 x normal)
from one seeded 1000 + i; each step's time is taken with CUDA events on
the card. As in the reference, a resumed run's data stream restarts at
batch 0 (`data_iter` is made after `resume`, from 0). There are no TPU
XLA flags.

--production-mesh, as in the reference: the params are placed by
`fit_pspecs(param_pspecs(params))` and the moments by `opt_pspecs` on
`make_production_mesh()` (16 x 16 ('data', 'model') over the local cards,
repeated in order to fill it; over the CPU with --device cpu), each leaf
a `distributed/sharding.Sharded`; the step is `make_train_step(cfg, lr)`
(no grad_spec, the batch unpinned) and runs on the leaves gathered in
index order, the updated leaves written back into their blocks. On a
mesh that repeats a card the blocks are views of one tensor, so neither
the placement nor the gather copies. Checkpoints save gathered leaves
and resume through `restore_checkpoint(shardings=)`, which cuts them
again.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Iterator, List, NamedTuple

import torch

from .. import configs
from ..data import lm_tokens
from ..device import resolve_device
from ..distributed.fault import FaultTolerantTrainer
from ..distributed.sharding import (Sharded, fit_pspecs, gather_tree,
                                    opt_pspecs, param_pspecs, place,
                                    scatter_)
from ..models import transformer as T
from ..obs.clock import timed_call
from ..train.optimizer import tree_leaves
from .mesh import local_devices, make_production_mesh
from .steps import adamw_init_f32, make_train_step


class TrainResult(NamedTuple):
    params: dict
    opt: dict
    losses: List[float]       # one per step run
    step_s: List[float]       # each step's time (CUDA events on the card)
    start: int                # the step training resumed at


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--cim", default="off", choices=["off", "noisy"])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def train_config(args) -> T.ArchConfig:
    """The arch's config as the driver trains it: --smoke in float32, else
    the config's dtype; --cim as cim_mode; --layers as the depth."""
    cfg = configs.get(args.arch, smoke=args.smoke)
    cfg = cfg.replace(cim_mode=args.cim,
                      dtype=torch.float32 if args.smoke else cfg.dtype)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    return cfg


def data_iter(cfg: T.ArchConfig, batch: int, seq: int, device,
              start: int = 0) -> Iterator[dict]:
    """Batches start, start + 1, ...: batch i's tokens (batch, seq + 1)
    from a generator seeded 1000 + i, then a VLM's "vis_embeds" (batch,
    vis_patches, d) and an encoder-decoder's "src_embeds" (batch, seq, d)
    from the same generator."""
    i = start
    while True:
        gen = torch.Generator(device).manual_seed(1000 + i)
        out = {"tokens": lm_tokens(gen, batch, seq + 1, cfg.vocab)}
        if cfg.vis_patches > 0:
            out["vis_embeds"] = 0.02 * torch.randn(
                (batch, cfg.vis_patches, cfg.d_model), generator=gen,
                device=device).to(cfg.dtype)
        if cfg.enc_layers > 0:
            out["src_embeds"] = 0.02 * torch.randn(
                (batch, seq, cfg.d_model), generator=gen,
                device=device).to(cfg.dtype)
        yield out
        i += 1


def train_loop(cfg: T.ArchConfig, params, opt, batches: Iterator[dict], *,
               steps: int, lr: float, ckpt_dir: str, ckpt_every: int,
               log=print) -> TrainResult:
    """The reference's driver loop: resume (params, opt) from the latest
    checkpoint in `ckpt_dir`, run steps start .. steps - 1 on the next
    batch of `batches` each, save (async) after every ckpt_every-th step,
    wait for the last save. Params and opt are updated in place; where
    their leaves are `Sharded` (--production-mesh) each step runs on the
    gathered leaves and writes them back into the blocks."""
    step_fn = make_train_step(cfg, lr=lr)
    dev = tree_leaves(params)[0].device
    sharded = any(isinstance(x, Sharded)
                  for x in tree_leaves((params, opt)))
    last = {}

    def step(params, opt, batch):
        if not sharded:
            return step_fn(params, opt, batch)
        gp, go = gather_tree(params), gather_tree(opt)
        gp, go, loss, gnorm = step_fn(gp, go, batch)
        for sh, x in zip(tree_leaves((params, opt)), tree_leaves((gp, go))):
            if isinstance(sh, Sharded):
                scatter_(sh, x)
        del gp, go               # gathered copies freed (none when aliased)
        return params, opt, loss, gnorm

    def wrapped(state, batch):
        params, opt = state
        (params, opt, loss, _), dt = timed_call(step, params, opt, batch,
                                                device=dev)
        last.update(loss=float(loss), s=dt)
        return (params, opt)

    trainer = FaultTolerantTrainer(wrapped, ckpt_dir, ckpt_every=ckpt_every)
    state, start = trainer.resume(
        (params, opt), shardings=(params, opt) if sharded else None)
    log(f"starting at step {start}")
    losses, step_s = [], []
    for s in range(start, steps):
        state = wrapped(state, next(batches))
        losses.append(last["loss"])
        step_s.append(last["s"])
        if s % 5 == 0 or s == steps - 1:
            log(f"step {s} loss {last['loss']:.4f} ({last['s']:.3f} s; "
                f"mean {sum(step_s) / len(step_s):.3f} s/step)")
        if (s + 1) % ckpt_every == 0:
            trainer.ckpt.save(s + 1, state)
    trainer.ckpt.wait()
    if losses:
        log(f"done. loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return TrainResult(state[0], state[1], losses, step_s, start)


def run(args) -> TrainResult:
    """Build the model and optimizer on the device and train (`main`)."""
    dev = resolve_device(args.device)
    cfg = train_config(args)
    params = T.init_params(cfg, seed=0, device=dev)
    opt = adamw_init_f32(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} layers={cfg.n_layers} params={n_params / 1e6:.1f}M "
          f"dtype={str(cfg.dtype).removeprefix('torch.')} cim={cfg.cim_mode} "
          f"device={where}")
    if args.production_mesh:
        params, opt, mesh = place_on_production_mesh(params, opt, dev)
        shape = "x".join(str(v) for v in mesh.shape.values())
        print(f"mesh={shape} {tuple(mesh.axis_names)} over "
              f"{mesh.n_distinct()} distinct device(s)")
    return train_loop(cfg, params, opt,
                      data_iter(cfg, args.batch, args.seq, dev),
                      steps=args.steps, lr=args.lr, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every)


def place_on_production_mesh(params, opt, device):
    """(params, opt, mesh): params placed by fit_pspecs(param_pspecs) and
    the moments by opt_pspecs on `make_production_mesh` over the local
    devices of `device`'s type (module docstring)."""
    mesh = make_production_mesh(devices=local_devices(device.type))
    pspec = fit_pspecs(params, param_pspecs(params), mesh)
    return (place(params, pspec, mesh), place(opt, opt_pspecs(pspec), mesh),
            mesh)


def main(argv=None) -> List[float]:
    return run(parse_args(argv)).losses


if __name__ == "__main__":
    main()
