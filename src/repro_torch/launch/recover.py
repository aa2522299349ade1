"""Batched Bayesian image-recovery serving entry point of the port (paper
Fig. 4e-g; port of `repro/launch/recover.py`).

  PYTHONPATH=src python -m repro_torch.launch.recover --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.recover \
      --pixels 784 --labels 10 --hidden 120        # paper geometry, card

The first bidirectional serving surface: an RBM's augmented (V+1, H+1)
array is compiled ONCE with directions=("fwd", "bwd")
(`models/nn.deploy_rbm_cim`), then a batch of corrupted-image recovery
requests runs through `rbm.chip_gibbs_recover`, a loop of Gibbs cycles
alternating the packed FWD (v->h, SL->BL; the packed kernel) and the
transpose-direction BWD (h->v, BL->SL; the transposed kernel) launches
over the same programmed conductances, clamping the trusted pixels
between cycles.

Reports the per-cycle L2 reconstruction-error reduction against the
corrupted input (the paper's Fig. 4g metric; it reports about 70% at full
MNIST geometry), the time of one Gibbs run (CUDA events on the card) and
the analytical per-direction MVM energy: a `ChipMeter` over the chip
counts the one timed run's rows per direction (batch x cycles each way),
priced through `core/energy.mvm_cost` (pJ per MVM and TOPS/W for the
v->h and h->v launches, energy per request and per batch). --metrics-out
writes the meters and the run's latency histogram as JSON.
--smoke runs a CI-sized task and FAILS (exit 1) if the final clamped
reconstruction does not reduce the L2 error by at least 50%.
--interleave turns on the pixel-interleaved multi-core mapping (Fig. 4f);
--stochastic samples the h->v half-step with the chip's stochastic
neurons instead of a digital Bernoulli draw.

Runs on the card unless `--device cpu` is given; without CUDA it raises.
Draws come from torch.Generators seeded 0 (training data and training),
3 (deploy), 7 (test patterns), 8 (corruption) and 9 (Gibbs).
"""
from __future__ import annotations

import argparse
from typing import List, NamedTuple

import torch

from ..core.types import CIMConfig
from ..data import binary_patterns, corrupt_flip, corrupt_occlude
from ..device import resolve_device
from ..kernels.cim_mvm import kernel as cim_kernel
from ..models import nn, rbm
from ..obs import MetricsRegistry
from ..obs.chipmeter import ChipMeter
from ..obs.clock import stopwatch, timed_call


class Setup(NamedTuple):
    """A deployed RBM chip and the recovery batch it serves."""
    crbm: rbm.ChipRBM
    v_true: torch.Tensor      # (B, n_vis) clean patterns
    v_corrupt: torch.Tensor   # (B, n_vis) corrupted inputs
    mask: torch.Tensor        # (B, n_vis) True where trusted
    train_s: float
    deploy_s: float


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized task; enforces >=50%% L2-error reduction")
    ap.add_argument("--batch", type=int, default=64,
                    help="recovery requests served per Gibbs run")
    ap.add_argument("--pixels", type=int, default=256)
    ap.add_argument("--labels", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=48)
    ap.add_argument("--train-steps", type=int, default=800)
    ap.add_argument("--cycles", type=int, default=10)
    ap.add_argument("--corrupt", choices=["flip", "occlude"], default="flip")
    ap.add_argument("--frac", type=float, default=0.2,
                    help="corrupted fraction of the pixel block")
    ap.add_argument("--mode", default="relaxed",
                    choices=["ideal", "relaxed", "writeverify"],
                    help="conductance programming fidelity")
    ap.add_argument("--in-bits", type=int, default=2)
    ap.add_argument("--out-bits", type=int, default=8)
    ap.add_argument("--interleave", action="store_true",
                    help="pixel-interleaved multi-core mapping (Fig. 4f)")
    ap.add_argument("--stochastic", action="store_true",
                    help="sample h->v with the chip's stochastic neurons")
    ap.add_argument("--metrics-out", default="",
                    help="write the per-direction chip meters (and run "
                         "latency histograms) as JSON")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.smoke:
        args.pixels, args.hidden = 128, 32
        args.batch = min(args.batch, 32)
        args.train_steps = min(args.train_steps, 800)
    return args


def build(args, device) -> Setup:
    """Train the RBM (CD-1), deploy it on one bidirectional chip and draw
    the corrupted recovery batch."""
    n_vis = args.pixels + args.labels
    cfg = CIMConfig(in_bits=args.in_bits, out_bits=args.out_bits)
    gen = torch.Generator(device).manual_seed(0)
    with stopwatch() as sw_train:
        v_train = binary_patterns(gen, 512, d=args.pixels, rank=4,
                                  labels_dim=args.labels)
        params = rbm.train_cd1(gen, v_train, args.hidden,
                               steps=args.train_steps)
    if device.type == "cuda":
        cim_kernel.load()         # nvcc at first use: set-up, not serving
    with stopwatch() as sw_deploy:
        crbm = nn.deploy_rbm_cim(
            params, cfg, v_train[:64], mode=args.mode,
            interleave=args.interleave,
            generator=torch.Generator(device).manual_seed(3))
    assert crbm.n_vis == n_vis
    vt = binary_patterns(torch.Generator(device).manual_seed(7), args.batch,
                         d=args.pixels, rank=4, labels_dim=args.labels)
    if args.corrupt == "flip":
        v_c, mask = corrupt_flip(torch.Generator(device).manual_seed(8), vt,
                                 frac=args.frac, pixels=args.pixels)
    else:
        v_c, mask = corrupt_occlude(vt, frac=args.frac, pixels=args.pixels)
    return Setup(crbm, vt, v_c, mask, sw_train.s, sw_deploy.s)


def recover(setup: Setup, args, impl: str = "auto"):
    """One Gibbs run over the batch from a generator seeded 9; returns the
    (cycles, B, n_vis) trajectory."""
    gen = torch.Generator(setup.v_corrupt.device).manual_seed(9)
    return rbm.chip_gibbs_recover(gen, setup.crbm, setup.v_corrupt,
                                  setup.mask, n_cycles=args.cycles,
                                  stochastic=args.stochastic, impl=impl)


def reductions(setup: Setup, traj, pixels: int) -> List[float]:
    """Per cycle, 1 - L2(clamped reconstruction) / L2(corrupted input)
    over the pixel block."""
    vt, v_c = setup.v_true[:, :pixels], setup.v_corrupt[:, :pixels]
    mask = setup.mask[:, :pixels]
    e0 = float(rbm.l2_error(v_c, vt))
    return [1.0 - float(rbm.l2_error(torch.where(mask, v_c,
                                                 t[:, :pixels]), vt)) / e0
            for t in traj]


def meter_run(setup: Setup, args) -> ChipMeter:
    """The chip's per-direction meters over one Gibbs run: each cycle
    pushes the whole batch through the fwd (v->h, SL->BL) direction and
    back through the bwd (h->v, BL->SL) direction of the same programmed
    array."""
    meter = ChipMeter.from_chip(setup.crbm.chip, name="rbm")
    meter.count_rows(args.batch * args.cycles, direction="fwd")
    meter.count_rows(args.batch * args.cycles, direction="bwd")
    return meter


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    setup = build(args, dev)
    fwd_plan = setup.crbm.chip.layers["rbm"].packed
    bwd_plan = setup.crbm.chip.bwd_layers["rbm"].packed
    assert bwd_plan.gd_tiles is fwd_plan.gd_tiles   # ONE programmed array
    print(f"recover: compiled 1 chip x 2 directions ({args.mode}"
          f"{', interleaved' if args.interleave else ''}): "
          f"{fwd_plan.n_tiles} tiles / {fwd_plan.n_passes} passes fwd, "
          f"shared gd stack bwd, in {setup.deploy_s:.2f}s "
          f"(train {setup.train_s:.1f}s)")
    recover(setup, args)                  # warm-up
    traj, t_run = timed_call(recover, setup, args, device=dev)
    meter = meter_run(setup, args)
    red = reductions(setup, traj, args.pixels)
    print("cycle  reduction")
    for c, r in enumerate(red):
        print(f"{c + 1:5d}  {100.0 * r:8.0f}%")
    # per-direction energy (analytical model, Ext. Data Fig. 10), read off
    # the meters, which price each direction's packed plan geometry
    fwd_cost = meter.entries[("rbm/rbm", "fwd")].cost
    bwd_cost = meter.entries[("rbm/rbm", "bwd")].cost
    e_cycle = fwd_cost.energy_pj + bwd_cost.energy_pj
    print(f"energy/MVM: fwd (v->h, SL->BL) {fwd_cost.energy_pj:.0f} pJ "
          f"@ {fwd_cost.tops_per_w:.1f} TOPS/W | "
          f"bwd (h->v, BL->SL) {bwd_cost.energy_pj:.0f} pJ "
          f"@ {bwd_cost.tops_per_w:.1f} TOPS/W")
    print(f"energy/request: {args.cycles * e_cycle / 1e3:.2f} nJ "
          f"({args.cycles} cycles); batch of {args.batch}: "
          f"{meter.energy_pj() / 1e6:.3f} uJ modeled, "
          f"{t_run * 1e3:.1f} ms per Gibbs run")
    if args.metrics_out:
        metrics = MetricsRegistry()
        meter.export(metrics)
        metrics.histogram("recover_gibbs_run_s",
                          "steady-state Gibbs recovery run seconds"
                          ).observe(t_run)
        metrics.write_json(args.metrics_out)
        print(f"metrics: wrote {args.metrics_out}")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"recover: device={where} batch={args.batch} cycles={args.cycles} "
          f"corrupt={args.corrupt}({args.frac}) "
          f"{'stochastic ' if args.stochastic else ''}"
          f"L2 reduction {100 * red[-1]:.0f}% (paper Fig. 4g reports ~70%); "
          f"{t_run * 1e3:.1f} ms per Gibbs run")
    if args.smoke and red[-1] < 0.5:
        raise SystemExit(
            f"smoke gate: L2-error reduction {100 * red[-1]:.0f}% < 50%")
    return red[-1]


if __name__ == "__main__":
    main()
