"""RBM image recovery on the chip (paper Fig. 4e-g, Ext. Data Fig. 8):
bidirectional Gibbs sampling using the TNSA's transposable MVM — compiled
ONCE with directions=("fwd", "bwd") and served as packed forward and
transposed kernel launches (the batched serving driver is `python -m
repro_torch.launch.recover`). Port of `examples/image_recovery_rbm.py`.

  PYTHONPATH=src python -m repro_torch.examples.image_recovery_rbm [--device cpu]
"""
import argparse

import torch

from repro_torch.core.types import CIMConfig
from repro_torch.data import binary_patterns, corrupt_flip, corrupt_occlude
from repro_torch.device import resolve_device
from repro_torch.models import nn, rbm

PIX, NH = 128, 32


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    gen = lambda seed: torch.Generator(dev).manual_seed(seed)

    v = binary_patterns(gen(0), 512, d=PIX, rank=4)
    print("training RBM with CD-1 (+5% noise injection, best for RBMs per "
          "Ext. Data Fig. 6c)...")
    params = rbm.train_cd1(gen(2), v, NH, steps=800)

    print("compiling the augmented (V+1)x(H+1) array once, fwd+bwd; both "
          "Gibbs directions run on the same cells (TNSA "
          "transposability)...")
    cfg = CIMConfig(in_bits=2, out_bits=8)
    crbm = nn.deploy_rbm_cim(params, cfg, v[:64], generator=gen(3))

    vt = binary_patterns(gen(7), 64, d=PIX, rank=4)
    for name, corrupt in [("20% flipped pixels", corrupt_flip),
                          ("bottom-1/3 occlusion", corrupt_occlude)]:
        v_c, mask = corrupt(vt, pixels=PIX) if corrupt is corrupt_occlude \
            else corrupt(gen(8), vt, 0.2, pixels=PIX)
        traj = rbm.chip_gibbs_recover(gen(9), crbm, v_c, mask, n_cycles=10)
        rec = torch.where(mask, v_c, traj[-1])   # clamp the trusted pixels
        e0 = float(rbm.l2_error(v_c[:, :PIX], vt[:, :PIX]))
        e1 = float(rbm.l2_error(rec[:, :PIX], vt[:, :PIX]))
        print(f"{name}: L2 error {e0:.1f} -> {e1:.1f} "
              f"({100*(1-e1/e0):.0f}% reduction, paper reports 70%)")


if __name__ == "__main__":
    main()
