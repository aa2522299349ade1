"""End-to-end driver: noise-resilient training -> chip deployment -> chip
inference (the paper's CNN story, Fig. 3c + Fig. 1e). Port of
`examples/train_cnn_noisy.py`.

  PYTHONPATH=src python -m repro_torch.examples.train_cnn_noisy [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core.types import CIMConfig
from repro_torch.data import cluster_images
from repro_torch.device import resolve_device
from repro_torch.models import cnn7
from repro_torch.train.noisy import accuracy, eval_under_noise, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    gen = lambda seed: torch.Generator(dev).manual_seed(seed)

    x, y = cluster_images(gen(0), 512, hw=12)
    xt, yt = cluster_images(gen(99), 256, hw=12)

    params = cnn7.init_full(gen(1), x[:2])
    print("training 7-layer CNN (3-bit activations) with 15% weight-noise "
          "injection...")
    t0 = time.time()
    params, losses = train(gen(2), params, cnn7.apply, (x, y), steps=160,
                           batch=64, noise_frac=0.15)
    print(f"  {time.time()-t0:.0f}s, loss {losses[0]:.2f} -> "
          f"{losses[-1]:.2f}")

    print("accuracy under inference-time weight noise (Ext. Data Fig. 6a):")
    for nf, acc in eval_under_noise(gen(3), params, cnn7.apply, (xt, yt),
                                    [0.0, 0.1, 0.2]).items():
        print(f"  noise {nf:.1f}: {acc:.3f}")

    print("programming all 7 layers onto the simulated chip "
          "(write-verify + relaxation, model-driven calibration)...")
    cfg = CIMConfig(in_bits=4, out_bits=8)
    with torch.no_grad():
        states = cnn7.deploy(params, cfg, x[:32], generator=gen(4))
        chip_acc = float(accuracy(cnn7.chip_apply(states, params, xt, cfg),
                                  yt))
        soft_acc = float(accuracy(cnn7.apply(params, xt), yt))
    print(f"software accuracy: {soft_acc:.3f}   chip accuracy: "
          f"{chip_acc:.3f} (fully through the CIM datapath)")


if __name__ == "__main__":
    main()
