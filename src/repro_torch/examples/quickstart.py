"""Quickstart: the NeuRRAM CIM substrate in five minutes (port of
`examples/quickstart.py`).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. Encode a weight matrix as differential RRAM conductances.
2. Program it with the write-verify simulator (+ relaxation noise).
3. Run a voltage-mode bit-serial MVM through the fused CIM kernel.
4. Compare against the ideal matmul.
"""
import argparse

import torch

import repro_torch.core as core
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    gen = lambda seed: torch.Generator(dev).manual_seed(seed)

    cfg = core.CIMConfig(in_bits=4, out_bits=8)
    print(f"CIM config: {cfg.in_bits}-bit inputs, {cfg.out_bits}-bit "
          f"outputs, g in [{cfg.device.g_min}, {cfg.device.g_max}] uS")

    # a layer weight matrix and some activations
    w = 0.1 * torch.randn((128, 64), generator=gen(0), device=dev)
    x = torch.randn((32, 128), generator=gen(1), device=dev)

    # program onto the simulated chip (write-verify + relaxation),
    # calibrate the ADC
    layer = core.program(w, cfg, in_alpha=2.0, x_cal=x, mode="relaxed",
                         generator=gen(2))
    print(f"programmed: norm[0..3] = {layer.norm[:4].cpu().numpy()} uS, "
          f"ADC v_decr = {float(layer.v_decr):.4f} V")

    # chip inference vs ideal matmul
    y_chip = core.forward(layer, x, cfg)
    y_ideal = torch.clamp(x, -2, 2) @ w
    rel = float(torch.linalg.norm(y_chip - y_ideal)
                / torch.linalg.norm(y_ideal))
    print(f"chip-vs-ideal relative error: {rel:.3f} "
          "(4-bit inputs + analog noise + 8-bit ADC)")

    # the effective weight the noisy array actually realizes
    w_eff = core.effective_weight(layer, cfg)
    print(f"weight realization error (relaxation): "
          f"{float(torch.abs(w_eff - w).max()):.4f} "
          f"(w_max = {float(torch.abs(w).max()):.3f})")

    # energy/latency of this MVM on the chip (calibrated analytical model)
    cost = core.mvm_cost(128, 64, cfg.in_bits, cfg.out_bits)
    print(f"modeled chip cost: {cost.energy_pj:.0f} pJ, "
          f"{cost.latency_ns:.0f} ns, {cost.tops_per_w:.1f} TOPS/W")


if __name__ == "__main__":
    main()
