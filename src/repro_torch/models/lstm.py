"""4-parallel-cell LSTM for speech-command recognition (PyTorch port of
`repro/models/lstm.py`; paper Fig. 4d, 84.7% on Google speech commands).

Per cell: input->gates (40 x 448), hidden->gates (112 x 448),
hidden->logits (112 x 12); hidden size 112, 4 gates (i, g, f, o); 50 MFCC
time steps of length-40 vectors; the class from the sum of the 4 cells'
logits. MVM inputs are quantized to 4-b signed; the element-wise gate math
runs in float (the paper does it on the companion FPGA). The recurrent
dataflow is the TNSA's BL->BL mode: the same programmed arrays are reused
every time step, so a chip inference makes n_cells * (2 T + 1)
single-matrix launches (404 at paper geometry).

The reference's `lax.scan` over time steps is a Python loop here. A
cell's weight noise is drawn once per forward pass and used at every time
step, as the reference's one key per cell and matrix gives; the input
projection of all time steps is one product.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import nn
from ..core.noise import weight_noise
from ..core.types import CIMConfig

N_CELLS = 4
HIDDEN = 112
IN_DIM = 40
N_CLASSES = 12
IN_BITS = 4  # 4-b signed


def init(generator: torch.Generator, in_dim: int = IN_DIM,
         hidden: int = HIDDEN, n_classes: int = N_CLASSES,
         n_cells: int = N_CELLS) -> Dict:
    dev = generator.device
    params: Dict = {"alpha_x": torch.tensor(3.0, device=dev),
                    "alpha_h": torch.tensor(1.0, device=dev)}
    for c in range(n_cells):
        params[f"cell{c}_ih"] = nn.linear_init(generator, in_dim, 4 * hidden)
        params[f"cell{c}_hh"] = nn.linear_init(generator, hidden, 4 * hidden)
        params[f"cell{c}_ho"] = nn.linear_init(generator, hidden, n_classes)
    return params


def _gates_to_state(z, c_state):
    """Gate pre-activations (B, 4 H) in (i, g, f, o) order and the cell
    state -> (h, c)."""
    i, g, f, o = torch.chunk(z, 4, dim=-1)
    c_new = torch.sigmoid(f) * c_state + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def _noisy(generator, p, noise_frac: float):
    """p with its weight perturbed once (`weight_noise`) when noise is on."""
    if noise_frac > 0.0 and generator is not None:
        return {"w": weight_noise(generator, p["w"], noise_frac),
                "b": p["b"]}
    return p


def apply(params, x, *, generator: Optional[torch.Generator] = None,
          noise_frac: float = 0.0, n_cells: int = N_CELLS,
          hidden: int = HIDDEN):
    """Software path. x: (B, T, F) MFCC series -> (B, n_classes) logits;
    weight noise from `generator` when noise_frac > 0."""
    b, t, _ = x.shape
    xq = nn.quant_act(x, params["alpha_x"], IN_BITS, signed=True)
    logits = 0.0
    for c in range(n_cells):
        ih, hh, ho = (_noisy(generator, params[f"cell{c}_{m}"], noise_frac)
                      for m in ("ih", "hh", "ho"))
        zx = nn.noisy_linear(None, ih, xq, 0.0)           # (B, T, 4 H)
        h = torch.zeros((b, hidden), device=x.device)
        cst = torch.zeros((b, hidden), device=x.device)
        for s in range(t):
            hq = nn.quant_act(h, params["alpha_h"], IN_BITS, signed=True)
            z = zx[:, s] + nn.noisy_linear(None, hh, hq, 0.0)
            h, cst = _gates_to_state(z, cst)
        hq = nn.quant_act(h, params["alpha_h"], IN_BITS, signed=True)
        logits = logits + nn.noisy_linear(None, ho, hq, 0.0)
    return logits


# ---------------------------------------------------------------- chip path

def deploy(params, cfg: CIMConfig, x_cal, n_cells: int = N_CELLS,
           hidden: int = HIDDEN, mode: str = "relaxed",
           generator: Optional[torch.Generator] = None):
    """Program the 3 matrices of each cell. Calibration activations come
    from a software rollout over training-set MFCCs x_cal (B, T, F)
    (model-driven calibration): every step's quantized input, and every
    step's quantized hidden state before the update. Programming noise
    from `generator` (a fresh one seeded 0 on x_cal's device if None)."""
    gen = generator or torch.Generator(x_cal.device).manual_seed(0)
    b, t, f = x_cal.shape
    xq = nn.quant_act(x_cal, params["alpha_x"], IN_BITS, signed=True)
    x_flat = xq.transpose(0, 1).reshape(-1, f)          # time-major
    states: Dict = {}
    for c in range(n_cells):
        ih, hh = params[f"cell{c}_ih"], params[f"cell{c}_hh"]
        h = torch.zeros((b, hidden), device=x_cal.device)
        cst = torch.zeros((b, hidden), device=x_cal.device)
        hqs = []
        for s in range(t):
            hq = nn.quant_act(h, params["alpha_h"], IN_BITS, signed=True)
            hqs.append(hq)
            z = xq[:, s] @ ih["w"] + ih["b"] + hq @ hh["w"] + hh["b"]
            h, cst = _gates_to_state(z, cst)
        h_flat = torch.stack(hqs).reshape(-1, hidden)
        for m, alpha, xc in (("ih", params["alpha_x"], x_flat),
                             ("hh", params["alpha_h"], h_flat),
                             ("ho", params["alpha_h"], h_flat)):
            states[f"cell{c}_{m}"] = nn.deploy_linear(
                params[f"cell{c}_{m}"], cfg, alpha, x_cal=xc, mode=mode,
                generator=gen)
    return states


def chip_apply(states, params, x, cfg: CIMConfig, n_cells: int = N_CELLS,
               hidden: int = HIDDEN, impl: str = "auto"):
    """Chip inference: every matrix product through the CIM datapath, the
    gate math in float (impl="plain": the kernel's plain version)."""
    b, t, _ = x.shape
    xs = x.transpose(0, 1).contiguous()                 # (T, B, F)
    logits = 0.0
    for c in range(n_cells):
        ih, hh, ho = (states[f"cell{c}_{m}"] for m in ("ih", "hh", "ho"))
        h = torch.zeros((b, hidden), device=x.device)
        cst = torch.zeros((b, hidden), device=x.device)
        for s in range(t):
            z = nn.chip_linear(ih, xs[s], cfg, seed=3 * c, impl=impl) \
                + nn.chip_linear(hh, h, cfg, seed=3 * c + 1, impl=impl)
            h, cst = _gates_to_state(z, cst)
        logits = logits + nn.chip_linear(ho, h, cfg, seed=3 * c + 2,
                                         impl=impl)
    return logits
