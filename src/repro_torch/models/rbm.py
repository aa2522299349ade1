"""Restricted Boltzmann Machine for image recovery (PyTorch port of
`repro/models/rbm.py`; paper Fig. 4e-g).

794 visible units (784 pixels + 10 one-hot labels) x 120 hidden units,
trained with contrastive divergence in software, deployed on the chip for
inference: 10 cycles of back-and-forth Gibbs sampling between visible and
hidden units, with uncorrupted pixels clamped after each cycle;
performance = L2 reconstruction error reduction vs the corrupted input.

Bidirectionality: v->h runs SL->BL and h->v BL->SL on the SAME programmed
array. Both bias vectors are embedded with the always-on-unit trick (one
extra visible row holds the hidden biases, one extra hidden column the
visible biases), so the (V+1, H+1) array is programmed ONCE:
`models/nn.deploy_rbm_cim` compiles it with directions=("fwd", "bwd").
`chip_gibbs_recover` then alternates the packed forward launch (the
packed kernel) and the transpose-direction launch (the transposed kernel)
in a Python loop over cycles; its Bernoulli draws come from an explicit
generator. With stochastic=True the h->v half-step takes the chip's
stochastic-neuron comparator bits instead of a digital draw.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..core.cim import CompiledChip, packed_forward

N_VIS = 794
N_HID = 120


def init(generator: torch.Generator, n_vis: int = N_VIS,
         n_hid: int = N_HID) -> Dict:
    dev = generator.device
    return {
        "w": 0.01 * torch.randn((n_vis, n_hid), generator=generator,
                                device=dev),
        "a": torch.zeros((n_vis,), device=dev),   # visible bias
        "b": torch.zeros((n_hid,), device=dev),   # hidden bias
    }


def cd1_update(generator: torch.Generator, params, v_data, lr=0.05,
               noise_frac: float = 0.0):
    """One contrastive-divergence (CD-1) step on a batch of binary
    visibles."""
    w = params["w"]
    if noise_frac > 0.0:
        from ..core.noise import weight_noise
        w = weight_noise(generator, w, noise_frac)
    ph = torch.sigmoid(v_data @ w + params["b"])
    h = torch.bernoulli(ph, generator=generator)
    pv = torch.sigmoid(h @ w.T + params["a"])
    v_model = torch.bernoulli(pv, generator=generator)
    ph2 = torch.sigmoid(v_model @ w + params["b"])
    b = v_data.shape[0]
    dw = (v_data.T @ ph - v_model.T @ ph2) / b
    da = torch.mean(v_data - v_model, dim=0)
    db = torch.mean(ph - ph2, dim=0)
    return {"w": params["w"] + lr * dw, "a": params["a"] + lr * da,
            "b": params["b"] + lr * db}


def train_cd1(generator: torch.Generator, v_data, n_hid: int,
              steps: int = 800, batch: int = 64, lr: float = 0.1,
              noise_frac: float = 0.05) -> Dict:
    """The CD-1 training recipe of the reference: random minibatches of
    `batch` with 5% weight-noise injection by default. v_data: (N, n_vis)
    binary training patterns on the generator's device. Returns params."""
    params = init(generator, n_vis=v_data.shape[1], n_hid=n_hid)
    for _ in range(steps):
        idx = torch.randint(0, v_data.shape[0], (batch,),
                            generator=generator, device=v_data.device)
        params = cd1_update(generator, params, v_data[idx], lr=lr,
                            noise_frac=noise_frac)
    return params


def gibbs_recover(generator: torch.Generator, params, v_corrupt, mask_known,
                  n_cycles: int = 10):
    """Software reference recovery. mask_known: True where the pixel is
    trusted. Returns the last cycle's visible probabilities."""
    v = v_corrupt
    pv = v
    for _ in range(n_cycles):
        ph = torch.sigmoid(v @ params["w"] + params["b"])
        h = torch.bernoulli(ph, generator=generator)
        pv = torch.sigmoid(h @ params["w"].T + params["a"])
        v = torch.bernoulli(pv, generator=generator)
        v = torch.where(mask_known, v_corrupt, v)   # clamp trusted pixels
    return pv


# ---------------------------------------------------------------- chip path

@dataclasses.dataclass
class ChipRBM:
    """The RBM's served chip artifact (built by `models/nn.deploy_rbm_cim`):
    ONE bidirectionally compiled chip plus the geometry the Gibbs loop
    needs.

    chip:  `core.cim.CompiledChip` compiled with directions=("fwd","bwd");
           the single matrix "rbm" is the (padded, optionally
           pixel-interleaved) augmented (V+1, H+1) array.
    perm / inv_perm: visible-row permutation of the pixel-interleaved
           mapping (None when interleave is off): fwd inputs are gathered
           by `perm`, bwd outputs by `inv_perm`.
    n_pad: padded visible+bias row count (n_vis + 1 without interleave).
    """
    chip: CompiledChip
    perm: Optional[torch.Tensor]
    inv_perm: Optional[torch.Tensor]
    n_vis: int
    n_hid: int
    n_pad: int


def _augmented(params):
    v, h = params["w"].shape
    w_aug = torch.zeros((v + 1, h + 1), device=params["w"].device)
    w_aug[:v, :h] = params["w"]
    w_aug[v, :h] = params["b"]
    w_aug[:v, h] = params["a"]
    return w_aug


def _aug_v(v):
    return torch.cat([v, torch.ones((v.shape[0], 1), device=v.device)], -1)


def _aug_h(h):
    return torch.cat([h, torch.ones((h.shape[0], 1), device=h.device)], -1)


def chip_gibbs_recover(generator: torch.Generator, crbm: ChipRBM, v_corrupt,
                       mask_known, n_cycles: int = 10, *,
                       stochastic: bool = False, seed0: int = 0,
                       impl: str = "auto"):
    """Image recovery through the chip datapath: each Gibbs cycle runs the
    packed FWD (v->h, SL->BL) launch and the transpose-direction BWD (h->v,
    BL->SL) launch of ONE compiled chip, clamping the trusted pixels
    between cycles. Hidden (and, digitally, visible) samples are Bernoulli
    draws from `generator`; stochastic=True takes the h->v sample straight
    from the chip's stochastic neurons (needs the hidden space in one input
    block). impl="plain" runs the kernels' plain versions (on-card
    comparison only).

    Returns the (n_cycles, B, n_vis) trajectory of recovered visible
    probabilities (comparator bits when stochastic); entry [-1] is the
    final reconstruction.
    """
    cfg = crbm.chip.cfg
    fwd = crbm.chip.layers["rbm"]
    bwd = crbm.chip.layers_for("bwd")["rbm"]
    cfg_st = dataclasses.replace(cfg, activation="stochastic")
    n_vis, n_hid, n_pad = crbm.n_vis, crbm.n_hid, crbm.n_pad

    def to_chip(v):
        """(B, n_vis) -> the fwd launch's (B, n_pad) padded, permuted
        drive vector (visible units + the always-on bias unit)."""
        x = _aug_v(v)
        if n_pad > x.shape[1]:
            x = torch.nn.functional.pad(x, (0, n_pad - x.shape[1]))
        return x[:, crbm.perm] if crbm.perm is not None else x

    def from_chip(y):
        """(B, n_pad) bwd outputs -> (B, n_vis) logical visible units."""
        y = y[:, crbm.inv_perm] if crbm.inv_perm is not None else y
        return y[:, :n_vis]

    v, pvs = v_corrupt, []
    for i in range(n_cycles):
        logits_h = packed_forward(fwd, to_chip(v), cfg, seed=seed0 + 2 * i,
                                  impl=impl)[:, :n_hid]
        hb = _aug_h(torch.bernoulli(torch.sigmoid(logits_h),
                                    generator=generator))
        if stochastic:
            pv = from_chip(packed_forward(bwd, hb, cfg_st,
                                          seed=seed0 + 2 * i + 1, impl=impl))
            v_new = pv                      # comparator bits ARE the sample
        else:
            logits_v = from_chip(packed_forward(
                bwd, hb, cfg, seed=seed0 + 2 * i + 1, impl=impl))
            pv = torch.sigmoid(logits_v)
            v_new = torch.bernoulli(pv, generator=generator)
        v = torch.where(mask_known, v_corrupt, v_new)
        pvs.append(pv)
    return torch.stack(pvs)


def l2_error(v_rec, v_orig):
    return torch.mean(torch.sum((v_rec - v_orig) ** 2, dim=-1))
