"""The model's raw weights and the chips' calibration batches, made on
the device from the run's seed, handed alike to the program and to the
reference.

Weights: one normal draw of every weight element from a torch.Generator
on the device, in float32 (the type the chips are compiled from), then
scaled in place: a matrix by 1 / sqrt(its rows), the embedding and
unembedding by 0.02; the norms' scales are ones. Calibration batches:
one truncated-normal draw in [-2, 2] times the input clip, (64, rows)
for every chip-mapped matrix of every layer (and every routed expert).
Layout: the program's, per-layer weights stacked as (L, in, out),
experts (L, E, in, out).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

CAL_ROWS = 64


def _shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """name -> shape of every matrix of the 'layers' stack."""
    L, d, hd = m["n_layers"], m["d_model"], m["head_dim"]
    q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    s = {"wq": (L, d, q), "wk": (L, d, kv), "wv": (L, d, kv),
         "wo": (L, q, d)}
    if m["n_experts"] > 0:
        e, de = m["n_experts"], m["d_expert"]
        ds = de * m["n_shared_experts"]
        s.update(router=(L, d, e), ew_g=(L, e, d, de), ew_i=(L, e, d, de),
                 ew_o=(L, e, de, d), sw_g=(L, d, ds), sw_i=(L, d, ds),
                 sw_o=(L, ds, d))
    else:
        f = m["d_ff"]
        s.update(w_g=(L, d, f), w_i=(L, d, f), w_o=(L, f, d))
    return s


def make_params(m: dict, seed: int, device) -> dict:
    """The raw float32 params of model section `m` from `seed`."""
    shapes = dict(_shapes(m))
    shapes["embed"] = (m["vocab"], m["d_model"])
    shapes["unembed"] = (m["d_model"], m["vocab"])
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn((total,), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        w = flat[at:at + n].view(shape)
        at += n
        w.mul_(0.02 if name in ("embed", "unembed")
               else 1.0 / math.sqrt(shape[-2]))
        out[name] = w
    d, L = m["d_model"], m["n_layers"]
    ones = torch.ones((d,), device=device)
    layers = {k: out[k] for k in _shapes(m)}
    layers["ln1"] = ones.expand(L, d)
    layers["ln2"] = ones.expand(L, d)
    return {"embed": out["embed"], "unembed": out["unembed"], "ln_f": ones,
            "layers": layers}


def chip_names(m: dict) -> List[str]:
    """The chip-mapped matrices of one layer's chip (not the experts')."""
    if m["n_experts"] > 0:
        return ["wq", "wk", "wv", "wo", "sw_g", "sw_i", "sw_o"]
    return ["wq", "wk", "wv", "wo", "w_g", "w_i", "w_o"]


def make_x_cal(m: dict, params: dict, seed: int, device) -> List[dict]:
    """Per layer, name -> (64, rows) calibration batch, and for MoE
    'experts': per expert, name -> batch; drawn at once from `seed`."""
    lay = params["layers"]
    want = []
    for li in range(m["n_layers"]):
        for n in chip_names(m):
            want.append((li, None, n, lay[n].shape[-2]))
        for e in range(m["n_experts"]):
            for n in ("ew_g", "ew_i", "ew_o"):
                want.append((li, e, n, lay[n].shape[-2]))
    total = sum(CAL_ROWS * r for *_, r in want)
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.empty((total,), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    flat.mul_(float(m["in_alpha"]))
    out = [{"experts": [{} for _ in range(m["n_experts"])]}
           for _ in range(m["n_layers"])]
    at = 0
    for li, e, n, r in want:
        x = flat[at:at + CAL_ROWS * r].view(CAL_ROWS, r)
        at += CAL_ROWS * r
        if e is None:
            out[li][n] = x
        else:
            out[li]["experts"][e][n] = x
    return out
