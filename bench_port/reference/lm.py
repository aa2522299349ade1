"""Plain PyTorch forward pass of the served LMs, every chip-mapped
projection through `reference/cim.Chip`: the benchmark's reference for a
served model. It imports nothing of the program.

The architecture is the one the configuration file states: a pre-norm
decoder with RMSNorm, RoPE and grouped-query attention (granite-20b's
single KV head), then either a SiLU-gated MLP or a fine-grained MoE FFN
(top-k routed experts, softmax over the k chosen router logits, shared
experts added). Departures from the published models are listed under
`assumed` in each configuration file. The float sums that feed a chip
input are taken in float64 and rounded once, as the configuration
states: RMSNorm's mean of squares, attention's two products, the router's
logits.

It runs layer by layer over a set of whole sequences (teacher-forced,
causal): each layer's chips are compiled from the raw weights and the
calibration batches, every sequence goes through that layer, and the
chips are dropped before the next, so the reference fits beside what is
left on the card.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .cim import Chip, precision

DENSE = ("wq", "wk", "wv", "wo", "w_g", "w_i", "w_o")
SHARED = ("wq", "wk", "wv", "wo", "sw_g", "sw_i", "sw_o")
EXPERT = ("ew_g", "ew_i", "ew_o")


def rms_norm(x, scale, eps: float):
    var = torch.mean(torch.square(x.to(torch.float64)), dim=-1,
                     keepdim=True).to(torch.float32)
    return (x * torch.rsqrt(var + eps)) * scale


def rope(x, positions, theta: float):
    """x: (S, H, D), positions (S,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[:, None].to(torch.float32) * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


QUERIES = 1024      # query rows of attention at once


def attention(q, k, v, keys: int):
    """Causal attention of one sequence: q (S, H, D), k / v (S, Hkv, D),
    QUERIES query rows at a time. Each row's softmax runs over `keys`
    entries (the positions past the sequence masked, as a served slot's
    row runs over the slot's length): float32's normalising sum then
    rounds as the served row's does, and a last-bit difference there can
    move a 4-bit chip input by a level."""
    s, h, d = q.shape
    rep = h // k.shape[1]
    pad = (0, 0, 0, 0, 0, max(keys - s, 0))
    k = torch.nn.functional.pad(torch.repeat_interleave(k, rep, dim=1),
                                pad).double()
    v = torch.nn.functional.pad(torch.repeat_interleave(v, rep, dim=1),
                                pad).double()
    pos = torch.arange(k.shape[0], device=q.device)
    out = []
    for i in range(0, s, QUERIES):
        j = min(i + QUERIES, s)
        logits = torch.einsum("qhd,khd->hqk", q[i:j].double(),
                              k).to(torch.float32) * (1.0 / math.sqrt(d))
        mask = pos[i:j, None] >= pos[None, :]
        logits = torch.where(mask[None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out.append(torch.einsum("hqk,khd->qhd", probs.double(), v).to(
            torch.float32))
    return torch.cat(out)


def _chips(w: Dict[str, torch.Tensor], x_cal: Dict[str, torch.Tensor],
           names: Sequence[str], cfg, tf32: bool):
    return {n: Chip(w[n], x_cal[n], alpha=cfg["in_alpha"],
                    in_bits=cfg["cim_in_bits"], out_bits=cfg["cim_out_bits"],
                    tf32=tf32) for n in names}


def moe_ffn(x2, p, xc_experts, chips, cfg, tf32: bool):
    """x2 (T, d): routed experts (each its own chip, compiled here from
    its weights and batches) combined per token in ascending expert id
    from zeros, then the shared experts' chips added."""
    k, n_exp = cfg["top_k"], cfg["n_experts"]
    logits = (x2.double() @ p["router"].double()).to(torch.float32)
    top, idx = torch.topk(logits, k, dim=-1)
    gate = torch.softmax(top, dim=-1)
    t, d = x2.shape
    contrib = torch.zeros((t, k, d), dtype=torch.float32, device=x2.device)
    for e in range(n_exp):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        ch = _chips({n: p[n][e] for n in EXPERT}, xc_experts[e], EXPERT,
                    cfg, tf32)
        xe = x2[tok]
        h = F.silu(ch["ew_g"](xe)) * ch["ew_i"](xe)
        contrib[tok, slot] = ch["ew_o"](h) * gate[tok, slot][:, None]
    # each token's k contributions in ascending expert id
    order = torch.argsort(idx, dim=-1)
    parts = torch.gather(contrib, 1, order[..., None].expand(t, k, d))
    y = torch.zeros((t, d), dtype=torch.float32, device=x2.device)
    for r in range(k):
        y = y + parts[:, r]
    hs = F.silu(chips["sw_g"](x2)) * chips["sw_i"](x2)
    return y + chips["sw_o"](hs)


def logits(params, x_cal, seqs: List[torch.Tensor], cfg, keys: int, *,
           tf32: bool = False) -> List[torch.Tensor]:
    """Teacher-forced logits (S_i, V) of each token sequence (S_i,) int.
    params: the raw weights as the benchmark made them ('embed' (V, d),
    'unembed' (d, V), 'ln_f', and 'layers' of (L, ...) stacks); x_cal:
    per layer, name -> (B, R) calibration batch, and for MoE 'experts':
    per expert, name -> batch. keys: the length each attention row's
    softmax runs over (`attention`). tf32: the control
    (`reference/cim.py`)."""
    moe = cfg["n_experts"] > 0
    names = SHARED if moe else DENSE
    nh, nkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, theta = cfg["rms_eps"], cfg["rope_theta"]
    lens = [int(s.numel()) for s in seqs]
    x = torch.cat([params["embed"][s.long()] for s in seqs]).to(
        torch.float32)
    lay = params["layers"]
    for li in range(cfg["n_layers"]):
        p = {n: v[li] for n, v in lay.items()}
        chips = _chips(p, x_cal[li], names, cfg, tf32)
        h = rms_norm(x, p["ln1"], eps)
        q, k, v = chips["wq"](h), chips["wk"](h), chips["wv"](h)
        outs, r0 = [], 0
        for n in lens:
            pos = torch.arange(n, device=x.device)
            qs = rope(q[r0:r0 + n].reshape(n, nh, hd), pos, theta)
            ks = rope(k[r0:r0 + n].reshape(n, nkv, hd), pos, theta)
            vs = v[r0:r0 + n].reshape(n, nkv, hd)
            outs.append(attention(qs, ks, vs, keys).reshape(n, nh * hd))
            r0 += n
        x = x + chips["wo"](torch.cat(outs))
        h2 = rms_norm(x, p["ln2"], eps)
        if moe:
            x = x + moe_ffn(h2, p, x_cal[li]["experts"], chips, cfg, tf32)
        else:
            x = x + chips["w_o"](F.silu(chips["w_g"](h2)) * chips["w_i"](h2))
        del chips
    x = rms_norm(x, params["ln_f"], eps)
    out, r0 = [], 0
    for n in lens:
        with precision(tf32):
            out.append(x[r0:r0 + n] @ params["unembed"])
        r0 += n
    return out
