"""Mixture-of-Experts FFN: deepseek-moe's fine-grained shared + routed
experts, llama4's (PyTorch port of `moe_ffn` in `repro/models/moe.py`).

`moe_ffn` is the reference's sort-based dispatch with per-expert capacity:
every token's top_k routes are sorted (stably) by expert id, sliced into
fixed-capacity groups of `cap` rows per expert (a dropped route goes to a
dump row), run through the experts as one (E, cap, d) batch, and combined
back per token. Dropless dispatch (`cfg.moe_dropless`, forced on by the
continuous-batching engine) sets cap = T, so no route is dropped and a
token's output does not depend on the other tokens of its batch.

The NeuRRAM mapping (the reference's docstring): routed experts are the
chip's selectively power-gated CIM cores. Under cim_mode="packed" each
(layer, expert) has its own compiled chip (`nn.deploy_transformer_cim`)
and `_expert_matmul` runs expert e's whole (cap, d) group through its
chip as one kernel launch, seed base + e. EVERY expert launches on every
call, its group zero-padded to cap rows as in the reference: the shapes
stay static, so the slot pool's decode step is one CUDA graph. Shared
experts ride `cim_linear` like the dense projections (seeds 611-613)
when packed. Under the noisy and chipsim training modes the routed and
the shared experts both stay float, as in the reference.

Two orders are fixed so that runs are bit-reproducible on the card:
  * routing: `torch.topk` over f32 router logits, sorted descending (the
    reference's `lax.top_k`). The logits' dot products run in float64
    and are rounded once: a float32 GEMM sums in an order that depends on
    how many tokens share the call (a slot's decode row in a pool of 4 or
    alone, a prompt prefilled in one call or in chunks), and at a
    near-tie of two experts' logits a last-bit difference routes the
    token elsewhere;
  * the combine: the reference's `zeros.at[st].add(contrib)` applies a
    token's k contributions in sorted-slot order, ascending expert id,
    from zero. Here each token's k contributions are gathered in that
    order and summed left to right from zeros — never `index_add_`,
    whose CUDA atomics would add them in a different order every run.

On a tensor-parallel mesh (`cfg.cim_mesh`) whose 'model' width m
divides E, deploy places the expert chips expert-parallel
(`nn.place_packed_stack`: shard j holds experts j * E/m .. (j+1) * E/m -
1), and `_expert_matmul` launches each expert where its chip lies, with
the same seeds and order as on one device.
`moe_ffn_ep_shardmap` (all-to-all expert parallelism for training) waits
for training on a mesh (ROADMAP A18).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def _router(x2, router_w, top_k: int):
    """x2: (T, d) -> (gates (T, k), experts (T, k)): the top-k router
    logits in f32 (summed in float64, module docstring), descending, and
    their softmax."""
    logits = (x2.to(torch.float64) @ router_w.to(torch.float64)).to(
        torch.float32)
    gate, idx = torch.topk(logits, top_k, dim=-1)
    return torch.softmax(gate, dim=-1), idx


def _expert_matmul(p: Dict, name: str, xe, cfg, *, seed: int = 0):
    """Batched expert matmul (E, C, d) @ (E, d, f) -> (E, C, f): expert e's
    group through its own chip (p['<name>_cim'][e], one launch, seed
    seed + e) under cim_mode="packed", else the float einsum. Each
    expert's group launches where its chip lies (expert-parallel chips:
    module docstring); every launch is enqueued before the outputs come
    back to xe's device."""
    pcls = p.get(name + "_cim")
    if pcls is None or cfg.cim_mode != "packed":
        return torch.einsum("ecd,edf->ecf", xe, p[name])
    from . import nn as nn_mod
    ccfg = nn_mod.arch_cim_config(cfg)
    ys = [nn_mod.packed_linear(c, xe[e].to(c.packed.gd_tiles.device), ccfg,
                               seed=seed + e, impl=cfg.cim_impl)
          for e, c in enumerate(pcls)]
    return torch.stack([y.to(xe.device) for y in ys]).to(xe.dtype)


def capacity(t: int, cfg, capacity_factor: float = 1.25) -> int:
    """Rows per expert group for t tokens: t when dropless, else the
    reference's min(max(ceil(t * k / E * cf), 4), t * k) in Python
    floats."""
    if cfg.moe_dropless:
        return t
    k, e = cfg.top_k, cfg.n_experts
    return min(max(int(math.ceil(t * k / e * capacity_factor)), 4), t * k)


def moe_ffn(p: Dict, x, cfg, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (B, S, d). Sort-based capacity-padded dispatch
    (module docstring)."""
    from .transformer import routed_linear
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    dev = x.device
    x2 = x.reshape(t, d)

    gate, idx = _router(x2, p["router"], k)             # (T, k)
    flat_e = idx.reshape(-1)                            # (T*k,)
    flat_g = gate.reshape(-1)
    flat_t = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)

    order = torch.argsort(flat_e, stable=True)          # stable by expert
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]

    cap = capacity(t, cfg, capacity_factor)
    # position of each sorted slot within its expert group
    start = torch.searchsorted(se, torch.arange(e, device=dev), side="left")
    pos_in_e = torch.arange(t * k, device=dev) - start[se]
    keep = pos_in_e < cap                               # capacity drop

    # gather the routes into (E, cap, d); dropped ones to the dump row
    slot = torch.where(keep, se * cap + pos_in_e, e * cap)
    xe = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    xe[slot] = x2[st]
    xe = xe[:-1].reshape(e, cap, d)

    # the experts: one launch per expert chip and projection when packed
    h = F.silu(_expert_matmul(p, "ew_g", xe, cfg, seed=11)) \
        * _expert_matmul(p, "ew_i", xe, cfg, seed=211)
    ye = _expert_matmul(p, "ew_o", h, cfg, seed=411)    # (E, cap, d)

    # combine: each token's k contributions in sorted-slot order
    # (ascending expert id), summed from zeros
    ye_flat = ye.reshape(e * cap, d)
    contrib = ye_flat[torch.where(keep, se * cap + pos_in_e, 0)] \
        * (sg * keep)[:, None].to(x.dtype)
    where = torch.empty_like(order)
    where[order] = torch.arange(t * k, device=dev)      # slot -> sorted pos
    by_token = torch.sort(where.reshape(t, k), dim=-1).values
    parts = contrib[by_token]                           # (T, k, d)
    y2 = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for r in range(k):
        y2 = y2 + parts[:, r]

    if cfg.n_shared_experts > 0 and cfg.cim_mode == "packed":
        hs = F.silu(routed_linear(x2, p, "sw_g", cfg, seed=611)) \
            * routed_linear(x2, p, "sw_i", cfg, seed=612)
        y2 = y2 + routed_linear(hs, p, "sw_o", cfg, seed=613)
    elif cfg.n_shared_experts > 0:
        # the noisy / chipsim training modes keep the shared experts' float
        # matmuls, as the reference does
        hs = F.silu(x2 @ p["sw_g"]) * (x2 @ p["sw_i"])
        y2 = y2 + hs @ p["sw_o"]
    return y2.reshape(b, s, d)
