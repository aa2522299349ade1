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

Where an engine call has a span buffer active (`obs/trace.span`),
`moe_ffn` records its phases as host spans: "moe.router", "moe.dispatch",
"moe.experts", "moe.combine" and "moe.shared". "moe.experts" carries the
routed rows of each expert (`routed_rows`: the routes sorted to it, all
kept when dropless), taken from the dispatch's group starts, which stay
on the device until the engine's synchronize (`TraceBuffer.resolve`):
recording adds no synchronize. With no buffer active nothing is kept.

`moe_ffn_ep_shardmap` is the reference's explicit expert parallelism
(float only, for training): on a `launch/mesh.Mesh`, each (data, model)
device routes its own tokens, sends each route to the device that owns
its expert, runs its local experts on what it received and sends the
results back, the all-to-all written as an ordered exchange between the
shards (below). `dense_block` takes it when cfg.moe_impl == "ep",
MESH_FOR_EP is set and the chips are not serving (cim_mode != "packed").
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..obs.trace import span

# The mesh `moe_ffn_ep_shardmap` runs on when cfg.moe_impl == "ep" (set by
# the launcher, as in the reference; `ep_mesh` sets it for a block of code)
MESH_FOR_EP = None


@contextlib.contextmanager
def ep_mesh(mesh):
    """MESH_FOR_EP set to `mesh` inside the block, restored after."""
    global MESH_FOR_EP
    old, MESH_FOR_EP = MESH_FOR_EP, mesh
    try:
        yield mesh
    finally:
        MESH_FOR_EP = old


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


def _combine(contrib, order, t: int, k: int):
    """(T, d): the reference's `zeros.at[st].add(contrib)` over the sorted
    slots, without atomics: each token's k contributions gathered in
    sorted-slot order and summed left to right from zeros (module
    docstring). order: the sort's permutation of the T * k slots (token
    id = slot // k)."""
    where = torch.empty_like(order)
    where[order] = torch.arange(t * k, device=order.device)  # slot -> pos
    by_token = torch.sort(where.reshape(t, k), dim=-1).values
    parts = contrib[by_token]                           # (T, k, d)
    y2 = torch.zeros((t, contrib.shape[-1]), dtype=contrib.dtype,
                     device=contrib.device)
    for r in range(k):
        y2 = y2 + parts[:, r]
    return y2


def routed_rows(start, routes: int):
    """Rows routed to each expert from the group starts of the routes
    sorted by expert (`start`, one per expert) and their number."""
    return [b - a for a, b in zip(start, list(start[1:]) + [routes])]


def moe_ffn(p: Dict, x, cfg, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (B, S, d). Sort-based capacity-padded dispatch
    (module docstring)."""
    from .transformer import routed_linear
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    dev = x.device
    x2 = x.reshape(t, d)

    with span("moe.router"):
        gate, idx = _router(x2, p["router"], k)         # (T, k)
    with span("moe.dispatch"):
        flat_e = idx.reshape(-1)                        # (T*k,)
        flat_g = gate.reshape(-1)
        flat_t = torch.arange(t, device=dev)[:, None].expand(t, k) \
            .reshape(-1)

        order = torch.argsort(flat_e, stable=True)      # stable by expert
        se, st, sg = flat_e[order], flat_t[order], flat_g[order]

        cap = capacity(t, cfg, capacity_factor)
        # position of each sorted slot within its expert group
        start = torch.searchsorted(se, torch.arange(e, device=dev),
                                   side="left")
        pos_in_e = torch.arange(t * k, device=dev) - start[se]
        keep = pos_in_e < cap                           # capacity drop

        # gather the routes into (E, cap, d); dropped ones to the dump row
        slot = torch.where(keep, se * cap + pos_in_e, e * cap)
        xe = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
        xe[slot] = x2[st]
        xe = xe[:-1].reshape(e, cap, d)

    # the experts: one launch per expert chip and projection when packed
    with span("moe.experts") as sp:
        if sp:
            sp.defer("routed_rows", start,
                     lambda v: routed_rows(v, t * k))
        h = F.silu(_expert_matmul(p, "ew_g", xe, cfg, seed=11)) \
            * _expert_matmul(p, "ew_i", xe, cfg, seed=211)
        ye = _expert_matmul(p, "ew_o", h, cfg, seed=411)    # (E, cap, d)

    # combine: each token's k contributions in sorted-slot order
    # (ascending expert id), summed from zeros
    with span("moe.combine"):
        ye_flat = ye.reshape(e * cap, d)
        contrib = ye_flat[torch.where(keep, se * cap + pos_in_e, 0)] \
            * (sg * keep)[:, None].to(x.dtype)
        y2 = _combine(contrib, order, t, k)

    with span("moe.shared"):
        if cfg.n_shared_experts > 0 and cfg.cim_mode == "packed":
            hs = F.silu(routed_linear(x2, p, "sw_g", cfg, seed=611)) \
                * routed_linear(x2, p, "sw_i", cfg, seed=612)
            y2 = y2 + routed_linear(hs, p, "sw_o", cfg, seed=613)
        elif cfg.n_shared_experts > 0:
            # the noisy / chipsim training modes keep the shared experts'
            # float matmuls, as the reference does
            hs = F.silu(x2 @ p["sw_g"]) * (x2 @ p["sw_i"])
            y2 = y2 + hs @ p["sw_o"]
    return y2.reshape(b, s, d)


def _ep_send(x2, router_w, cfg, ep: int, e_local: int,
             capacity_factor: float):
    """One device's routing and send buffer (the reference's local_fn up to
    its first all_to_all): its T tokens' top-k routes sorted stably by
    (owner device, expert), `cap` rows per owner, each row the token, its
    expert id + 1 (0 = padding) and its gate. Returns (send (ep, cap,
    d + 2), and what the combine needs: order, sd, pos, keep, sg, cap)."""
    t, d = x2.shape
    k = cfg.top_k
    dev = x2.device
    gate, idx = _router(x2, router_w, k)
    flat_e = idx.reshape(-1)
    flat_g = gate.reshape(-1)
    flat_t = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    dest = flat_e // e_local                            # owner device
    order = torch.argsort(dest * cfg.n_experts + flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    sd = dest[order]
    cap = int((t * k / ep) * capacity_factor) or 1
    start = torch.searchsorted(sd, torch.arange(ep, device=dev), side="left")
    pos = torch.arange(t * k, device=dev) - start[sd]
    keep = pos < cap
    slot = torch.where(keep, sd * cap + pos, ep * cap)
    send = torch.zeros((ep * cap + 1, d + 2), dtype=x2.dtype, device=dev)
    send[slot] = torch.cat([x2[st], (se + 1)[:, None].to(x2.dtype),
                            sg[:, None].to(x2.dtype)], -1)
    return send[:-1].reshape(ep, cap, d + 2), (order, sd, pos, keep, sg, cap)


def _ep_experts(recv, ew_g, ew_i, ew_o, first: int, e_local: int,
                stats: Optional[dict]):
    """The receiver (the reference's local_fn between its two all_to_alls):
    the (ep, cap, d + 2) rows it received grouped stably by local expert,
    cap_l = max(int(ec / e_local * 1.25), 4) rows each, through its
    e_local experts' SwiGLU; returns the (ep, cap, d) results in the
    received order (a dropped or padding row gives zeros)."""
    ep, cap, d2 = recv.shape
    d = d2 - 2
    ec = ep * cap
    dev = recv.device
    xr = recv[..., :d].reshape(ec, d)
    er = recv[..., d].to(torch.int64).reshape(ec)       # 0 = padding
    el = torch.where(er > 0, er - 1 - first, e_local)   # padding -> overflow
    order2 = torch.argsort(el, stable=True)
    el_s = el[order2]
    cap_l = max(int(ec / e_local * 1.25), 4)
    start2 = torch.searchsorted(el_s, torch.arange(e_local, device=dev),
                                side="left")
    pos2 = torch.arange(ec, device=dev) \
        - start2[torch.clamp(el_s, 0, e_local - 1)]
    keep2 = (pos2 < cap_l) & (el_s < e_local)
    slot2 = torch.where(keep2, el_s * cap_l + pos2, e_local * cap_l)
    xe = torch.zeros((e_local * cap_l + 1, d), dtype=recv.dtype, device=dev)
    xe[slot2] = xr[order2]
    xe = xe[:-1].reshape(e_local, cap_l, d)
    h = F.silu(torch.einsum("etd,edf->etf", xe, ew_g)) \
        * torch.einsum("etd,edf->etf", xe, ew_i)
    ye = torch.einsum("etf,efd->etd", h, ew_o).reshape(e_local * cap_l, d)
    contrib2 = ye[torch.where(keep2, slot2, 0)] \
        * keep2[:, None].to(recv.dtype)
    yr = torch.zeros((ec, d), dtype=recv.dtype, device=dev)
    yr[order2] = contrib2
    if stats is not None:
        stats["dropped_recv"] = stats.get("dropped_recv", 0) + int(
            ((~keep2) & (el_s < e_local)).sum())
    return yr.reshape(ep, cap, d)


def moe_ffn_ep_shardmap(p: Dict, x, cfg, mesh, capacity_factor: float = 1.25,
                        data_axes=("pod", "data"), model_axis: str = "model",
                        stats: Optional[dict] = None):
    """Explicit expert parallelism on `mesh` (a `launch/mesh.Mesh`): the
    experts split over `model_axis` (device j of a row owns experts
    j * E/ep .. (j+1) * E/ep - 1), x (B, S, d) striped over the data axes
    and, where S % ep == 0, its sequence over `model_axis` (the
    reference's xspec; otherwise every device of a row takes the row's
    whole stripe, and device 0's result stands for the row's, as
    shard_map's replicated out_specs does). Float only: packed serving
    takes `moe_ffn` (dense_block).

    Per data row, in the reference's order: every device routes its tokens
    and packs its send buffer (`_ep_send`); the all_to_all is an ordered
    exchange — device j' receives block j' of every device's buffer,
    stacked in device order j = 0 .. ep - 1, moved to its device; each
    device runs its experts (`_ep_experts`); the second exchange returns
    block j of every device's results to device j, in order; each device
    combines its routes' results per token in sorted-slot order, from
    zeros (`_combine`). The shared experts are added after, on the whole
    x. It drops the routes the reference drops; stats, when given, counts
    them ("dropped_send", "dropped_recv")."""
    sizes = mesh.shape
    axes = [a for a in data_axes if a in mesh.axis_names]
    ep = sizes[model_axis]
    e_local = cfg.n_experts // ep
    b, s, d = x.shape
    n_rows = math.prod(sizes[a] for a in axes)
    if b % n_rows or cfg.n_experts % ep:
        raise ValueError(f"batch {b} over {n_rows} data rows and "
                         f"{cfg.n_experts} experts over {ep} devices must "
                         "divide")
    seq_ok = s % ep == 0
    b_l, s_l = b // n_rows, (s // ep if seq_ok else s)
    k = cfg.top_k
    y = torch.empty_like(x)
    for r, pos in enumerate(itertools.product(
            *(range(sizes[a]) for a in axes))):
        at = dict(zip(axes, pos))
        devs = [mesh.device_at(dict(at, **{model_axis: j}))
                for j in range(ep)]
        rows = slice(r * b_l, (r + 1) * b_l)
        sends, metas = [], []
        for j, dev in enumerate(devs):
            cols = slice(j * s_l, (j + 1) * s_l) if seq_ok else slice(0, s)
            x2 = x[rows, cols].reshape(-1, d).to(dev)
            send, meta = _ep_send(x2, p["router"].to(dev), cfg, ep, e_local,
                                  capacity_factor)
            sends.append(send)
            metas.append(meta)
            if stats is not None:
                stats["dropped_send"] = stats.get("dropped_send", 0) + int(
                    (~meta[3]).sum())
        results = []
        if r == 0:      # one device's share of the two exchanges
            from ..distributed.sharding import tally
            tally("all-to-all", sends[0].numel() * sends[0].element_size()
                  + sends[0].numel() // (d + 2) * d * x.element_size(), 2)
        for j, dev in enumerate(devs):
            recv = torch.stack([sd_[j].to(dev) for sd_ in sends])
            ew = [p[n][j * e_local:(j + 1) * e_local].to(dev)
                  for n in ("ew_g", "ew_i", "ew_o")]
            results.append(_ep_experts(recv, *ew, j * e_local, e_local,
                                       stats))
        for j, dev in enumerate(devs):
            if not seq_ok and j > 0:
                break           # the row's devices computed the same stripe
            back = torch.stack([res[j].to(dev) for res in results])
            order, sd, pos_, keep, sg, cap = metas[j]
            back2 = back.reshape(ep * cap, d)
            contrib = back2[torch.where(keep, sd * cap + pos_, 0)] \
                * (sg * keep)[:, None].to(x.dtype)
            t = b_l * s_l
            cols = slice(j * s_l, (j + 1) * s_l) if seq_ok else slice(0, s)
            y[rows, cols] = _combine(contrib, order, t, k).reshape(
                b_l, s_l, d).to(x.device)
    if cfg.n_shared_experts > 0:
        x2 = x.reshape(-1, d)
        hs = F.silu(x2 @ p["sw_g"]) * (x2 @ p["sw_i"])
        y = y + (hs @ p["sw_o"]).reshape(b, s, d)
    return y
