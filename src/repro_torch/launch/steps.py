"""Train / prefill / decode step functions, the slot pool's steps and the
arch-dispatch table the serving driver runs through (PyTorch port of
`repro/launch/steps.py`: every family, the encoder-decoder's memory and
the VLM's vision prefix included; the model's family dispatch is
`models/transformer`'s).

The train step is the reference's: gradients of `transformer.lm_loss` on
every leaf of the stacked (L, ...) params by autograd, summed in f32 over
`accum` microbatches, the global norm clipped to 1, then AdamW with f32
moments. It updates params and optimizer state IN PLACE, leaf by leaf and
in chunks of ADAMW_CHUNK elements (the reference donates both buffers):
a tree-at-once update would hold the old and the new f32 moments together,
34 GB more at qwen2-72b's full width, two layers deep.

On a mesh (`launch/mesh.Mesh`: `mesh` with `data_axes` and / or a ZeRO
`grad_spec`) the step places what the reference leaves to GSPMD
(`_mesh_train_step`): each microbatch striped over the data rows, each
row's gradients on its own device, summed over the rows in row order,
and, with `grad_spec`, reduce-scattered so that AdamW runs on each shard
beside its moment shard."""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple

import torch

from ..device import resolve_device
from ..models import transformer as T
from ..obs.capturewatch import signature, tensors
from ..obs.trace import span
from ..train.noisy import value_and_grad
from ..train.optimizer import tree_leaves, tree_map, tree_unflatten


class ArchServing(NamedTuple):
    """Serving entry points for one architecture, with normalized
    signatures:

      init_params(seed)                                -> params
      init_state(batch, max_len)                       -> decode cache
      prefill(params, state, tokens, memory=None)      -> (logits, state)
      decode_step(params, state, tokens, memory=None)  -> (logits, state)
      deploy_cim(params, **kw)             -> params with '_cim' entries
                                              (kw: mode, spec, mesh_shape,
                                              mesh, x_cal, ...)

    memory: an encoder-decoder's encoded source (`transformer._encode`).
    """
    init_params: Callable
    init_state: Callable
    prefill: Callable
    decode_step: Callable
    deploy_cim: Callable


def arch_serving(cfg: T.ArchConfig, device=None) -> ArchServing:
    """The serving entry-point table for `cfg` on `device`: CUDA unless
    the caller passes "cpu"; raises when CUDA is missing."""
    from ..models import nn
    dev = resolve_device(device)
    return ArchServing(
        init_params=lambda seed=0: T.init_params(cfg, seed=seed, device=dev),
        init_state=lambda batch, max_len: T.init_cache(
            cfg, batch, max_len, dtype=cfg.dtype, device=dev),
        prefill=lambda params, state, tokens, memory=None:
            T.prefill(params, tokens, state, cfg, memory=memory),
        decode_step=lambda params, state, tokens, memory=None:
            T.decode_step(params, state, tokens, cfg, memory=memory),
        deploy_cim=lambda params, **kw: nn.deploy_cim(params, cfg, **kw))


# ----------------------------------------------------------------- training

# elements of one leaf that AdamW and the gradient norm take at once: the
# f32 temporaries of qwen2-72b's 1.25 G-element embedding stay at 1 GB each
ADAMW_CHUNK = 1 << 28


def _chunks(*ts):
    """Matching chunks of at most ADAMW_CHUNK elements of same-shape
    tensors, views so that an in-place op writes through: flat chunks of
    contiguous ones; blocks of leading-dim rows where one is a strided
    view (a shard of a param or moment cut on an inner dim, which the
    meshed step updates in place)."""
    if all(t.is_contiguous() for t in ts):
        flat = [t.view(-1) for t in ts]
        for i in range(0, flat[0].numel(), ADAMW_CHUNK):
            yield [f[i:i + ADAMW_CHUNK] for f in flat]
        return
    n0 = ts[0].shape[0]
    step = max(1, ADAMW_CHUNK // max(ts[0].numel() // max(n0, 1), 1))
    for i in range(0, n0, step):
        yield [t[i:i + step] for t in ts]


def adamw_init_f32(params):
    """Optimizer state in f32 regardless of the params' (bf16) dtype: zero
    moments on each leaf's device, and the step count t (int32)."""
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(z, params), "v": tree_map(z, params),
            "t": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_apply(grads, state, params, lr, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.01):
    """One AdamW step in the reference's arithmetic: the moments in f32
    from the f32 gradient, each param updated in f32 and cast back to its
    dtype. Params and moments are updated in place (module docstring);
    returns (params, {"m", "v", "t"})."""
    t = state["t"] + 1
    tf = t.to(torch.float32)
    c1, c2 = (1 - torch.pow(torch.full((), b, dtype=torch.float32,
                                       device=t.device), tf)
              for b in (b1, b2))
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        for pc, gc, mc, vc in _chunks(p, g.contiguous(), m, v):
            g32 = gc.to(torch.float32)
            mc.mul_(b1).add_((1 - b1) * g32)
            vc.mul_(b2).add_((1 - b2) * torch.square(g32))
            upd = mc / c1
            upd.div_(torch.sqrt(vc / c2).add_(eps))
            p32 = pc.to(torch.float32)
            upd.add_(weight_decay * p32)
            pc.copy_(p32 - upd.mul_(lr))
    return params, {"m": state["m"], "v": state["v"], "t": t}


def clip_grads_(grads, max_norm: float):
    """`train/optimizer.clip_grads` in place: every gradient scaled by
    min(1, max_norm / (global norm + 1e-9)). Returns the global norm
    (`_clip_shards_`, each leaf one shard)."""
    leaves = tree_leaves(grads)
    return _clip_shards_([[g] for g in leaves], leaves[0].device, max_norm)


def _clip_shards_(g_sh, home, max_norm: float = 1.0):
    """The clip over per-leaf lists of shards: each leaf's sum of squares
    accumulated in f32 over its shards in index order (each in chunks)
    and rounded once to its dtype, as the reference's jnp.sum does; the
    norm on `home`; every shard scaled. Returns the norm."""
    sums = []
    for gs in g_sh:
        acc = torch.zeros((), dtype=torch.float32, device=home)
        for g in gs:
            part = torch.zeros((), dtype=torch.float32, device=g.device)
            for (c,) in _chunks(g.contiguous()):
                part += torch.sum(torch.square(c), dtype=torch.float32)
            acc += part.to(home)
        sums.append(acc.to(gs[0].dtype))
    gnorm = torch.sqrt(sum(sums))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    for gs in g_sh:
        for g in gs:
            g.mul_(scale.to(g.device))
    return gnorm


def loss_and_grads(params, batch, cfg: T.ArchConfig):
    """(loss, grads) of `transformer.lm_loss` by autograd on every leaf of
    `params` (zeros for a leaf the loss does not reach)."""
    loss, _, grads = value_and_grad(
        lambda p: (T.lm_loss(p, batch, cfg), None), params)
    return loss, grads


def make_train_step(cfg: T.ArchConfig, lr: float = 1e-4, accum: int = 1,
                    grad_spec=None, data_axes=None, mesh=None,
                    grad_sync: str = "micro"):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss,
    gnorm), params and state updated in place. accum > 1 splits the batch
    into `accum` microbatches (rows in order) run one after another, their
    gradients summed in f32 and divided by accum, as the loss.

    With `mesh` and `data_axes` and / or `grad_spec` (a spec tree over
    params, `distributed/sharding.zero_pspecs`) the step runs on the mesh
    (`_mesh_train_step`); grad_sync "micro" reduce-scatters after each
    microbatch, "once" after the accumulation."""
    if grad_sync not in ("micro", "once"):
        raise ValueError(f"grad_sync is 'micro' or 'once', got {grad_sync!r}")
    if mesh is None and (grad_spec is not None or data_axes):
        raise ValueError("grad_spec and data_axes place on a mesh: pass "
                         "mesh=")
    if mesh is not None and (grad_spec is not None or data_axes):
        return _mesh_train_step(cfg, lr, accum, grad_spec, data_axes, mesh,
                                grad_sync)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = loss_and_grads(params, batch, cfg)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(accum):
                l, g = loss_and_grads(params, _micro(batch, accum, i), cfg)
                for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(b.to(torch.float32))
                loss = loss + l
                del g
            loss = loss / accum
            for a in tree_leaves(grads):
                a.div_(accum)
        gnorm = clip_grads_(grads, 1.0)
        params, opt_state = adamw_apply(grads, opt_state, params, lr)
        return params, opt_state, loss, gnorm
    return train_step


def _micro(batch, accum: int, i: int):
    """Microbatch i of `accum`: rows i * n / accum .. (i + 1) * n / accum
    - 1 of every batch leaf (the reference's (accum, micro, ...)
    reshape)."""
    return {k: x.reshape((accum, x.shape[0] // accum) + x.shape[1:])[i]
            for k, x in batch.items()}


def _mesh_train_step(cfg, lr, accum, grad_spec, data_axes, mesh, grad_sync):
    """The train step on `mesh`, with the reference's arithmetic placed
    explicitly:

      * rows: the data rows of `mesh.rows(data_axes)` (one, the mesh's
        first, without data_axes); row r computes on its first 'model'
        device against a replica of the params (`.to`: the params
        themselves where that is their device);
      * each microbatch's rows split into R equal stripes, stripe r to
        row r (the reference's (accum, micro, ...) placement), which runs
        `lm_loss` and its gradients there; under cfg.moe_impl "ep" row r's
        expert-parallel FFN runs on row r's devices of moe.MESH_FOR_EP;
      * the gradient of a microbatch is the row-order f32 sum of the rows'
        gradients divided by R (the mean of equal stripes' means), taken
        per shard of `grad_spec` (a leaf's shard i is `shard_slice(leaf,
        spec, mesh.shape, spec_indices[i])` on `spec_devices[i]`; without
        grad_spec one shard, the whole leaf on its own device): the
        reduce-scatter. grad_sync "micro" adds it into f32 shard
        accumulators after each microbatch; "once" keeps one full f32
        accumulator per row and reduce-scatters after the last, the same
        sums in another order. With accum 1 the result is rounded to the
        params' dtype, as the reference's unaccumulated gradient is;
      * the global norm's per-leaf sums of squares add the shards' f32
        sums in index order; the clip scales every shard;
      * AdamW (`adamw_apply`, unchanged) runs on each shard with its
        moment shards on the shard's device, one call per device; a shard
        that is not a view of the params is copied back into them, which
        every row's replica copies at the next step.

    With grad_spec the returned state holds the moments as
    `distributed/sharding.Sharded` leaves (opt_pspecs(grad_spec)),
    which the next call takes as they are; a plain moment tree is cut at
    the first call (views, where the shard's device is the moment's).

    The exchanges are tallied (`distributed/sharding.collective_tally`,
    bytes one device receives): the replicas and the write-back of the
    updated shards as all-gathers, each microbatch's reduce-scatter (an
    all-reduce without grad_spec), the loss's and the norm's row sums as
    all-reduces."""
    from ..distributed.sharding import P, Sharded, microbatch, nbytes, \
        shard_shape, shard_slice, spec_devices, spec_indices, tally
    from ..models import moe
    rows = mesh.rows(data_axes or ())
    n_rows = len(rows)
    row_devs = [r.devices[0][0] for r in rows]
    sizes = mesh.shape

    def layouts(params):
        specs = tree_leaves(grad_spec) if grad_spec is not None \
            else [None] * len(tree_leaves(params))
        out = []
        for p, sp in zip(tree_leaves(params), specs):
            if sp is None:
                out.append((P(), ({},), (p.device,)))
            else:
                out.append((P(*sp), spec_indices(mesh, sp),
                            spec_devices(mesh, sp)))
        return out

    def cut(x, lay):
        spec, idx, devs = lay
        return [shard_slice(x, spec, sizes, at).to(dev)
                for at, dev in zip(idx, devs)]

    def moment_shards(tree, lays):
        out = []
        for x, lay in zip(tree_leaves(tree), lays):
            if isinstance(x, Sharded):
                if x.spec != lay[0]:
                    raise ValueError(f"a moment shard's spec {x.spec} is "
                                     f"not the gradient's {lay[0]}")
                out.append(list(x.shards))
            else:
                out.append(cut(x, lay))
        return out

    def ep_context(r):
        if moe.MESH_FOR_EP is None or n_rows == 1:
            return contextlib.nullcontext()
        ep_rows = moe.MESH_FOR_EP.rows(data_axes or ())
        if len(ep_rows) != n_rows:
            raise ValueError(f"MESH_FOR_EP has {len(ep_rows)} data rows, "
                             f"the train step {n_rows}")
        return moe.ep_mesh(ep_rows[r])

    def row_grads(replicas, mb):
        """Yield (row, loss, grads) for each row's stripe of `mb`."""
        n = mb["tokens"].shape[0]
        if n % n_rows:
            raise ValueError(f"a microbatch of {n} rows does not stripe "
                             f"over {n_rows} data rows")
        m = n // n_rows
        for r in range(n_rows):
            stripe = {k: v[r * m:(r + 1) * m].to(row_devs[r])
                      for k, v in mb.items()}
            with ep_context(r):
                loss, grads = loss_and_grads(replicas[r], stripe, cfg)
            yield r, loss, tree_leaves(grads)

    def exchange(leaves_, lays):
        """Tally one reduce-scatter of the rows' f32 gradients."""
        shard = sum(nbytes(shard_shape(x.shape, lay[0], sizes),
                           torch.float32) for x, lay in zip(leaves_, lays))
        tally("reduce-scatter" if grad_spec is not None else "all-reduce",
              shard, len(leaves_))

    def add_slices(acc, leaves_, lays):
        """acc (per leaf, per shard, f32 on the shard's device) plus the
        slices of one row's leaves; None starts it with a copy."""
        if acc is None:
            return [[shard_slice(x, lay[0], sizes, at).to(
                dev, torch.float32, copy=True)
                for at, dev in zip(lay[1], lay[2])]
                for x, lay in zip(leaves_, lays)]
        for shards, x, lay in zip(acc, leaves_, lays):
            for a, at in zip(shards, lay[1]):
                a.add_(shard_slice(x, lay[0], sizes, at).to(
                    a.device, torch.float32))
        return acc

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        lays = layouts(params)
        home = leaves[0].device
        replicas = [tree_map(lambda p, d=d: p.to(d), params)
                    for d in row_devs]
        whole = sum(nbytes(p.shape, p.dtype) for p in leaves)
        if n_rows > 1:
            tally("all-gather", whole, len(leaves))
        once = grad_sync == "once" and accum > 1
        g_sh = None                       # per leaf, per shard (f32)
        acc_rows = [None] * n_rows        # "once": per row, full f32
        loss = None
        for i in range(accum):
            mb = _micro(batch, accum, i) if accum > 1 else batch
            l_sum, micro = None, None
            with microbatch():
                for r, l, g in row_grads(replicas, mb):
                    l = l.to(home, torch.float32)
                    l_sum = l if l_sum is None else l_sum + l
                    if once:
                        if acc_rows[r] is None:
                            acc_rows[r] = [x.to(torch.float32, copy=True)
                                           for x in g]
                        else:
                            for a, x in zip(acc_rows[r], g):
                                a.add_(x.to(torch.float32))
                    else:             # reduce-scatter as the rows come
                        micro = add_slices(micro, g, lays)
                    del g
                l_micro = l_sum / n_rows
                loss = l_micro if loss is None else loss + l_micro
                if n_rows > 1:
                    tally("all-reduce", 4)
                if micro is not None:
                    exchange(leaves, lays)
                    for shards in micro:
                        for a in shards:
                            a.div_(n_rows)
                    if g_sh is None:
                        g_sh = micro
                    else:
                        for gs, ms in zip(g_sh, micro):
                            for a, b in zip(gs, ms):
                                a.add_(b)
                    del micro
        if once:
            exchange(leaves, lays)
            for r in range(n_rows):
                g_sh = add_slices(g_sh, acc_rows[r], lays)
                acc_rows[r] = None
            for shards in g_sh:
                for a in shards:
                    a.div_(n_rows)
        if accum > 1:
            loss = loss / accum
            for gs in g_sh:
                for a in gs:
                    a.div_(accum)
        else:
            g_sh = [[a.to(p.dtype) for a in gs]
                    for gs, p in zip(g_sh, leaves)]
        gnorm = _clip_shards_(g_sh, home)
        if grad_spec is not None:
            tally("all-reduce", 4 * len(leaves), len(leaves))
        p_sh = [cut(p, lay) for p, lay in zip(leaves, lays)]
        m_sh = moment_shards(opt_state["m"], lays)
        v_sh = moment_shards(opt_state["v"], lays)
        by_dev: Dict[torch.device, list] = {}
        for li, lay in enumerate(lays):
            for k, dev in enumerate(lay[2]):
                by_dev.setdefault(dev, []).append(
                    (p_sh[li][k], g_sh[li][k], m_sh[li][k], v_sh[li][k]))
        t = opt_state["t"]
        for dev, items in by_dev.items():
            ps, gs, ms, vs = (list(z) for z in zip(*items))
            adamw_apply(gs, {"m": ms, "v": vs, "t": t.to(dev)}, ps, lr)
        if grad_spec is not None:
            tally("all-gather", whole, len(leaves))
        for p, lay, shards in zip(leaves, lays, p_sh):
            for at, sh in zip(lay[1], shards):
                view = shard_slice(p, lay[0], sizes, at)
                if view.device != sh.device \
                        or view.data_ptr() != sh.data_ptr():
                    view.copy_(sh.to(p.device))
        state = {"m": opt_state["m"], "v": opt_state["v"], "t": t + 1}
        if grad_spec is not None:
            for key, sh in (("m", m_sh), ("v", v_sh)):
                state[key] = tree_unflatten(opt_state[key], [
                    Sharded(s_, lay[0], mesh, p.shape)
                    for s_, lay, p in zip(sh, lays, leaves)])
        return params, state, loss, gnorm
    return train_step


def make_prefill_step(cfg: T.ArchConfig):
    """prefill_step(params, cache, batch) -> (logits, cache); runs where
    params and cache lie. batch: {"tokens": (B, S)}, and for an
    encoder-decoder "src_embeds" (B, S_src, d), encoded here, or the
    encoded "memory"; for a VLM optionally "vis_embeds" (B, P, d), run into
    the cache ahead of the tokens (`_prefix_embeds`)."""
    def prefill_step(params, cache, batch):
        memory = batch.get("memory")
        if cfg.enc_layers > 0 and memory is None:
            memory = T._encode(params, batch["src_embeds"], cfg)
        if cfg.vis_patches > 0 and batch.get("vis_embeds") is not None:
            cache = _prefix_embeds(params, cache, batch["vis_embeds"], cfg)
        return T.prefill(params, batch["tokens"], cache, cfg, memory=memory)
    return prefill_step


def _prefix_embeds(params, cache, emb, cfg: T.ArchConfig):
    """Run raw embeddings (B, P, d) — no token lookup, no embedding scale —
    through the decoder blocks into the cache at its fill, as the
    reference does (its logits unused): the cache, its fill advanced by
    P."""
    pos = cache["len"]
    positions = pos + torch.arange(emb.shape[1], device=emb.device)
    x = emb.to(cfg.dtype)
    for li in range(cfg.n_layers):
        x, _ = T.dense_block(T.layer_params(params, li), x, cfg,
                             positions=positions, layer_idx=li,
                             cache=(cache["k"][li], cache["v"][li]),
                             cache_len=pos)
    return {"k": cache["k"], "v": cache["v"], "len": pos + emb.shape[1]}


def make_decode_step(cfg: T.ArchConfig):
    """decode_step(params, cache, {"tokens": (B, 1)}) -> (logits, cache);
    runs where params and cache lie; an encoder-decoder's batch also
    carries its "memory"."""
    def decode_step(params, cache, batch):
        return T.decode_step(params, cache, batch["tokens"], cfg,
                             memory=batch.get("memory"))
    return decode_step


# ------------------------------------------------- slotted pool (scheduler)

# Bookkeeping tensors the continuous-batching pool adds beside the arch's
# cache (launch/scheduler.init_pool):
#   active: (B,) bool   slot is decoding (free-slot bitmap = ~active)
#   tok:    (B,1) int32 each slot's last emitted token (decode input)
# The cache's "len" is widened from an int to a per-slot (B,) int32 tensor.
# Every step below updates the pool's tensors IN PLACE, so their addresses
# never change: the engine captures the decode step once as a CUDA graph
# over them.
POOL_KEYS = ("active", "tok")


def _split_pool(pool):
    """pool -> (arch-native cache view, active, tok)."""
    native = {k: v for k, v in pool.items() if k not in POOL_KEYS}
    return native, pool["active"], pool["tok"]


def make_pool_decode_step(cfg: T.ArchConfig):
    """One decode step over the WHOLE slot pool: (params, pool) ->
    (logits (B, V), pool), the pool updated in place. Every slot steps
    through the model (the compiled chips are weight-stationary: one
    launch per projection serves every slot); an inactive slot's state is
    rewritten with what it held (key and value rows; the recurrent archs'
    S, x_tm, x_cm, h and the hybrid's ak / av, selected row by row
    against `active`), and its fill and token do not advance, so its
    state stays bit for bit as it was."""
    def step(params, pool):
        native, active, tok = _split_pool(pool)
        logits, new = T.decode_step(params, native, tok, cfg,
                                    write_mask=active)
        native["len"].copy_(torch.where(active, new["len"], native["len"]))
        nxt = torch.argmax(logits, -1).to(tok.dtype)[:, None]
        tok.copy_(torch.where(active[:, None], nxt, tok))
        return logits, pool
    return step


def make_slot_prefill_step(cfg: T.ArchConfig):
    """One prefill CHUNK into a single slot: (params, pool, tokens (1, C),
    slot) -> (logits (1, V), pool), the pool updated in place. The slot's
    cache is a view of the pool (the slot dim is axis 1 of every cache
    tensor) with its (1,) fill, run through the arch's prefill; the
    chunk's argmax lands in pool['tok'], so the final chunk seeds the
    slot's first decode token. The prefill writes the slot's state (KV,
    or the recurrent S / x_tm / x_cm / h and the hybrid's KV) through the
    view in place; the new fill is copied back here."""
    def chunk_step(params, pool, tokens, slot: int):
        native, _, tok = _split_pool(pool)
        view = {k: (v[slot:slot + 1] if k == "len" else v[:, slot:slot + 1])
                for k, v in native.items()}
        logits, new = T.prefill(params, tokens, view, cfg)
        view["len"].copy_(new["len"])
        tok[slot:slot + 1, 0].copy_(torch.argmax(logits[0]).to(tok.dtype))
        return logits, pool
    return chunk_step


class CapturedStep:
    """A step function run as a CUDA graph: the first call with a new input
    signature and set of tensor addresses runs the step once, eagerly on a
    side stream (loading the kernels and making the library's workspaces),
    returns that run's output and captures the step; every later call with
    the same tensors replays the graph and returns its static outputs,
    which the next replay overwrites. A capture or replay that fails
    raises, and so do CPU tensors.

    The kernels' launch counters (`counters`, the LAUNCHES of
    `kernels/build.py`) count wrapper calls, and a replay makes none: the
    capture's increments are taken back (captured, not launched) and each
    replay adds them (`per_replay`). `_cache_size()` is the number of
    captures, the compilations `obs.capturewatch` counts. The key's walk
    over the inputs and the replay are the host spans "step.key" and
    "step.replay" (`obs/trace.span`)."""

    def __init__(self, fun, counters: Dict[str, int]):
        self.fun = fun
        self.counters = counters
        self.per_replay: Dict[str, int] = {}
        self._graphs: Dict[tuple, tuple] = {}

    def _cache_size(self) -> int:
        return len(self._graphs)

    def __call__(self, *args):
        with span("step.key"):
            ts = [t for _, t in tensors(args)]
            dev = ts[0].device if ts else None
            if dev is None or dev.type != "cuda":
                raise ValueError(f"a captured step runs on CUDA tensors, "
                                 f"not on {dev}")
            key = signature(args) + tuple(t.data_ptr() for t in ts)
        if key not in self._graphs:
            return self._capture(key, args, dev)
        graph, out, per_replay = self._graphs[key]
        with span("step.replay"):
            graph.replay()
        for k, n in per_replay.items():
            self.counters[k] += n
        return out

    def _capture(self, key, args, dev):
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            out = self.fun(*args)
        torch.cuda.current_stream(dev).wait_stream(stream)
        before = dict(self.counters)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            static = self.fun(*args)
        per_replay = {k: n - before.get(k, 0)
                      for k, n in self.counters.items()}
        for k, n in per_replay.items():
            self.counters[k] -= n
        self.per_replay = per_replay
        self._graphs[key] = (graph, static, per_replay)
        return out
