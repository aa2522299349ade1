"""Prefill / decode step functions, the slot pool's steps and the
arch-dispatch table the serving driver runs through (PyTorch port of the
serving half of `repro/launch/steps.py`: every family, the encoder-
decoder's memory and the VLM's vision prefix included; the model's family
dispatch is `models/transformer`'s)."""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from ..device import resolve_device
from ..models import transformer as T
from ..obs.capturewatch import signature, tensors


class ArchServing(NamedTuple):
    """Serving entry points for one architecture, with normalized
    signatures:

      init_params(seed)                                -> params
      init_state(batch, max_len)                       -> decode cache
      prefill(params, state, tokens, memory=None)      -> (logits, state)
      decode_step(params, state, tokens, memory=None)  -> (logits, state)
      deploy_cim(params, **kw)             -> params with '_cim' entries

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
    captures, the compilations `obs.capturewatch` counts."""

    def __init__(self, fun, counters: Dict[str, int]):
        self.fun = fun
        self.counters = counters
        self.per_replay: Dict[str, int] = {}
        self._graphs: Dict[tuple, tuple] = {}

    def _cache_size(self) -> int:
        return len(self._graphs)

    def __call__(self, *args):
        ts = [t for _, t in tensors(args)]
        dev = ts[0].device if ts else None
        if dev is None or dev.type != "cuda":
            raise ValueError(f"a captured step runs on CUDA tensors, not "
                             f"on {dev}")
        key = signature(args) + tuple(t.data_ptr() for t in ts)
        if key not in self._graphs:
            return self._capture(key, args, dev)
        graph, out, per_replay = self._graphs[key]
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
