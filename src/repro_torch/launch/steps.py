"""Prefill / decode step functions and the arch-dispatch table the serving
driver runs through (PyTorch port of the serving half of
`repro/launch/steps.py`; the dense family only — the recurrent and MoE
families wait for ROADMAP A7/A8)."""
from __future__ import annotations

from typing import Callable, NamedTuple

from ..device import resolve_device
from ..models import transformer as T


class ArchServing(NamedTuple):
    """Serving entry points for one architecture, with normalized
    signatures:

      init_params(seed)                    -> params
      init_state(batch, max_len)           -> decode cache
      prefill(params, state, tokens)       -> (logits, state)
      decode_step(params, state, tokens)   -> (logits, state)
      deploy_cim(params, **kw)             -> params with '_cim' entries
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
        prefill=lambda params, state, tokens:
            T.prefill(params, tokens, state, cfg),
        decode_step=lambda params, state, tokens:
            T.decode_step(params, state, tokens, cfg),
        deploy_cim=lambda params, **kw:
            nn.deploy_transformer_cim(params, cfg, **kw))


def make_prefill_step(cfg: T.ArchConfig):
    """prefill_step(params, cache, {"tokens": (B, S)}) -> (logits, cache);
    runs where params and cache lie."""
    def prefill_step(params, cache, batch):
        return T.prefill(params, batch["tokens"], cache, cfg)
    return prefill_step


def make_decode_step(cfg: T.ArchConfig):
    """decode_step(params, cache, {"tokens": (B, 1)}) -> (logits, cache);
    runs where params and cache lie."""
    def decode_step(params, cache, batch):
        return T.decode_step(params, cache, batch["tokens"], cfg)
    return decode_step
