"""Analytic MODEL_FLOPS per (arch x shape) — the 'useful compute' yardstick
(port of `repro/launch/roofline.py`, the reference's conventions):

  * matmul params N_eff = all >=2D matmul weights, embeddings-as-lookup
    excluded, unembedding included (tied embeddings add d*V once);
  * MoE expert stacks scaled by top_k / n_experts (active fraction);
  * zamba2's weight-shared attention block counts once per invocation
    (n_layers // hybrid_attn_every);
  * train = 6 * N_eff * tokens + 3 * attn_fwd;  prefill = 2 * N_eff * tokens
    + attn_fwd;  decode = (2 * N_eff + attn_decode) per generated token;
  * attn_fwd counts the full (uncausal) score + PV matmuls: 4 * B * S^2 *
    H * hd per attention layer.

The param shapes come from `models.transformer.init_params` on the `meta`
device: nothing is allocated.
"""
from __future__ import annotations

from ..models import transformer as T


def _leaves(tree, path=()):
    """(path of keys, tensor) of every leaf of a nested dict of params."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _n_eff(cfg: T.ArchConfig) -> float:
    params = T.init_params(cfg, device="meta")
    total = 0.0
    for keys, leaf in _leaves(params):
        last = keys[-1]
        if leaf.dim() < 2:
            continue
        if last == "embed":
            if cfg.tie_embeddings:
                total += leaf.numel()     # reused as unembedding matmul
            continue
        if last in ("mu", "cmu", "u", "vis_proj"):
            continue
        frac = 1.0
        if str(last).startswith("ew_"):
            frac = cfg.top_k / cfg.n_experts
        if "shared_attn" in keys:
            # one copy of the params, executed (L // every) times
            frac = float(cfg.n_layers // cfg.hybrid_attn_every)
        total += leaf.numel() * frac
    return float(total)


def _n_attn_layers(cfg: T.ArchConfig) -> int:
    if cfg.rwkv:
        return 0
    if cfg.ssm_state > 0:
        return cfg.n_layers // max(cfg.hybrid_attn_every, 1) \
            if cfg.hybrid_attn_every else 0
    return cfg.n_layers


def model_flops(cfg: T.ArchConfig, shape) -> float:
    b, s = shape.global_batch, shape.seq_len
    n_eff = _n_eff(cfg)
    h, hd = cfg.n_heads, cfg.head_dim
    n_attn = _n_attn_layers(cfg)
    attn_full = 4.0 * b * s * s * h * hd * n_attn
    if cfg.enc_layers > 0:
        attn_full += 4.0 * b * s * s * h * hd * cfg.enc_layers
    tokens = b * s
    if shape.kind == "train":
        return 6.0 * n_eff * tokens + 3.0 * attn_full
    if shape.kind == "prefill":
        return 2.0 * n_eff * tokens + attn_full
    # decode: one token per request against an s-deep cache
    attn_dec = 4.0 * b * s * h * hd * n_attn
    return 2.0 * n_eff * b + attn_dec
