"""RWKV-6 "Finch" (attention-free, data-dependent decay) — rwkv6-7b
(PyTorch port of `repro/models/rwkv6.py`).

Per head (size N=64): state S in R^{NxN};
    w_t = exp(-exp(w_base + lora_w(x_t)))            (data-dependent decay)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)        (u = per-head bonus)
plus token-shift interpolation on the inputs of the r/k/v/w/g projections
and a gated (g) output. Channel-mix is the squared-relu K/V mix with token
shift. Prefill runs the time-chunked scan (chunks of 32, S carried between
chunks); decode carries S directly (O(1) state).

With cim_mode "packed" the time-mix and channel-mix projections serve from
per-layer compiled chips (`models/nn.deploy_recurrent_cim`) in the chunked
prefill and the decode alike; the decay LoRA and the S update stay float
(state-dependent: nothing weight-stationary to program).

Serving state is updated IN PLACE: `prefill` and `decode_step` copy each
layer's S, x_tm and x_cm into the state's tensors (a slot pool's view
included), so their addresses never change; decode's `write_mask` keeps a
row's state where it is False.

The float sums outside the chips — the decay LoRA's two products, and the
S update and readout of each scan chunk and decode step — run in float64
and are rounded to float32 once, with S stored in float32 between chunks
and steps. A float32 GEMM's summation order depends on how many rows share
the call (a slot served in a pool of 4 or alone, a prompt prefilled in one
call or in chunks), and a last-bit difference can move a 4-bit chip input
by a level; the float64 sums round to the same float32 values either way
(short of a tie within n 2^-53 of a float32 rounding boundary).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

HEAD = 64          # rwkv6 head size
LORA = 32          # decay lora rank


def layer_params(gen: torch.Generator, cfg, n_layers: int,
                 device=None) -> Dict:
    """Per-layer weights stacked over `n_layers`, in the reference's layout:
    projections normal / sqrt(fan_in), the token-shift mixes 0.5, the decay
    base and the bonus u zero."""
    d = cfg.d_model
    h = d // HEAD
    dev, dtype = device or gen.device, cfg.dtype

    def s(*sh):
        w = torch.randn((n_layers, *sh), generator=gen, device=dev)
        return (w * (1.0 / math.sqrt(sh[0]))).to(dtype)

    def full(v, *sh):
        return torch.full((n_layers, *sh), v, dtype=dtype, device=dev)

    return {
        "ln1": full(1.0, d), "ln2": full(1.0, d),
        "wr": s(d, d), "wk": s(d, d), "wv": s(d, d), "wg": s(d, d),
        "wo": s(d, d),
        "w_base": full(0.0, d),
        "w_lora_a": s(d, LORA), "w_lora_b": s(LORA, d),
        "mu": full(0.5, 5, d),
        "u": full(0.0, h, HEAD),
        "ck": s(d, cfg.d_ff), "cv": s(cfg.d_ff, d), "cr": s(d, d),
        "cmu": full(0.5, 2, d),
    }


def _token_shift(x, x_prev):
    """(B,T,d): the sequence shifted right by one; x_prev fills t=0."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _decay(p, xm):
    """w = exp(-exp(w_base + tanh(xm @ A) @ B)), the LoRA's products in
    float64 (module docstring)."""
    f64 = torch.float64
    a = torch.tanh((xm.to(f64) @ p["w_lora_a"].to(f64)).to(xm.dtype))
    wdec = p["w_base"] + (a.to(f64) @ p["w_lora_b"].to(f64)).to(xm.dtype)
    return torch.exp(-torch.exp(wdec.to(torch.float32)))


def _time_mix_chunk(p, x, x_last, S0, cfg, chunk: int = 32):
    """Chunked linear-attention evaluation of the RWKV-6 recurrence.

    x: (B,T,d). S0: (B,H,N,N) carry. Returns (y, S_T, x_T). Time is padded
    to a chunk multiple with steps of w = 1 (no decay), k = v = 0. Each
    chunk runs in float64 from the float32 S it starts from; its output
    and S are rounded to float32 (module docstring)."""
    from .transformer import routed_linear
    b, t, d = x.shape
    h = d // HEAD
    xs = _token_shift(x, x_last)
    mix = lambda i: x + (xs - x) * p["mu"][i]
    r = routed_linear(mix(0), p, "wr", cfg, seed=1).reshape(b, t, h, HEAD)
    k = routed_linear(mix(1), p, "wk", cfg, seed=2).reshape(b, t, h, HEAD)
    v = routed_linear(mix(2), p, "wv", cfg, seed=3).reshape(b, t, h, HEAD)
    w = _decay(p, mix(3)).reshape(b, t, h, HEAD)
    g = F.silu(routed_linear(mix(4), p, "wg", cfg, seed=4))

    chunk = min(chunk, t)
    t_pad = -t % chunk
    if t_pad:
        pad = (0, 0, 0, 0, 0, t_pad)
        r, k, v = F.pad(r, pad), F.pad(k, pad), F.pad(v, pad)
        w = F.pad(w, pad, value=1.0)
    t_eff = t + t_pad
    f64 = torch.float64
    u = p["u"].to(f64)
    cidx = torch.arange(chunk, device=x.device)
    causal = (cidx[:, None] > cidx[None, :])[None, :, :, None, None]

    S = S0.to(torch.float32)
    ys = []
    for c0 in range(0, t_eff, chunk):
        rc, kc, vc, wc = (a[:, c0:c0 + chunk].to(f64)   # (B, C, H, N)
                          for a in (r, k, v, w))
        # cumulative log-decay inside the chunk; every exponential below is
        # of a clipped non-positive quantity
        logw = torch.log(wc + 1e-38)
        cum = torch.cumsum(logw, dim=1)                   # inclusive
        cum_excl = cum - logw
        dec_in = torch.exp(cum_excl)                      # chunk start -> t-1
        dec_all = torch.exp(cum[:, -1:])                  # whole chunk
        y_state = torch.einsum("bchn,bhnm->bchm", rc * dec_in, S.to(f64))
        # intra-chunk, strictly causal (the diagonal is the bonus): the
        # factor for s -> t, s < t, is exp(cum_excl_t - cum_s) <= 1
        dpair = torch.exp(torch.clamp(cum_excl[:, :, None] - cum[:, None, :],
                                      -60.0, 0.0))        # (B,C,C,H,N)
        att = torch.einsum("bchn,bdhn,bcdhn->bhcd", rc, kc, dpair * causal)
        y_intra = torch.einsum("bhcd,bdhn->bchn", att, vc)
        bonus = torch.einsum("bchn,hn,bchn->bch", rc, u, kc)
        y_bonus = bonus[..., None] * vc
        # the state at the chunk's end: k_s decays by exp(cum_last - cum_s)
        k_carry = kc * torch.exp(torch.clamp(cum[:, -1:] - cum, -60.0, 0.0))
        S = (S.to(f64) * dec_all[:, 0, :, :, None]
             + torch.einsum("bchn,bchm->bhnm", k_carry, vc)).to(torch.float32)
        ys.append((y_state + y_intra + y_bonus).to(torch.float32))
    y = torch.cat(ys, dim=1).reshape(b, t_eff, d)[:, :t].to(x.dtype)
    return routed_linear(y * g, p, "wo", cfg, seed=5), S, x[:, -1]


def _channel_mix(p, x, x_last, cfg):
    from .transformer import routed_linear
    xs = _token_shift(x, x_last)
    xk = x + (xs - x) * p["cmu"][0]
    xr = x + (xs - x) * p["cmu"][1]
    kk = torch.square(F.relu(routed_linear(xk, p, "ck", cfg, seed=6)))
    return torch.sigmoid(routed_linear(xr, p, "cr", cfg, seed=7)) \
        * routed_linear(kk, p, "cv", cfg, seed=8)


def forward(params, x, cfg):
    """Teacher-forcing forward over every layer, each from a zero state."""
    from .transformer import layer_params as block, rms_norm
    b, t, d = x.shape
    h = d // HEAD
    for li in range(cfg.n_layers):
        p = block(params, li)
        S0 = torch.zeros((b, h, HEAD, HEAD), dtype=torch.float32,
                         device=x.device)
        zero = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        y, _, _ = _time_mix_chunk(p, rms_norm(x, p["ln1"]), zero, S0, cfg)
        x = x + y
        x = x + _channel_mix(p, rms_norm(x, p["ln2"]), zero, cfg)
    return x


# ------------------------------------------------------------- decode path

def init_state(cfg, batch: int, max_len: int, dtype, device):
    """Per-layer S (L,B,H,N,N) f32 and the two token-shift rows (L,B,d);
    the fill, an int (the slot pool widens it to a (B,) tensor). The state
    is constant-size: max_len does not enter it."""
    d = cfg.d_model
    h = d // HEAD
    return {
        "S": torch.zeros((cfg.n_layers, batch, h, HEAD, HEAD),
                         dtype=torch.float32, device=device),
        "x_tm": torch.zeros((cfg.n_layers, batch, d), dtype=dtype,
                            device=device),
        "x_cm": torch.zeros((cfg.n_layers, batch, d), dtype=dtype,
                            device=device),
        "len": 0,
    }


def _write(dst, new, mask):
    """dst <- new in place; rows (axis 0) where `mask` is False keep dst."""
    if mask is not None:
        new = torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new,
                          dst)
    dst.copy_(new)


def prefill(params, state, tokens, cfg):
    """Chunked prefill of a whole prompt (B, T), carrying each layer's
    state; returns (last-position logits, state), the state's tensors
    updated in place."""
    from .transformer import _embed, _unembed, _softcap, layer_params, \
        rms_norm
    x = _embed(params, tokens, cfg)                           # (B, T, d)
    t = x.shape[1]
    for li in range(cfg.n_layers):
        p = layer_params(params, li)
        xn = rms_norm(x, p["ln1"])
        y, S_T, x_tm = _time_mix_chunk(p, xn, state["x_tm"][li],
                                       state["S"][li], cfg)
        x = x + y
        xn2 = rms_norm(x, p["ln2"])
        x = x + _channel_mix(p, xn2, state["x_cm"][li], cfg)
        state["S"][li].copy_(S_T)
        state["x_tm"][li].copy_(x_tm)
        state["x_cm"][li].copy_(xn2[:, -1])
    x = rms_norm(x[:, -1], params["ln_f"])
    logits = _softcap((x @ _unembed(params, cfg)).to(torch.float32),
                      cfg.final_softcap)
    return logits, dict(state, len=state["len"] + t)


def decode_step(params, state, tokens, cfg, write_mask=None):
    """O(1)-state decode: tokens (B, 1) -> (logits (B, V), state). The
    projections route through `cim_linear` as in the chunked prefill (one
    launch per projection and step). write_mask: optional (B,) bool; rows
    where it is False keep their state bit for bit."""
    from .transformer import _embed, _unembed, _softcap, layer_params, \
        rms_norm, routed_linear
    x = _embed(params, tokens[:, 0], cfg)                     # (B, d)
    b, d = x.shape
    h = d // HEAD
    for li in range(cfg.n_layers):
        p = layer_params(params, li)
        S, x_tm, x_cm = state["S"][li], state["x_tm"][li], state["x_cm"][li]
        xn = rms_norm(x, p["ln1"])
        mix = lambda i: xn + (x_tm - xn) * p["mu"][i]
        r = routed_linear(mix(0), p, "wr", cfg, seed=1).reshape(b, h, HEAD)
        k = routed_linear(mix(1), p, "wk", cfg, seed=2).reshape(b, h, HEAD)
        v = routed_linear(mix(2), p, "wv", cfg, seed=3).reshape(b, h, HEAD)
        w = _decay(p, mix(3)).reshape(b, h, HEAD)
        g = F.silu(routed_linear(mix(4), p, "wg", cfg, seed=4))
        # the S update and readout in float64 (module docstring)
        r, k, v, w, S64 = (a.to(torch.float64) for a in (r, k, v, w, S))
        kv = torch.einsum("bhn,bhm->bhnm", k, v)
        out = torch.einsum(
            "bhn,bhnm->bhm", r,
            S64 + p["u"].to(torch.float64)[None, :, :, None] * kv)
        S_new = (S64 * w[..., None] + kv).to(torch.float32)
        y = routed_linear(out.reshape(b, d).to(x.dtype) * g, p, "wo", cfg,
                          seed=5)
        x = x + y
        xn2 = rms_norm(x, p["ln2"])
        xk = xn2 + (x_cm - xn2) * p["cmu"][0]
        xr = xn2 + (x_cm - xn2) * p["cmu"][1]
        kk = torch.square(F.relu(routed_linear(xk, p, "ck", cfg, seed=6)))
        x = x + torch.sigmoid(routed_linear(xr, p, "cr", cfg, seed=7)) \
            * routed_linear(kk, p, "cv", cfg, seed=8)
        _write(S, S_new, write_mask)
        _write(x_tm, xn, write_mask)
        _write(x_cm, xn2, write_mask)
    x = rms_norm(x, params["ln_f"])
    logits = _softcap((x @ _unembed(params, cfg)).to(torch.float32),
                      cfg.final_softcap)
    return logits, dict(state, len=state["len"] + 1)
