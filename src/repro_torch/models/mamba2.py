"""Mamba-2 (SSD) blocks + shared-attention hybrid — zamba2-7b (PyTorch port
of `repro/models/mamba2.py`).

Mamba-2 head recurrence (state N=ssm_state, head dim P=ssm_head):
    h_t = exp(a dt_t) h_{t-1} + dt_t * (B_t outer x_t)     h in R^{NxP}
    y_t = C_t^T h_t + D * x_t
with a per-head scalar decay a < 0, input-dependent dt (softplus), B/C
shared across heads (one group). Prefill runs the chunked scan (SSD block
decomposition, chunks of 64, h carried between chunks).

Zamba2 hybrid: a stack of Mamba-2 blocks with ONE shared full-attention +
MLP block (one weight copy, params['shared_attn']) run after every full
group of `hybrid_attn_every` layers; the remainder layers run without a
trailing block. Each group's run of the shared block keeps its own KV
cache (state 'ak' / 'av', one slice per group).

With cim_mode "packed" the in/out projections and the MLP serve from
per-layer compiled chips and the shared block's projections from a chip of
their own (`models/nn.deploy_recurrent_cim`); the h recurrence stays float.

Serving state is updated IN PLACE: `prefill` and `decode_step` copy each
layer's h into the state's tensor (a slot pool's view included), and the
shared block writes its keys and values into the caches in place
(`transformer.dense_block`); decode's `write_mask` keeps a row's state
where it is False.

The h update and readout of each scan chunk and decode step run in
float64 and are rounded to float32 once, with h stored in float32 between
chunks and steps, as rwkv6's S is (`models/rwkv6.py`): a float32 sum's
order depends on how many rows share the call or how far a chunk is
padded, and a last-bit difference can move a 4-bit chip input by a level.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def layer_params(gen: torch.Generator, cfg, n_layers: int,
                 device=None) -> Dict:
    """Per-layer weights stacked over `n_layers`, in the reference's layout
    (expand factor 2; in_proj gives z, x, B, C and dt)."""
    d = cfg.d_model
    d_in = 2 * d
    n_heads = d_in // cfg.ssm_head
    dev, dtype = device or gen.device, cfg.dtype

    def s(*sh):
        w = torch.randn((n_layers, *sh), generator=gen, device=dev)
        return (w * (1.0 / math.sqrt(sh[0]))).to(dtype)

    def full(v, *sh, dt=dtype):
        return torch.full((n_layers, *sh), v, dtype=dt, device=dev)

    return {
        "ln": full(1.0, d),
        "in_proj": s(d, 2 * d_in + 2 * cfg.ssm_state + n_heads),
        "out_proj": s(d_in, d),
        "a_log": full(0.0, n_heads, dt=torch.float32),
        "dt_bias": full(0.0, n_heads, dt=torch.float32),
        "dd": full(1.0, n_heads),            # skip connection D
        "ln2": full(1.0, d),
        "w_g": s(d, cfg.d_ff), "w_i": s(d, cfg.d_ff), "w_o": s(cfg.d_ff, d),
    }


def _softplus(x):
    """jax.nn.softplus's formula, log(1 + e^x) = max(x, 0) + log1p(e^-|x|)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _split(zxbcdt, cfg):
    d_in = 2 * cfg.d_model
    n = cfg.ssm_state
    return torch.split(zxbcdt, [d_in, d_in, n, n, d_in // cfg.ssm_head],
                       dim=-1)


def _ssd_chunk(p, x, cfg, chunk: int = 64, h0=None):
    """x: (B,T,d) normalized input -> ((B,T,d) mixer output, final state
    (B,H,N,P)). h0: optional carried state. Time is padded to a chunk
    multiple with identity steps (decay 1, dt 0). Each chunk runs in
    float64 from the float32 h it starts from; its output and h are
    rounded to float32 (module docstring)."""
    from .transformer import routed_linear
    b, t, d = x.shape
    d_in = 2 * d
    n = cfg.ssm_state
    nh = d_in // cfg.ssm_head
    ph = cfg.ssm_head

    z, xin, bmat, cmat, dt = _split(
        routed_linear(x, p, "in_proj", cfg, seed=11), cfg)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])        # (B,T,H)
    a = -torch.exp(p["a_log"])                                 # (H,)
    xh = xin.reshape(b, t, nh, ph)
    decay = torch.exp(a[None, None] * dt)                      # (B,T,H)

    chunk = min(chunk, t)
    t_pad = -t % chunk
    xh_p, bm_p, cm_p, dt_p, dec_p = xh, bmat, cmat, dt, decay
    if t_pad:
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, t_pad))
        bm_p = F.pad(bmat, (0, 0, 0, t_pad))
        cm_p = F.pad(cmat, (0, 0, 0, t_pad))
        dt_p = F.pad(dt, (0, 0, 0, t_pad))
        dec_p = F.pad(decay, (0, 0, 0, t_pad), value=1.0)
    t_eff = t + t_pad
    ci = torch.arange(chunk, device=x.device)
    causal = (ci[:, None] >= ci[None, :])[None, :, :, None]

    if h0 is None:
        h0 = torch.zeros((b, nh, n, ph), dtype=torch.float32,
                         device=x.device)
    f64 = torch.float64
    h = h0
    ys = []
    for c0 in range(0, t_eff, chunk):
        xc, bc, cc, dtc, decc = (a[:, c0:c0 + chunk].to(f64) for a in
                                 (xh_p, bm_p, cm_p, dt_p, dec_p))
        hd = h.to(f64)
        logd = torch.log(decc + 1e-38)
        cum = torch.cumsum(logd, dim=1)                        # (B,C,H)
        # h_t includes the decay at t: the h0 factor at step t is inclusive
        y_state = torch.einsum("bcn,bhnp,bch->bchp", cc, hd, torch.exp(cum))
        # intra-chunk: y_t = sum_{s<=t} C_t.B_s dt_s decay(s..t) x_s
        att = torch.einsum("bcn,bdn->bcd", cc, bc)             # (B,C,C)
        ddec = torch.exp(torch.clamp(cum[:, :, None, :] - cum[:, None, :, :],
                                     -60.0, 0.0))              # (B,C,C,H)
        w = att[..., None] * ddec * causal
        y_intra = torch.einsum("bcdh,bdh,bdhp->bchp", w, dtc, xc)
        # the state at the chunk's end: the carry decays by the whole
        # chunk, each input from its step to the end
        dec_to_end = torch.exp(cum[:, -1:, :] - cum)           # (B,C,H)
        h_new = hd * torch.exp(cum[:, -1])[..., None, None]    # (B,H,N,P)
        h_upd = torch.einsum("bcn,bch,bch,bchp->bhnp", bc, dtc, dec_to_end,
                             xc)
        h = (h_new + h_upd).to(torch.float32)
        ys.append((y_state + y_intra).to(torch.float32))
    y = torch.cat(ys, dim=1).reshape(b, t_eff, nh, ph)[:, :t]
    y = y + p["dd"][None, None, :, None].to(torch.float32) \
        * xh.to(torch.float32)
    y = y.reshape(b, t, d_in).to(x.dtype) * F.silu(z)
    return routed_linear(y, p, "out_proj", cfg, seed=12), h


def _mamba_block(p, x, cfg, h0=None):
    """One Mamba-2 layer over (B,T,d): mixer, then the MLP. Returns
    (x, h_T)."""
    from .transformer import rms_norm, routed_mlp
    y, h_T = _ssd_chunk(p, rms_norm(x, p["ln"]), cfg, h0=h0)
    x = x + y
    h2 = rms_norm(x, p["ln2"])
    return x + routed_mlp(h2, p, cfg), h_T


def _layer_order(cfg):
    """(layer, the group whose shared block runs after it, else None) for
    every layer in order: the block follows the last layer of each full
    group of `hybrid_attn_every`; remainder layers have none."""
    every = cfg.hybrid_attn_every
    return [(li, li // every if every > 0 and li % every == every - 1
             else None) for li in range(cfg.n_layers)]


def forward(params, x, cfg):
    """Teacher-forcing forward: the Mamba-2 layers in groups, the shared
    attention block after each full group."""
    from .transformer import dense_block, layer_params
    positions = torch.arange(x.shape[1], device=x.device)
    for li, g in _layer_order(cfg):
        x, _ = _mamba_block(layer_params(params, li), x, cfg)
        if g is not None:
            x, _ = dense_block(params["shared_attn"], x, cfg,
                               positions=positions, layer_idx=0)
    return x


# ------------------------------------------------------------- decode path

def init_state(cfg, batch: int, max_len: int, dtype, device):
    """Per-layer h (L,B,H,N,P) f32, the fill (an int; the slot pool widens
    it to a (B,) tensor) and, for the hybrid, the shared block's KV caches
    (n_groups, B, max_len, nkv, hd)."""
    d_in = 2 * cfg.d_model
    nh = d_in // cfg.ssm_head
    st = {"h": torch.zeros((cfg.n_layers, batch, nh, cfg.ssm_state,
                            cfg.ssm_head), dtype=torch.float32,
                           device=device),
          "len": 0}
    if cfg.hybrid_attn_every > 0:
        shape = (cfg.n_layers // cfg.hybrid_attn_every, batch, max_len,
                 cfg.n_kv_heads, cfg.head_dim)
        st["ak"] = torch.zeros(shape, dtype=dtype, device=device)
        st["av"] = torch.zeros(shape, dtype=dtype, device=device)
    return st


def _positions(pos, t, device):
    """Positions of t new tokens after fill `pos`: (t,) on the static path
    (an int fill), (B, t) on the slot pool's ((B,) fills)."""
    ar = torch.arange(t, device=device)
    return pos[:, None] + ar[None] if isinstance(pos, torch.Tensor) \
        else pos + ar


def prefill(params, state, tokens, cfg):
    """Stateful chunked prefill of a prompt (B, T): fills the SSM states
    and the shared block's KV caches in place; returns (last-position
    logits, state)."""
    from .transformer import (_embed, _softcap, _unembed, dense_block,
                              layer_params, rms_norm)
    x = _embed(params, tokens, cfg)                           # (B,T,d)
    t = x.shape[1]
    pos0 = state["len"]
    positions = _positions(pos0, t, x.device)
    for li, g in _layer_order(cfg):
        x, h_T = _mamba_block(layer_params(params, li), x, cfg,
                              h0=state["h"][li])
        state["h"][li].copy_(h_T)
        if g is not None:
            x, _ = dense_block(params["shared_attn"], x, cfg,
                               positions=positions, layer_idx=0,
                               cache=(state["ak"][g], state["av"][g]),
                               cache_len=pos0)
    x = rms_norm(x[:, -1], params["ln_f"])
    logits = _softcap((x @ _unembed(params, cfg)).to(torch.float32),
                      cfg.final_softcap)
    return logits, dict(state, len=pos0 + t)


def decode_step(params, state, tokens, cfg, write_mask=None):
    """Group-structured decode mirroring `forward`: tokens (B, 1) ->
    (logits (B, V), state). write_mask: optional (B,) bool; rows where it
    is False keep their h and KV bit for bit."""
    from .transformer import (_embed, _softcap, _unembed, dense_block,
                              layer_params, rms_norm, routed_linear,
                              routed_mlp)
    x = _embed(params, tokens[:, 0], cfg)                     # (B,d)
    b, d = x.shape
    d_in = 2 * d
    nh = d_in // cfg.ssm_head
    ph = cfg.ssm_head
    pos = state["len"]
    attn_pos = _positions(pos, 1, x.device)
    for li, g in _layer_order(cfg):
        p = layer_params(params, li)
        h0 = state["h"][li]
        xn = rms_norm(x, p["ln"])
        z, xin, bm, cm, dt = _split(
            routed_linear(xn, p, "in_proj", cfg, seed=11), cfg)
        dt = _softplus(dt.to(torch.float32) + p["dt_bias"])
        a = -torch.exp(p["a_log"])
        dec = torch.exp(a[None] * dt)                         # (B,H)
        xh = xin.reshape(b, nh, ph).to(torch.float32)
        # the h update and readout in float64 (module docstring)
        f64 = torch.float64
        h_new = h0.to(f64) * dec.to(f64)[..., None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", bm.to(f64), dt.to(f64), xh.to(f64))
        y = torch.einsum("bn,bhnp->bhp", cm.to(f64), h_new).to(torch.float32)
        h_new = h_new.to(torch.float32)
        y = y + p["dd"].to(torch.float32)[None, :, None] * xh
        y = y.reshape(b, d_in).to(x.dtype) * F.silu(z)
        x = x + routed_linear(y, p, "out_proj", cfg, seed=12)
        h2 = rms_norm(x, p["ln2"])
        x = x + routed_mlp(h2, p, cfg)
        if write_mask is not None:
            h_new = torch.where(write_mask[:, None, None, None], h_new, h0)
        h0.copy_(h_new)
        if g is not None:
            y, _ = dense_block(params["shared_attn"], x[:, None], cfg,
                               positions=attn_pos, layer_idx=0,
                               cache=(state["ak"][g], state["av"][g]),
                               cache_len=pos, write_mask=write_mask)
            x = y[:, 0]
    x = rms_norm(x, params["ln_f"])
    logits = _softcap((x @ _unembed(params, cfg)).to(torch.float32),
                      cfg.final_softcap)
    return logits, dict(state, len=pos + 1)
