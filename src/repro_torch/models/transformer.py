"""LM backbone (PyTorch port of `repro/models/transformer.py`): the dense,
MoE, recurrent, encoder-decoder and vision-prefix families.

GQA / MQA attention (qwen2, codeqwen, granite, internvl2's backbone) with
an optional float QKV bias (the qwen family) and gemma2's details —
attention-logit and final-logit softcaps, alternating local (even layers)
/ global (odd layers) sliding window attention, the sqrt(d_model)
embedding scale, tied or untied unembedding — and either a SwiGLU MLP or
a fine-grained MoE FFN with shared experts (`models/moe.py`:
deepseek-moe, llama4). Above a KV length of 2 * ATTN_CHUNK attention
runs the reference's online softmax over KV chunks. seamless-m4t's
encoder-decoder encodes frontend embeddings with a bidirectional float
encoder and adds cross-attention to every decoder block; internvl2's
vision prefix (stub frontend embeddings) runs ahead of the tokens.
llama4's 1:1 dense/MoE interleave (`moe_every=2`) keeps its dense layers
under params['dense_layers'] beside the MoE ones in params['layers']; the
layers run in pairs, dense first. Params are a dict of tensors in the
reference's layout: per-layer weights stacked as (L, in, out) (experts
(L, E, in, out)). The reference's `lax.scan` over layers is a Python loop
here. The recurrent families dispatch on the config: `rwkv` to
`models/rwkv6.py`, `ssm_state > 0` to `models/mamba2.py` (zamba2's hybrid
with its shared attention block); they embed without gemma's scale.

The float sums that feed a chip input — RMSNorm's mean of squares and
attention's two dot products (scores and the weighted values) — are
summed in float64 and rounded once, as the recurrent families' scans are
(`models/rwkv6.py`): a float32 reduction's order depends on how many rows
share the call (a slot served in a pool of 4 or alone, a prompt
prefilled whole or in chunks), and a last-bit difference can move a
4-bit chip input by a level.

On CUDA tensors the dense attention path is one hand-written kernel
(`kernels/attention`, `csrc/gqa_attention.cu`): each KV head read once
for its query group, the same float64 dot products and f32 softmax (its
sum in torch.softmax's order: the plain path's bits), the keys past a
row's fill skipped, a row's bits independent of the batch and the
chunking. Its backward (LM training) differentiates the plain
`_dense_attention` recomputed at the same inputs; CPU tensors take the
plain path.

Every projection can route through the NeuRRAM CIM path (`cim_linear`):
with cim_mode="packed" and a deployed '<name>_cim' entry
(models/nn.deploy_transformer_cim), the projection runs on its compiled
chip through the packed or scheduled kernel, and each routed expert on
its own chip. The training modes "noisy" (weight noise) and "chipsim"
(the chip's datapath as one quantized matmul) are plain torch, as in
the reference; `lm_loss` is the teacher-forced loss they train on, and
every family's `lm_forward` is differentiable (the recurrent families'
in-place state writes sit in their prefill / decode paths only).

Where an engine call has a span buffer active (`obs/trace.span`), the
serve path's dense and MoE blocks record host spans: "layer" {i} with
"attn.qkv", "attn.core", "attn.wo" and "mlp" (an MoE layer's FFN spans
are `moe_ffn`'s), and "unembed". Inside a captured decode graph no
Python runs at replay, so only eager steps show them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..obs.trace import span


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """An LM: dense, MoE when n_experts > 0, RWKV-6 when rwkv, Mamba-2
    (with zamba2's shared attention block every hybrid_attn_every layers)
    when ssm_state > 0, an encoder-decoder when enc_layers > 0 and a
    vision-prefix VLM when vis_patches > 0."""
    name: str = "dense"
    family: str = "dense"        # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    qkv_bias: bool = False       # qwen family: float bias on q, k, v
    attn_softcap: float = 0.0    # gemma2: 50.0
    final_softcap: float = 0.0   # gemma2: 30.0
    local_window: int = 0        # sliding window size for local layers
    alt_local_global: bool = False  # gemma2: alternate local/global
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0            # expert FFN width (fine-grained MoE)
    moe_every: int = 1           # llama4: MoE on every 2nd layer
    # SSM / hybrid
    rwkv: bool = False
    ssm_state: int = 0           # mamba2 state dim N
    ssm_head: int = 64           # mamba2 head dim P
    hybrid_attn_every: int = 0   # zamba2: shared attn block period
    # enc-dec
    enc_layers: int = 0
    # vlm
    vis_patches: int = 0         # number of stub vision-prefix embeddings
    # Dropless dispatch: every routed token kept (capacity = T). The
    # capacity-factor path makes a token's output depend on which other
    # tokens share the batch; launch/scheduler forces this on.
    moe_dropless: bool = False
    # The reference's mesh knobs: batch_axes names the mesh axes the batch
    # dim is striped over (the data axes `moe_ffn_ep_shardmap` stripes its
    # tokens over); moe_impl "ep" takes the explicit expert-parallel FFN
    # on moe.MESH_FOR_EP (dense_block)
    batch_axes: Any = None
    moe_impl: str = "sort"       # sort | ep
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    # NeuRRAM CIM technique: off | noisy (training-time weight noise) |
    # chipsim (quantized input, noisy weight, quantized output) | packed
    # (serve the dense-block projections through their compiled chips,
    # one kernel launch each)
    cim_mode: str = "off"
    cim_in_bits: int = 4
    cim_out_bits: int = 8
    cim_noise: float = 0.1       # noisy / chipsim: sigma, a fraction of max|w|
    # IR-drop alpha (1/uS) of the chip: > 0 makes the chip compiler split
    # wide matrices vertically (mapping.ir_drop_max_cols)
    cim_ir_drop: float = 0.0
    # "auto" launches the CIM kernels on CUDA tensors; "plain" forces
    # their plain PyTorch versions (the on-card comparison only)
    cim_impl: str = "auto"
    # tensor-parallel serving: the `launch/mesh.Mesh` a CIM deploy places
    # shard s's chips on (its 'model' device s; `nn.deploy_cim`); every
    # shard's kernel launches where its chips lie (`nn.sharded_packed_loop`)
    cim_mesh: Any = None

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------- CIM linear

# rows of a weight whose noise is drawn at once: the hash runs in int64,
# so a full-width w_g (242 M weights) drawn whole would need ~2 GB per
# temporary
NOISE_BLOCK_ELEMS = 1 << 24


def weight_noise(w, seed: int):
    """The reference's eps of `cim_linear` for a 2-D weight (in, out):
    hash_normal over the weight's global (row, column) coordinates with
    salts (seed, out), in w's dtype. It depends on the call site's seed
    and the weight's shape only, so every layer, and every step, draws the
    same pattern (the reference's). Drawn in row blocks of
    NOISE_BLOCK_ELEMS elements; the bits are those of one draw."""
    from ..kernels.prng import hash_normal_at
    rows, cols = w.shape
    eps = torch.empty((rows, cols), dtype=w.dtype, device=w.device)
    step = max(1, NOISE_BLOCK_ELEMS // cols)
    col = torch.arange(cols, device=w.device)[None, :]
    for r0 in range(0, rows, step):
        r = torch.arange(r0, min(r0 + step, rows), device=w.device)[:, None]
        eps[r0:r0 + step] = hash_normal_at(r, col, seed, cols)
    return eps


def noisy_weight(w, cfg: ArchConfig, seed: int):
    """w + cim_noise * max|w| * eps (`weight_noise`), in w's dtype and in
    the reference's order of operations; differentiable in w (max|w|
    included)."""
    wmax = torch.amax(torch.abs(w))
    with torch.no_grad():
        eps = weight_noise(w, seed)
    return w + cfg.cim_noise * wmax * eps


def _quantize_sym(x, bits: int):
    """The reference's symmetric grid at `bits` over max|x| (at least
    1e-6): round(clip(x / xmax, -1, 1) * n) * (xmax / n), n = 2^(bits-1)
    - 1 levels (1 for binary). torch.round, like jnp.round, rounds half
    to even."""
    xmax = torch.clamp_min(torch.amax(torch.abs(x)), 1e-6)
    n = max((1 << (bits - 1)) - 1, 1)
    return torch.round(torch.clamp(x / xmax, -1, 1) * n) * (xmax / n)


def cim_linear(x, w, cfg: ArchConfig, *, seed: int = 0, packed=None):
    """Route a matmul through the paper's technique, selected by cim_mode.

    off:     plain x @ w.
    noisy:   noise-resilient training forward: x @ `noisy_weight(w)`
             (the reference draws eps in plain jnp, at the weight's global
             coordinates, not through its noisy-matmul kernel).
    chipsim: the chip's datapath as one f32 matmul: the input on the
             cim_in_bits grid, the noisy weight, the output on the
             cim_out_bits grid.
    packed:  the programmed chip datapath — `packed` is this projection's
             PackedCIMLayer (the whole tile plan is one kernel launch) or
             ShardedPackedLayer (one launch per tensor-parallel shard,
             where its chips lie); seed: the stochastic neuron's salt,
             the reference's per call site. Without a deployed plan,
             packed mode keeps the float path.
    """
    if cfg.cim_mode == "packed" and packed is not None:
        from . import nn as nn_mod
        ccfg = nn_mod.arch_cim_config(cfg)
        shape = x.shape
        y = nn_mod.packed_linear(packed, x.reshape(-1, shape[-1]), ccfg,
                                 seed=seed, impl=cfg.cim_impl)
        return y.reshape(*shape[:-1], y.shape[-1]).to(x.dtype)
    if cfg.cim_mode in ("off", "packed"):
        return x @ w
    if cfg.cim_mode == "noisy":
        return x @ noisy_weight(w, cfg, seed)
    if cfg.cim_mode == "chipsim":
        xq = _quantize_sym(x, cfg.cim_in_bits)
        y = xq.to(torch.float32) @ noisy_weight(w, cfg, seed).to(
            torch.float32)
        return _quantize_sym(y, cfg.cim_out_bits).to(x.dtype)
    raise ValueError(f"unknown cim_mode {cfg.cim_mode!r}")


def routed_linear(x, p, name: str, cfg: ArchConfig, *, seed: int = 0):
    """`cim_linear` over `p[name]`, picking up the deployed `p[name +
    '_cim']` entry when present."""
    return cim_linear(x, p[name], cfg, seed=seed,
                      packed=p.get(name + "_cim"))


# ------------------------------------------------------------------- layers

def rms_norm(x, scale, eps: float = 1e-6):
    """The reference's RMSNorm, its mean of squares summed in float64 and
    rounded to float32 once (module docstring)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(x.to(torch.float64)), dim=-1,
                     keepdim=True).to(torch.float32)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _dot(eq: str, a, b):
    """einsum `eq` of a and b summed in float64 and rounded once to a's
    dtype (module docstring)."""
    return torch.einsum(eq, a.to(torch.float64),
                        b.to(torch.float64)).to(a.dtype)


def rope(x, positions, theta: float):
    """x: (..., S, H, D). positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq       # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x


def _attn_mask(q_pos, kv_pos, causal, window: int, kv_len):
    """Boolean mask, (Sq, Sk) — or (B, Sq, Sk) when q_pos is (B, Sq) and
    kv_len a (B,) tensor (the slot pool: every request at its own
    position). kv_len: the cache fill, an int on the static path."""
    dist = q_pos[..., :, None] - kv_pos[None, :]
    mask = torch.ones(dist.shape, dtype=torch.bool, device=dist.device)
    if causal:
        mask &= dist >= 0
    if window > 0:
        mask &= dist < window
    if isinstance(kv_len, torch.Tensor):
        mask = mask & (kv_pos[None, None, :] < kv_len[:, None, None])
    elif kv_len is not None:
        mask &= kv_pos < kv_len
    return mask


def _expand_mask(mask):
    """Broadcast an (Sq,Sk) or (B,Sq,Sk) mask against (B,H,Sq,Sk)
    logits."""
    return mask[None, None] if mask.ndim == 2 else mask[:, None]


# KV chunk size: above 2 * ATTN_CHUNK keys attention switches to the
# online-softmax path, which never materializes the (Sq, Sk) logits
ATTN_CHUNK = 4096


class _KernelAttention(torch.autograd.Function):
    """The GQA kernel (`kernels/attention`) as a differentiable call: its
    forward launches the kernel; its backward recomputes the plain
    `_dense_attention` at the same inputs and differentiates that (the
    kernel has no backward; its forward is the plain path's to the bit
    where `softmax_order` is PyTorch's). `kw` holds the call's keywords."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        from ..kernels.attention import kernel as attn_kernel
        ctx.kw = kw
        ctx.save_for_backward(q, k, v)
        return attn_kernel.gqa_attention(
            q, k, v, causal=kw["causal"], q_pos=kw["q_pos"],
            window=kw["window"], softcap=kw["softcap"], kv_len=kw["kv_len"])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = _dense_attention(*ins, **ctx.kw)
            grads = iter(torch.autograd.grad(
                out, [t for t in ins if t.requires_grad], grad))
        return (*(next(grads) if t.requires_grad else None for t in ins),
                None)


def attention(q, k, v, *, causal: bool, q_pos, kv_pos, window: int = 0,
              softcap: float = 0.0, kv_len=None):
    """q: (B,Sq,H,D), k/v: (B,Sk,Hkv,D). Long KV: `_chunked_attention`.
    Short KV on CUDA tensors: the GQA kernel (`_KernelAttention`), with
    the keys at positions 0 .. Sk - 1 as every caller's kv_pos; on the
    CPU the plain `_dense_attention`."""
    if k.shape[1] > 2 * ATTN_CHUNK:
        return _chunked_attention(q, k, v, causal=causal, q_pos=q_pos,
                                  kv_pos=kv_pos, window=window,
                                  softcap=softcap, kv_len=kv_len)
    kw = dict(causal=causal, q_pos=q_pos, kv_pos=kv_pos, window=window,
              softcap=softcap, kv_len=kv_len)
    if not q.is_cuda:
        return _dense_attention(q, k, v, **kw)
    if tuple(kv_pos.shape) != (k.shape[1],):
        raise ValueError(f"kv_pos has shape {tuple(kv_pos.shape)}, not "
                         f"({k.shape[1]},)")
    return _KernelAttention.apply(q, k, v, kw)


def _dense_attention(q, k, v, *, causal: bool, q_pos, kv_pos, window: int,
                     softcap: float, kv_len):
    """The plain dense path (the kernel's plain version): GQA via head
    repetition, float64 dot products rounded once, the f32 softmax over
    the whole KV under the boolean mask."""
    rep = q.shape[2] // k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    kf = torch.repeat_interleave(k, rep, dim=2)
    vf = torch.repeat_interleave(v, rep, dim=2)
    logits = _dot("bqhd,bkhd->bhqk", q, kf) * scale
    logits = _softcap(logits, softcap)
    mask = _attn_mask(q_pos, kv_pos, causal, window, kv_len)
    # a Python scalar, not a device tensor: no host-to-device copy (legal
    # inside a CUDA graph capture), the same f32 value
    logits = torch.where(_expand_mask(mask), logits.to(torch.float32),
                         -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _dot("bhqk,bkhd->bqhd", probs, v if rep == 1 else vf)


def _chunked_attention(q, k, v, *, causal: bool, q_pos, kv_pos, window: int,
                       softcap: float, kv_len):
    """The reference's online softmax over KV chunks of ATTN_CHUNK keys,
    in its order of operations: f32 running max m, sum l and accumulator,
    each chunk rescaling them by exp(m - m_new), then acc / max(l, 1e-30);
    each chunk's dot products summed in float64 and rounded once.
    Peak activation is (Sq, ATTN_CHUNK) logits per head. The masks are the
    dense path's (window, causal, an int or (B,) kv_len)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if sk % ATTN_CHUNK:
        raise ValueError(f"KV length {sk} is not a multiple of ATTN_CHUNK "
                         f"= {ATTN_CHUNK}")
    rep = h // hkv
    scale = 1.0 / math.sqrt(d)
    f32 = torch.float32
    qf = q.to(f32)
    m = torch.full((b, h, sq), -1e30, dtype=f32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=f32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=f32, device=q.device)
    for c0 in range(0, sk, ATTN_CHUNK):
        kc = torch.repeat_interleave(k[:, c0:c0 + ATTN_CHUNK], rep, dim=2)
        vc = torch.repeat_interleave(v[:, c0:c0 + ATTN_CHUNK], rep, dim=2)
        logits = _dot("bqhd,bkhd->bhqk", qf, kc) * scale
        logits = _softcap(logits, softcap)
        mask = _attn_mask(q_pos, kv_pos[c0:c0 + ATTN_CHUNK], causal, window,
                          kv_len)
        logits = torch.where(_expand_mask(mask), logits, -1e30)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + _dot("bhqk,bkhd->bhqd", p, vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def mlp(x, wi, wg, wo, cfg: ArchConfig, seed: int = 0,
        packed=(None, None, None)):
    """SwiGLU MLP. packed: optional (w_i, w_g, w_o) PackedCIMLayers."""
    pi, pg, po = packed
    h = F.silu(cim_linear(x, wg, cfg, seed=seed, packed=pg)) \
        * cim_linear(x, wi, cfg, seed=seed + 1, packed=pi)
    return cim_linear(h, wo, cfg, seed=seed + 2, packed=po)


def routed_mlp(x, p, cfg: ArchConfig, *, seed: int = 5):
    """`mlp` routed by param name (`w_i/w_g/w_o` + optional `_cim`)."""
    return mlp(x, p["w_i"], p["w_g"], p["w_o"], cfg, seed=seed,
               packed=(p.get("w_i_cim"), p.get("w_g_cim"), p.get("w_o_cim")))


# ------------------------------------------------------------ param init

def _dense_layer_params(gen: torch.Generator, cfg: ArchConfig, n_layers: int,
                        xattn: bool = False, device=None):
    """Per-layer weights stacked over `n_layers`: normal / sqrt(fan_in).
    xattn: an encoder-decoder's decoder layers also carry cross-attention
    (xln, xwq, xwk, xwv, xwo); qkv_bias adds the zero-initialised float
    biases bq, bk, bv. MoE layers (n_experts > 0) carry the router, the
    routed experts' (L, E, in, out) stacks and, with shared experts, their
    fused SwiGLU (width d_expert * n_shared_experts) in place of the
    MLP. device: where they are made (default: the generator's)."""
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    d, f = cfg.d_model, cfg.d_ff
    dev, dtype = device or gen.device, cfg.dtype

    def s(*sh):
        w = torch.randn((n_layers, *sh), generator=gen, device=dev)
        return (w * (1.0 / math.sqrt(sh[-2]))).to(dtype)

    p = {}
    if xattn:
        p["xln"] = torch.ones((n_layers, d), dtype=dtype, device=dev)
        p.update(xwq=s(d, nh * hd), xwk=s(d, nkv * hd), xwv=s(d, nkv * hd),
                 xwo=s(nh * hd, d))
    p.update(wq=s(d, nh * hd), wk=s(d, nkv * hd), wv=s(d, nkv * hd),
             wo=s(nh * hd, d))
    if cfg.qkv_bias:
        for n, width in (("bq", nh), ("bk", nkv), ("bv", nkv)):
            p[n] = torch.zeros((n_layers, width * hd), dtype=dtype,
                               device=dev)
    p["ln1"] = torch.ones((n_layers, d), dtype=dtype, device=dev)
    p["ln2"] = torch.ones((n_layers, d), dtype=dtype, device=dev)
    if cfg.n_experts > 0:
        de, e = cfg.d_expert or f, cfg.n_experts
        p["router"] = s(d, e)
        p["ew_g"] = s(e, d, de)
        p["ew_i"] = s(e, d, de)
        p["ew_o"] = s(e, de, d)
        if cfg.n_shared_experts > 0:
            ds = de * cfg.n_shared_experts
            p["sw_g"] = s(d, ds)
            p["sw_i"] = s(d, ds)
            p["sw_o"] = s(ds, d)
        return p
    p["w_g"] = s(d, f)
    p["w_i"] = s(d, f)
    p["w_o"] = s(f, d)
    return p


def _recurrent(cfg: ArchConfig):
    """The module of a recurrent family — `models/rwkv6.py` when rwkv,
    `models/mamba2.py` when ssm_state > 0 — else None. Both give
    layer_params, forward, init_state, prefill and decode_step with one
    signature."""
    if cfg.rwkv:
        from . import rwkv6
        return rwkv6
    if cfg.ssm_state > 0:
        from . import mamba2
        return mamba2
    return None


def init_params(cfg: ArchConfig, *, seed: int = 0, device=None) -> Dict:
    """Random params from a torch.Generator seeded with `seed`, made on
    `device` (CUDA unless "cpu" is passed; the full-width embedding alone
    is 3.7 GB in f32). An untied arch gets its own `unembed` (d, V); the
    1:1 interleave (`moe_every=2`) n_layers / 2 dense layers under
    'dense_layers' and as many MoE layers under 'layers'; the recurrent
    archs their rwkv6 or mamba2 layer stacks, and zamba2 its one shared
    attention block, unstacked, under 'shared_attn'; an encoder-decoder
    its encoder stack under 'enc_layers' with its final norm 'ln_enc'
    (and cross-attention in every decoder layer); a VLM 'vis_proj'
    (vis_patches, d), kept for the reference's layout. On the `meta`
    device (shapes and dtypes only, nothing allocated) the draws come from
    a CPU generator that draws nothing."""
    device = resolve_device(device)
    gen = torch.Generator("cpu" if device.type == "meta" else device
                          ).manual_seed(seed)
    params = {
        "embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                              device=device) * 0.02).to(cfg.dtype),
        "ln_f": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = (torch.randn((cfg.d_model, cfg.vocab),
                                         generator=gen, device=device)
                             * 0.02).to(cfg.dtype)
    rec = _recurrent(cfg)
    if rec is not None:
        params["layers"] = rec.layer_params(gen, cfg, cfg.n_layers, device)
        if cfg.hybrid_attn_every > 0:       # zamba2's one shared block
            params["shared_attn"] = {
                k: v[0] for k, v in _dense_layer_params(
                    gen, cfg, 1, device=device).items()}
        return params
    if cfg.n_experts > 0 and cfg.moe_every > 1:
        if cfg.moe_every != 2:
            raise ValueError("only the 1:1 dense/MoE interleave "
                             "(moe_every=2) is supported")
        n = cfg.n_layers // 2
        params["dense_layers"] = _dense_layer_params(
            gen, cfg.replace(n_experts=0), n, device=device)
        params["layers"] = _dense_layer_params(gen, cfg, n, device=device)
        return params
    params["layers"] = _dense_layer_params(gen, cfg, cfg.n_layers,
                                           xattn=cfg.enc_layers > 0,
                                           device=device)
    if cfg.enc_layers > 0:
        params["enc_layers"] = _dense_layer_params(gen, cfg, cfg.enc_layers,
                                                   device=device)
        params["ln_enc"] = torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                      device=device)
    if cfg.vis_patches > 0:
        params["vis_proj"] = (torch.randn((cfg.vis_patches, cfg.d_model),
                                          generator=gen, device=device)
                              * 0.02).to(cfg.dtype)
    return params


def layer_params(params, li: int) -> Dict:
    """Block li's params: a view of each (L, ...) weight stack and that
    layer's entry of each deployed '<name>_cim' list. Under the 1:1
    interleave block li is dense layer li // 2 when li is even, else MoE
    layer li // 2."""
    stack = params["layers"]
    if "dense_layers" in params:
        stack = params["dense_layers"] if li % 2 == 0 else stack
        li //= 2
    return {k: v[li] for k, v in stack.items()}


def _unembed(params, cfg: ArchConfig):
    """The (d, V) unembedding: the embedding's transpose when tied."""
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


# ------------------------------------------------------------ layer bodies

def _window(cfg: ArchConfig, layer_idx: int) -> int:
    """gemma2's local/global alternation: even layers local, odd global."""
    if cfg.local_window <= 0:
        return 0
    if cfg.alt_local_global and layer_idx % 2:
        return 0
    return cfg.local_window


def dense_block(p, x, cfg: ArchConfig, *, positions, layer_idx: int,
                cache=None, cache_len=None, write_mask=None, memory=None):
    """One pre-norm transformer block. Returns (y, cache). The QKV bias
    (qkv_bias) is added to the chip outputs of wq, wk and wv before RoPE;
    with `memory` (B, S_src, d), the encoder's output, cross-attention
    follows self-attention, before the MLP.

    cache: this layer's (k, v) views of the (B, S_max, nkv, hd) cache;
    the new keys and values are written into them IN PLACE at cache_len
    (the reference returns an updated copy): an int on the static path,
    or a (B,) tensor of per-slot fills (the slot pool), each row then
    scattered at its own offset. write_mask: optional (B,) bool; a row
    where it is False rewrites its cache entry with what was there, so a
    frozen slot's cache stays bit for bit as it was."""
    b, s, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    with span("attn.qkv"):
        h = rms_norm(x, p["ln1"])
        q = routed_linear(h, p, "wq", cfg, seed=1).reshape(b, s, nh, hd)
        k = routed_linear(h, p, "wk", cfg, seed=2).reshape(b, s, nkv, hd)
        v = routed_linear(h, p, "wv", cfg, seed=3).reshape(b, s, nkv, hd)
        if cfg.qkv_bias:
            q = q + p["bq"].reshape(nh, hd)
            k = k + p["bk"].reshape(nkv, hd)
            v = v + p["bv"].reshape(nkv, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    window = _window(cfg, layer_idx)

    with span("attn.core"):
        if cache is not None:
            ck, cv = cache
            if isinstance(cache_len, torch.Tensor):
                sidx = cache_len[:, None] + torch.arange(s, device=x.device)
                bidx = torch.arange(b, device=x.device)[:, None]
                if write_mask is not None:
                    keep = write_mask[:, None, None, None]
                    k = torch.where(keep, k, ck[bidx, sidx])
                    v = torch.where(keep, v, cv[bidx, sidx])
                ck[bidx, sidx] = k
                cv[bidx, sidx] = v
            else:
                ck[:, cache_len:cache_len + s] = k
                cv[:, cache_len:cache_len + s] = v
            kv_pos = torch.arange(ck.shape[1], device=x.device)
            attn = attention(q, ck, cv, causal=True, q_pos=positions,
                             kv_pos=kv_pos, window=window,
                             softcap=cfg.attn_softcap, kv_len=cache_len + s)
        else:
            attn = attention(q, k, v, causal=True, q_pos=positions,
                             kv_pos=positions, window=window,
                             softcap=cfg.attn_softcap)
    with span("attn.wo"):
        x = x + routed_linear(attn.reshape(b, s, nh * hd), p, "wo", cfg,
                              seed=4)
    if memory is not None:
        x = x + _cross_attn(p, x, memory, cfg)
    h2 = rms_norm(x, p["ln2"])
    if "ew_g" in p:                 # MoE FFN (dense and MoE interleave)
        from . import moe
        # packed serving keeps the sort dispatch: only it drives the
        # per-expert chips
        if cfg.moe_impl == "ep" and moe.MESH_FOR_EP is not None \
                and cfg.cim_mode != "packed":
            return x + moe.moe_ffn_ep_shardmap(
                p, h2, cfg, moe.MESH_FOR_EP,
                data_axes=tuple(cfg.batch_axes or ("data",))), cache
        return x + moe.moe_ffn(p, h2, cfg), cache
    with span("mlp"):
        return x + routed_mlp(h2, p, cfg, seed=5), cache


def _cross_attn(p, x, memory, cfg: ArchConfig):
    """The encoder-decoder's cross-attention (float: its projections never
    go on a chip): queries from x, keys and values from the encoder's
    `memory`, unmasked."""
    b, s, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    sm = memory.shape[1]
    h = rms_norm(x, p["xln"])
    q = (h @ p["xwq"]).reshape(b, s, nh, hd)
    k = (memory @ p["xwk"]).reshape(b, sm, nkv, hd)
    v = (memory @ p["xwv"]).reshape(b, sm, nkv, hd)
    rep = nh // nkv
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, nh * hd)
    return o @ p["xwo"]


def _encode(params, src_embeds, cfg: ArchConfig):
    """The encoder-decoder's bidirectional encoder over frontend embeddings
    (B, S_src, d): float blocks (RoPE on q and k, no mask, a SwiGLU MLP;
    no chip, no QKV bias), then 'ln_enc'."""
    x = src_embeds.to(cfg.dtype)
    b, s, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    positions = torch.arange(s, device=x.device)
    stack = params["enc_layers"]
    for li in range(cfg.enc_layers):
        p = {k: v[li] for k, v in stack.items()}
        h = rms_norm(x, p["ln1"])
        q = rope((h @ p["wq"]).reshape(b, s, nh, hd), positions,
                 cfg.rope_theta)
        k = rope((h @ p["wk"]).reshape(b, s, nkv, hd), positions,
                 cfg.rope_theta)
        v = (h @ p["wv"]).reshape(b, s, nkv, hd)
        attn = attention(q, k, v, causal=False, q_pos=positions,
                         kv_pos=positions, softcap=cfg.attn_softcap)
        x = x + attn.reshape(b, s, nh * hd) @ p["wo"]
        h2 = rms_norm(x, p["ln2"])
        x = x + mlp(h2, p["w_i"], p["w_g"], p["w_o"], cfg)
    return rms_norm(x, params["ln_enc"])


def _embed(params, tokens, cfg: ArchConfig):
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.name.startswith("gemma"):
        # a 0-d CPU tensor: a CUDA kernel reads it as a host scalar, with
        # no copy to the card (legal inside a CUDA graph capture)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
    return x


def lm_forward(params, tokens, cfg: ArchConfig, *, vis_embeds=None,
               src_embeds=None):
    """Teacher-forcing forward. tokens: (B, S) -> logits (B, S, V).

    vis_embeds: (B, P, d) stub vision-frontend embeddings (vlm), run ahead
    of the tokens; their positions' logits are dropped.
    src_embeds: (B, S_src, d) stub modality-frontend embeddings (encdec),
    encoded once and cross-attended by every decoder block."""
    x = _embed(params, tokens, cfg)
    if vis_embeds is not None:
        x = torch.cat([vis_embeds.to(cfg.dtype), x], dim=1)
    memory = None
    if cfg.enc_layers > 0:
        if src_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             "src_embeds")
        memory = _encode(params, src_embeds, cfg)
    rec = _recurrent(cfg)
    if rec is not None:
        x = rec.forward(params, x, cfg)
    else:
        positions = torch.arange(x.shape[1], device=x.device)
        for li in range(cfg.n_layers):
            x, _ = dense_block(layer_params(params, li), x, cfg,
                               positions=positions, layer_idx=li,
                               memory=memory)
    x = rms_norm(x, params["ln_f"])
    logits = x @ _unembed(params, cfg)
    logits = _softcap(logits.to(torch.float32), cfg.final_softcap)
    if vis_embeds is not None:
        logits = logits[:, vis_embeds.shape[1]:]
    return logits


# ------------------------------------------------------------------- loss

def lm_loss(params, batch, cfg: ArchConfig):
    """Mean next-token NLL of the f32 log-softmax. batch: "tokens" (B,
    S + 1), and "vis_embeds" / "src_embeds" as `lm_forward` takes them."""
    tokens = batch["tokens"]
    logits = lm_forward(params, tokens[:, :-1], cfg,
                        vis_embeds=batch.get("vis_embeds"),
                        src_embeds=batch.get("src_embeds"))
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return torch.mean(nll)


# ------------------------------------------------------------- serve path

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """Decode cache on `device` (CUDA unless "cpu" is passed): KV of shape
    (L, B, S, nkv, hd) and the fill, an int (the slot pool widens it to a
    (B,) tensor, `launch/scheduler.init_pool`); the recurrent archs'
    constant-size state (`rwkv6.init_state`, `mamba2.init_state`). The
    batch (slot) dimension is axis 1 of every tensor."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    rec = _recurrent(cfg)
    if rec is not None:
        return rec.init_state(cfg, batch, max_len, dtype, device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0}


def decode_step(params, cache, tokens, cfg: ArchConfig, write_mask=None,
                memory=None):
    """One decode step: tokens (B, S) + cache -> (logits (B, V) of the
    last position, cache). The cache tensors are updated in place; the
    returned dict carries the new fill. cache["len"] is an int on the
    static path and a (B,) tensor of per-slot fills on the slot pool's:
    positions then carry a batch dimension, and each slot's keys and
    values land at its own fill (rows where `write_mask` is False keep
    their cache). memory: an encoder-decoder's encoded source, which
    every block cross-attends. The recurrent archs step one token (S = 1)
    through `rwkv6.decode_step` / `mamba2.decode_step`."""
    rec = _recurrent(cfg)
    if rec is not None:
        return rec.decode_step(params, cache, tokens, cfg, write_mask)
    x = _embed(params, tokens, cfg)
    pos = cache["len"]
    ar = torch.arange(tokens.shape[1], device=x.device)
    positions = pos[:, None] + ar[None] if isinstance(pos, torch.Tensor) \
        else pos + ar
    for li in range(cfg.n_layers):
        with span("layer", i=li):
            x, _ = dense_block(layer_params(params, li), x, cfg,
                               positions=positions, layer_idx=li,
                               cache=(cache["k"][li], cache["v"][li]),
                               cache_len=pos, write_mask=write_mask,
                               memory=memory)
    with span("unembed"):
        x = rms_norm(x, params["ln_f"])
        logits = _softcap((x[:, -1] @ _unembed(params, cfg)).to(
            torch.float32), cfg.final_softcap)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "len": pos + tokens.shape[1]}


def prefill(params, tokens, cache, cfg: ArchConfig, memory=None):
    """Prefill the cache with a full prompt: decode_step with S > 1, or the
    recurrent archs' stateful chunked prefill."""
    rec = _recurrent(cfg)
    if rec is not None:
        return rec.prefill(params, cache, tokens, cfg)
    return decode_step(params, cache, tokens, cfg, memory=memory)
