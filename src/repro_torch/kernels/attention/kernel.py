"""GQA / MQA attention on the card: a hand-written CUDA kernel for Hopper
(`csrc/gqa_attention.cu`) for the dense path of `models/transformer.attention`.

It replaces no Pallas kernel: the reference's attention is plain jnp
(`repro/models/transformer.py`), and the port's plain version,
`transformer._dense_attention`, stays for CPU tensors and as the
kernel's backward (`transformer._KernelAttention` recomputes it at the
same inputs and differentiates that; the kernel has no backward of its
own). On the card that plain path repeated each KV
head to its query heads, copied K and V to float64 and ran float64
einsums over every key of the slot; the kernel reads each KV head once
for its whole query group (rep = H / Hkv heads x Sq positions: the rows
of a (slot, KV head)), keeps the plain path's arithmetic (float64 dot
products rounded once, the f32 two-pass softmax, the masks) and skips the
keys past each row's last unmasked key, which add exact zeros.

The softmax's f32 sum runs in the order PyTorch's CUDA softmax sums a row
of Sk entries (`softmax_order`), so p, and with it the output, is the
plain path's to the bit but for float64 rounding ties; the benchmark's
reference computes attention as the plain path does, and through the
4-bit chip inputs a last-bit difference in p compounds into other tokens.
A row's result depends on its q, its keys, its range and Sk alone: keys
split at KEY_SPLIT offsets fixed for every shape, every float64 chain runs
in ascending order from zero, the splits sum in split order. Two choices
follow what the call shows, and neither changes a bit:
  * `mma_route(rows)`: the products on the FP64 tensor cores (DMMA) where
    a KV head has MMA_ROWS or more rows, else on the CUDA cores as the
    DMMA's own fused multiply-adds;
  * `whole_splits(...)`: where the row blocks of the values pass alone
    fill half the card or more (prefill chunks, GQA decode over many
    slots) a block sums every split itself; else each split is its own
    block and a combine pass sums them (granite's MQA decode).
Keys are at positions 0 .. Sk - 1, which is what every caller's kv_pos is
(the cache's arange, or a prompt's positions from 0).

The kernels launch on the current stream, allocate nothing (the wrapper
allocates the output and scratch with torch.empty) and read q_pos and a
(B,) kv_len on the device: legal inside the engine's captured decode
graph. Each call that launches them counts one in
`LAUNCHES["gqa_attention"]`, and nothing else does.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from .. import build as _build

LAUNCHES = _build.LAUNCHES
KEY_SPLIT = 128          # keys a split (csrc kSplit)
MMA_ROWS = 8             # rows a KV head from which the products run on DMMA
VALUE_ROWS = 32          # rows a block of the values pass on DMMA
HEAD_DIMS = (32, 64, 128, 256)   # the kernel's head dims (D padded up)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
H100_SMS = 132
_lib: Optional[ctypes.CDLL] = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def padded_head_dim(d: int) -> int:
    """The head dim the kernel runs at: the smallest of HEAD_DIMS >= d
    (the padding is zeros, which change no sum)."""
    for dp in HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(f"no attention kernel for head dim {d} (at most "
                     f"{HEAD_DIMS[-1]})")


def mma_route(rows: int) -> bool:
    """The products of a KV head with `rows` query rows on DMMA."""
    return rows >= MMA_ROWS


def whole_splits(kv_groups: int, rows: int, n_sm: int = H100_SMS) -> bool:
    """The values pass sums every split in its block: on DMMA, where the
    (slot, KV head) groups' row blocks fill half the SMs or more. Timed on
    the H100 (f32, L2 flushed): at 32 blocks (granite's decode, 16 slots
    x 48 rows) splits plus the combine took half the time (0.23 against
    0.45 ms); at 128 (deepseek's 256-row chunk, qwen2's decode), 256 and
    384 (granite's chunk) whole splits won by 6–25%, with no partials
    written and reread."""
    return mma_route(rows) and kv_groups * _cdiv(rows, VALUE_ROWS) >= n_sm // 2


def row_ranges(q_pos, sk: int, *, causal: bool, window: int = 0,
               kv_len=None):
    """(lo, hi), each shaped like q_pos's (B, Sq) broadcast: the keys each
    query row attends, [max(0, pos - window + 1), min(Sk, fill, pos + 1)),
    and [0, Sk) for a row with none (every key masked); the kernel's
    `row_range`, for the tests and the bound (keys read once)."""
    q_pos = torch.as_tensor(q_pos).to(torch.int64)
    pos = q_pos if q_pos.ndim == 2 else q_pos[None]
    hi = torch.full_like(pos, sk)
    if isinstance(kv_len, torch.Tensor):
        hi = torch.minimum(hi, kv_len.to(torch.int64).to(pos.device)[:, None])
    elif kv_len is not None:
        hi = torch.clamp_max(hi, int(kv_len))
    if causal:
        hi = torch.minimum(hi, pos + 1)
    lo = torch.clamp_min(pos - window + 1, 0) if window > 0 \
        else torch.zeros_like(pos)
    empty = hi <= lo
    return torch.where(empty, 0, lo), torch.where(empty, sk, hi)


def softmax_order(sk: int):
    """(stride, reg, nth): the order in which PyTorch's CUDA softmax over sk
    float32 entries (the plain path's, torch 2.x) sums its exps, which the
    kernel's pass 2 follows so that p is the plain path's to the bit.
    Thread t < stride of nth sums entries t, t + stride, ... (reg of them)
    in order; then each warp by a shuffle-down tree, then the warp sums.
    Up to 1024 entries: one warp a row (the persistent softmax: stride
    min(p2, 32), reg p2 / stride, p2 the power of two >= sk); above, a
    block of 1024 threads, reg ceil(sk / 1024). Held on the card against
    torch.softmax, every row bit for bit (an H100, torch 2.11), at sk up
    to 1024 and from 2500 to 8192, the chat cells' 4096 among them; at
    1025, 1536 and 2048 PyTorch sums in another order, and there this one
    is the kernel's own, still fixed."""
    if sk <= 1024:
        p2 = 1 << max(sk - 1, 0).bit_length()
        stride = min(p2, 32)
        return stride, p2 // stride, 32
    return 1024, _cdiv(sk, 1024), 1024


def load() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel's C entry points."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.library("gqa_attention")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.gqa_attention_launch.argtypes = (
        [p, p, p, p, i] + [i] * 6 + [ll] * 9 + [p, ll, p, ll, i, i, f, f, f]
        + [p] * 3 + [i, i, i, p, i, i, i, i, p])
    lib.gqa_dmma_probe.argtypes = [p] * 6
    lib.gqa_attention_launch.restype = i
    lib.gqa_dmma_probe.restype = i
    _lib = lib
    return lib


def _raise(what: str, err: int):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _rows_aligned(*ts) -> bool:
    """f32 tensors whose (B, S, H) rows all start on the 16-byte grid."""
    return all(t.dtype == torch.float32 and t.data_ptr() % 16 == 0
               and t.shape[-1] % 4 == 0
               and all(st % 4 == 0 for st in t.stride()[:3]) for t in ts)


def _dense_last(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def gqa_attention(q, k, v, *, causal: bool, q_pos, window: int = 0,
                  softcap: float = 0.0, kv_len=None):
    """Attention of q (B, Sq, H, D) over k, v (B, Sk, Hkv, D), keys at
    positions 0 .. Sk - 1, on CUDA tensors of float32 or bfloat16 and
    head dims up to 256; returns (B, Sq, H, D) in q's dtype.

    q_pos: (Sq,) or (B, Sq) query positions; kv_len: None, an int fill or
    a (B,) device tensor of per-slot fills."""
    return _attention(q, k, v, causal, q_pos, window, softcap, kv_len)


def _attention(q, k, v, causal, q_pos, window, softcap, kv_len,
               mma: Optional[bool] = None, whole: Optional[bool] = None):
    """`gqa_attention`; mma / whole pin the routes that `mma_route` and
    `whole_splits` would pick (the card tests' hook)."""
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernel runs on CUDA tensors, not "
                         f"on {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the attention kernel takes float32 or bfloat16 "
                        f"q, k and v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k, v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} are not (B, Sq, H, D) and "
                         "(B, Sk, Hkv, D) with Hkv dividing H")
    dev = q.device
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dp = padded_head_dim(d)
    if sk == 0:
        raise ValueError("attention over no keys")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q is on {dev}")
    q_pos = torch.as_tensor(q_pos, device=dev).to(torch.int64)
    if q_pos.shape not in ((sq,), (b, sq), (1, sq)):
        raise ValueError(f"q_pos has shape {tuple(q_pos.shape)}, not "
                         f"({sq},) or ({b}, {sq})")
    q_pos = q_pos.contiguous()
    qpos_sb = sq if q_pos.ndim == 2 and q_pos.shape[0] == b > 1 else 0
    kv_fill, fills = sk, None
    if isinstance(kv_len, torch.Tensor):
        if kv_len.shape != (b,) or kv_len.device != dev:
            raise ValueError(f"kv_len must be a ({b},) tensor on {dev}, got "
                             f"{tuple(kv_len.shape)} on {kv_len.device}")
        fills = kv_len.to(torch.int64).contiguous()
    elif kv_len is not None:
        kv_fill = int(kv_len)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    if b == 0 or sq == 0 or h == 0:
        return out
    q, k, v = _dense_last(q), _dense_last(k), _dense_last(v)
    rows, n_split, groups = (h // hkv) * sq, _cdiv(sk, KEY_SPLIT), b * hkv
    if mma is None:
        mma = mma_route(rows)
    if whole is None:
        whole = whole_splits(groups, rows, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    if whole and not mma:
        raise ValueError("whole splits run on the DMMA route only")
    f32 = torch.float32
    scores = torch.empty((groups * rows * sk,), dtype=f32, device=dev)
    pmax = torch.empty((groups * rows * n_split,), dtype=f32, device=dev)
    psum = torch.empty((groups * rows,), dtype=f32, device=dev)
    opart = torch.empty((1 if whole else groups * n_split * rows * dp,),
                        dtype=torch.float64, device=dev)
    cap = np.float32(softcap)
    inv_cap = float(np.float32(1.0) / cap) if softcap > 0 else 0.0
    with torch.cuda.device(dev):
        _raise("gqa_attention", load().gqa_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], b, sq, h, hkv, d, sk, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], q_pos.data_ptr(), qpos_sb,
            fills.data_ptr() if fills is not None else None, kv_fill,
            int(causal), int(window), 1.0 / math.sqrt(d), float(cap),
            inv_cap, scores.data_ptr(), pmax.data_ptr(), psum.data_ptr(),
            *softmax_order(sk), opart.data_ptr(), dp, int(mma), int(whole),
            int(_rows_aligned(q, k, v)),
            torch.cuda.current_stream(dev).cuda_stream))
    LAUNCHES["gqa_attention"] += 1
    return out


def dmma_probe(a, b, c):
    """One m16n8k4 DMMA of the card on (a (16, 4), b (4, 8), c (16, 8)),
    float64 on CUDA, and the kernel's CUDA-core emulation of it: (D, E)."""
    a, b, c = (t.to(torch.float64).contiguous() for t in (a, b, c))
    dm, e = torch.empty_like(c), torch.empty_like(c)
    with torch.cuda.device(a.device):
        _raise("gqa_dmma_probe", load().gqa_dmma_probe(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), dm.data_ptr(),
            e.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream))
    return dm, e
