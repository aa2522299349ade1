"""The yardstick's arithmetic: the card's peaks, the model FLOPs of a
token, and the least time of a chip-mapped projection's CIM product.

Frozen copies, refreshed only in a benchmark change:
  * `model_flops_token` follows `src/repro_torch/launch/roofline.py`
    (commit a424505): N_eff counts every matmul weight, the embedding as
    a lookup excluded and the unembedding included, routed experts
    scaled by top_k / n_experts; a token costs 2 * N_eff plus attention.
    Attention is counted causally here, 4 * keys * heads * head_dim a
    layer, where that file counts the full square.
  * `cim_bound` is `bound()` of `chip_smoke.py` (commit a424505) for the
    packed kernel on a single-pass plan, its tile geometry worked out
    from the matrix shape as the planner splits it (128-row, 256-column
    tiles): each live tile's tensors read once, the index tables, x read
    once, the output written once, against FP64 multiply-adds of the
    live tiles. The work is the product the plan and M require, not the
    launches of one route.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

# NVIDIA's data sheet, H100 SXM, dense, at the full 700 W power limit
PEAKS = {
    "H100": {"fp64_flops": 67e12, "fp32_flops": 67e12,
             "bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> Dict[str, float]:
    """The peaks of the card named `kind` (torch.cuda.get_device_name)."""
    for key, p in PEAKS.items():
        if key in kind:
            return p
    raise ValueError(f"no peaks for {kind!r} in the benchmark's table")


def projections(m: dict) -> List[Tuple[str, int, int, int]]:
    """(name, rows, cols, chips a layer) of every chip-mapped projection
    of one layer of model section `m`."""
    d, hd = m["d_model"], m["head_dim"]
    q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    out = [("wq", d, q, 1), ("wk", d, kv, 1), ("wv", d, kv, 1),
           ("wo", q, d, 1)]
    if m["n_experts"] > 0:
        de, ds = m["d_expert"], m["d_expert"] * m["n_shared_experts"]
        e = m["n_experts"]
        out += [("sw_g", d, ds, 1), ("sw_i", d, ds, 1), ("sw_o", ds, d, 1),
                ("ew_g", d, de, e), ("ew_i", d, de, e), ("ew_o", de, d, e)]
    else:
        f = m["d_ff"]
        out += [("w_g", d, f, 1), ("w_i", d, f, 1), ("w_o", f, d, 1)]
    return out


def n_eff(m: dict) -> float:
    """Matmul weights a token uses: every projection (routed experts at
    top_k / n_experts), the router, and the unembedding."""
    per_layer = 0.0
    for name, r, c, n in projections(m):
        frac = m["top_k"] / m["n_experts"] if name.startswith("ew_") else 1
        per_layer += r * c * n * frac
    if m["n_experts"] > 0:
        per_layer += m["d_model"] * m["n_experts"]
    return per_layer * m["n_layers"] + m["d_model"] * m["vocab"]


def model_flops_token(m: dict, pos: int) -> float:
    """Model FLOPs of the token at 0-based position `pos`: 2 * N_eff and
    causal attention over pos + 1 keys in every layer."""
    attn = 4.0 * (pos + 1) * m["n_heads"] * m["head_dim"] * m["n_layers"]
    return 2.0 * n_eff(m) + attn


def flops_positions(m: dict, first: int, last: int) -> float:
    """Sum of model_flops_token over positions first .. last - 1."""
    n = max(last - first, 0)
    keys = (first + 1 + last) * n / 2.0            # sum of (pos + 1)
    return 2.0 * n_eff(m) * n + 4.0 * keys * m["n_heads"] * m["head_dim"] \
        * m["n_layers"]


def cim_bound(rows: int, cols: int, m_rows: int, hbm: float, flops: float):
    """(ms, 'bytes' or 'operations') of one single-pass packed launch of a
    (rows, cols) matrix on m_rows input rows."""
    bk, bn = min(128, rows), min(256, cols)
    n_rb, n_cb = math.ceil(rows / bk), math.ceil(cols / bn)
    n_live = n_rb * n_cb
    tile_bytes = bk * bn * 4 + 2 * bn * 4 + 4 + 4
    tables = n_live * 4 + (n_cb + 1) * 4        # row_index, col_start
    nbytes = (n_live * tile_bytes + tables + m_rows * rows * 4
              + m_rows * n_cb * bn * 4)
    ops = 2.0 * m_rows * n_live * bk * bn
    t_bytes, t_ops = nbytes / hbm * 1e3, ops / flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def layer_bound_ms(m: dict, m_rows: int, hbm: float, flops: float) -> float:
    """Least ms of every chip-mapped launch of the model's layers at
    m_rows input rows."""
    one = sum(cim_bound(r, c, m_rows, hbm, flops)[0] * n
              for _, r, c, n in projections(m))
    return one * m["n_layers"]
