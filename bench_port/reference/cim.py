"""The chip's deploy and datapath arithmetic in plain PyTorch: the
benchmark's reference for every chip-mapped projection.

Frozen copy, made on purpose so that a later change to the program
cannot move the yardstick. Copied from the port at commit a424505
(`src/repro_torch/`):

  * `core/conductance.py` weights_to_conductances (the ideal encode),
  * `core/quant.py` quantize_to_int,
  * `core/calibration.py` quantile_linear,
  * `core/cim.py` calibrate_tile_v_decr (one ADC step per tile),
  * `core/mapping.py` plan_layers' split and pack_tiles' normalizers and
    denorms (single-pass plans: 128 x 256 weight tiles, one core each),
  * `kernels/cim_mvm/kernel.py` cim_runs_plain and `_epilogue` (each
    tile's dot in float64 rounded once to float32, the ADC count, the
    tile's weight, the row blocks summed from zero in order),
  * `core/cim.py` packed_forward's rescale.

Refresh it only in a benchmark change, with the new commit named here.
It imports nothing of the program; it works every number out again from
the raw weights and the calibration batches the benchmark made.

`tf32=True` computes every float32 matrix product of this file in TF32,
the tile dots included: the benchmark's control, the step below the
float32-with-TF32-off that the configuration states.
"""
from __future__ import annotations

import contextlib
import math

import torch

G_MIN, G_MAX = 1.0, 40.0       # uS, DeviceConfig
V_READ = 0.5                   # V, CIMConfig.v_read
ROW_CAP, COL_CAP = 128, 256    # weight rows (differential pairs) x columns
COVERAGE = 0.999               # calibration quantile of |charge|
ROWS = 4096                    # input rows through the datapath at once


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matrix products in TF32 inside the block when tf32, else
    in full float32; the previous setting restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def levels(bits: int) -> int:
    """Magnitude levels of a signed `bits`-bit value (ternary at 1 bit)."""
    return max((1 << (bits - 1)) - 1, 1)


def quantize(x, alpha: float, bits: int):
    """(x on the signed integer grid as float32, scale): x ~= x_int *
    scale, scale = alpha / levels (a 0-d float32 tensor)."""
    a = torch.tensor(float(alpha), dtype=torch.float32, device=x.device)
    n = levels(bits)
    scale = a / n
    return torch.clamp(torch.round(x / scale), -n, n).to(torch.float32), scale


def quantile_linear(a, q: float, n_valid):
    """Per row of `a` (rows, N): the linear-method quantile q over the
    first n_valid sorted entries (the rest padded with +inf)."""
    a = torch.sort(a.to(torch.float32), dim=-1).values
    n = n_valid.to(torch.float32)
    pos = torch.tensor(q, dtype=torch.float32, device=a.device) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    low = torch.minimum(torch.clamp(low, min=0), n - 1).to(torch.int64)
    high = torch.minimum(torch.clamp(high, min=0), n - 1).to(torch.int64)
    lo_v = torch.gather(a, -1, low[..., None])[..., 0]
    hi_v = torch.gather(a, -1, high[..., None])[..., 0]
    return lo_v * low_w + hi_v * high_w


def _blocks(mat, r0: int, bk: int, bn: int, n_cb: int):
    """Rows r0 .. r0 + bk of `mat` (R, C) as (n_cb, bk, bn) column blocks,
    zero-padded at the ragged column edge (contiguous)."""
    rows = mat[r0:r0 + bk]
    pad = n_cb * bn - rows.shape[1]
    rows = torch.nn.functional.pad(rows, (0, pad))
    return rows.reshape(bk, n_cb, bn).permute(1, 0, 2).contiguous()


class Chip:
    """One weight matrix (R, C) compiled as the program compiles it onto a
    single-pass chip in 'ideal' mode: the differential encode, one
    normalizer per tile column, one ADC step per tile from the
    calibration batch x_cal (B, R) at input clip `alpha`."""

    def __init__(self, w, x_cal, *, alpha: float, in_bits: int,
                 out_bits: int, tf32: bool = False):
        w = w.to(torch.float32)
        self.rows, self.cols = w.shape
        self.alpha, self.in_bits = float(alpha), in_bits
        self.n_max = float(levels(out_bits))
        self.tf32 = tf32
        dev = w.device
        self.w_max = torch.clamp(torch.max(torch.abs(w)), min=1e-12)
        scaled = G_MAX * w / self.w_max
        g_pos = torch.clamp(scaled, min=G_MIN)
        g_neg = torch.clamp(-scaled, min=G_MIN)
        self.gd = g_pos - g_neg
        gsum = g_pos + g_neg
        self.bk = min(ROW_CAP, self.rows)
        self.bn = min(COL_CAP, self.cols)
        self.n_rb = math.ceil(self.rows / self.bk)
        self.n_cb = math.ceil(self.cols / self.bn)
        cols_in = torch.tensor(
            [min(self.bn, self.cols - j * self.bn) for j in range(self.n_cb)],
            device=dev)
        cmask = torch.arange(self.bn, device=dev)[None, :] < cols_in[:, None]
        x_int, _ = quantize(x_cal.to(torch.float32), alpha, in_bits)
        # every tile of the matrix in one batched product, as the
        # calibration does: the batch's shape picks the product's kernel,
        # and with it the rounding of every charge
        n_b = x_int.shape[0]
        gd_t = torch.cat([_blocks(self.gd, rb * self.bk, self.bk, self.bn,
                                  self.n_cb) for rb in range(self.n_rb)])
        gs_t = torch.cat([_blocks(gsum, rb * self.bk, self.bk, self.bn,
                                  self.n_cb) for rb in range(self.n_rb)])
        del gsum
        rb_of = torch.arange(self.n_rb, device=dev).repeat_interleave(
            self.n_cb)
        xt = x_int.reshape(n_b, self.n_rb, self.bk).permute(1, 0, 2)[rb_of]
        with precision(tf32):
            q = torch.bmm(xt, gd_t) * V_READ / gs_t.sum(dim=1)[:, None, :]
        del xt, gd_t
        mask_t = cmask.repeat(self.n_rb, 1)                 # (T, bn)
        absq = torch.where(mask_t[:, None, :], q.abs(),
                           torch.full((), float("inf"), device=dev))
        qmax = quantile_linear(absq.reshape(self.n_rb * self.n_cb, -1),
                               COVERAGE, cols_in.repeat(self.n_rb) * n_b)
        del q, absq
        v = torch.clamp(qmax, min=1e-9) / self.n_max         # (T,)
        norm = gs_t.sum(dim=1)                               # (T, bn)
        self.inv = torch.where(norm > 0, 1.0 / torch.clamp(norm, min=1e-30),
                               torch.zeros((), device=dev)
                               ).reshape(self.n_rb, self.n_cb, self.bn)
        self.den = (mask_t.to(torch.float32) * norm * v[:, None]).reshape(
            self.n_rb, self.n_cb, self.bn)
        self.vd = v.reshape(self.n_rb, self.n_cb)

    def __call__(self, x):
        """y ~= x @ W through the datapath: x (M, R) float32 -> (M, C),
        ROWS rows at a time (each row's output is its own)."""
        return torch.cat([self._rows(x[i:i + ROWS])
                          for i in range(0, x.shape[0], ROWS)])

    def _rows(self, x):
        x_int, scale = quantize(x.to(torch.float32), self.alpha,
                                self.in_bits)
        m = x_int.shape[0]
        acc = torch.zeros((self.n_cb, m, self.bn), dtype=torch.float32,
                          device=x.device)
        for rb in range(self.n_rb):
            r0 = rb * self.bk
            xb = x_int[:, r0:r0 + self.bk]
            gd_b = _blocks(self.gd, r0, self.bk, self.bn, self.n_cb)
            if self.tf32:
                with precision(True):
                    dot = torch.matmul(xb[None], gd_b)
            else:
                dot = torch.matmul(xb.double()[None],
                                   gd_b.double()).to(torch.float32)
            q = dot * V_READ * self.inv[rb][:, None, :]
            vd = self.vd[rb][:, None, None]
            steps = torch.floor(torch.abs(q) / vd + 0.5)
            count = torch.sign(q) * torch.clamp(steps, max=self.n_max)
            acc = acc + count * self.den[rb][:, None, :]
        acc = acc.permute(1, 0, 2).reshape(m, self.n_cb * self.bn)
        acc = acc[:, :self.cols]
        return acc * self.w_max * scale / (V_READ * G_MAX)
