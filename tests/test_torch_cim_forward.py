"""The per-matrix forward with its glue fused into the single-matrix kernel
(`kernel.cim_forward`, reached through `core.cim.forward` and
`models.nn.chip_linear`), the kernel's geometry, and the verifier's
`shared-memory` rule for it.

Rule: the fused forward's plain version equals the composition it replaces
(bias rows appended, quantize_to_int, the unfused single-matrix MVM,
offset cancellation, dequantize_output) bit for bit (`torch.equal`), in
every activation `forward` takes, with and without bias rows; on the card
the kernel equals its plain version bit for bit. Parity with the JAX
reference is in test_torch_chip_linear.py (forward) and test_torch_cnn.py
(every chip layer of both CNNs).

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cim_forward.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import cim as tcim
from repro_torch.core import verify as tverify
from repro_torch.core.quant import quantize_to_int
from repro_torch.core.types import CIMConfig
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.kernels.cim_mvm import ops
from repro_torch.kernels.cim_mvm.ref import dequantize_output
from repro_torch.models import nn

FORWARD_ACTS = ("none", "relu", "tanh", "sigmoid", "identity")
SEED = 7
# every chip matrix of the 7-layer CNN and ResNet-20 at batch 256 (rows M,
# K with the bias row, N), and ragged batches and widths
CNN_SHAPES = [(200704, 10, 16), (200704, 145, 16), (50176, 145, 32),
              (50176, 289, 32), (12544, 289, 64), (12544, 577, 64),
              (256, 577, 10), (262144, 28, 16), (262144, 145, 16),
              (65536, 145, 32), (65536, 289, 32), (65536, 17, 32),
              (16384, 289, 64), (16384, 577, 64), (16384, 33, 64),
              (256, 65, 10)]
RAGGED_SHAPES = [(1, 145, 16), (3, 577, 10), (257, 289, 10), (257, 33, 64),
                 (5, 300, 500), (1, 9000, 8), (4096, 9000, 70)]


def _layer(k, n, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0, 1 / k ** 0.5, (k, n)).astype(
        np.float32))
    x_cal = torch.from_numpy(rng.normal(0, 1, (32, k)).astype(np.float32))
    return tcim.program(w, CIMConfig(in_bits=4, out_bits=8), 2.0, x_cal,
                        "relaxed", torch.Generator().manual_seed(seed))


def _composition(layer, x, cfg, bias, bias_rows):
    """The per-matrix forward before the glue was fused: chip_linear's
    concatenation, then forward's quantize, MVM, offset and dequantize."""
    if bias_rows:
        x = torch.cat([x, bias.expand(x.shape[0], bias_rows).to(x.dtype)],
                      dim=-1)
    x_int, scale = quantize_to_int(x, layer.in_alpha, cfg.in_bits,
                                   signed=True)
    counts = ops.cim_mvm(x_int, layer.g_pos, layer.g_neg, layer.v_decr, cfg,
                         seed=SEED, norm=layer.norm)
    off = torch.round(layer.adc_offset / layer.v_decr)
    if cfg.activation == "none":
        counts = counts - off[None, :]
    return dequantize_output(counts, layer.v_decr, layer.norm, layer.w_max,
                             scale, cfg)


@pytest.mark.parametrize("bias_rows", [0, 2])
@pytest.mark.parametrize("activation", FORWARD_ACTS)
def test_fused_plain_equals_composition(activation, bias_rows):
    """Bit for bit, inputs past the clip included (they saturate)."""
    k_x = 70
    lay = _layer(k_x + bias_rows, 24)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1.5, (37, k_x)).astype(np.float32))
    cfg = CIMConfig(in_bits=4, out_bits=8, activation=activation)
    bias = lay.in_alpha.clone()
    got = tcim.forward(lay, x, cfg, bias=bias, bias_rows=bias_rows,
                       seed=SEED)
    want = _composition(lay, x, cfg, bias, bias_rows)
    assert got.dtype == torch.float32 and got.shape == (37, 24)
    assert torch.equal(got, want)


def test_chip_linear_is_one_fused_call(monkeypatch):
    """chip_linear hands the patches and the bias rows to ONE fused call
    and returns the composition's output."""
    lay = _layer(41, 10)
    cl = nn.ChipLinear(lay, 1, lay.in_alpha.clone(), False)
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 2, (9, 40)).astype(np.float32))
    calls = []
    real = K.cim_forward

    def count(*a, **kw):
        calls.append(kw["bias_rows"])
        return real(*a, **kw)
    monkeypatch.setattr(K, "cim_forward", count)
    cfg = CIMConfig(in_bits=4, out_bits=8, activation="relu")
    got = nn.chip_linear(cl, x, cfg, seed=SEED)
    assert calls == [1]
    assert torch.equal(got, _composition(lay, x, cfg, cl.alpha, 1))


def test_prepare_forms_the_kernel_operands_once():
    """program() prepares: gd, 1 / norm and the offset counts as forward
    formed them per call; an unprepared layer is refused."""
    lay = _layer(33, 12)
    assert torch.equal(lay.gd, lay.g_pos - lay.g_neg)
    assert torch.equal(lay.inv_norm, 1.0 / lay.norm)
    assert torch.equal(lay.off_counts,
                       torch.round(lay.adc_offset / lay.v_decr))
    assert all(t.is_contiguous() for t in (lay.gd, lay.inv_norm,
                                           lay.off_counts))
    bare = tcim.CIMLayer(*(getattr(lay, f) for f in tcim.LAYER_FIELDS))
    with pytest.raises(ValueError, match="prepare"):
        tcim.forward(bare, torch.zeros(2, 33), CIMConfig())
    again = tcim.prepare(bare)
    assert all(torch.equal(a, b) for a, b in zip(again, lay))


def test_fused_wrapper_rejects_what_it_does_not_take():
    lay = _layer(20, 8)
    args = (lay.gd, lay.inv_norm, lay.v_decr, lay.off_counts, lay.norm,
            lay.w_max, lay.in_alpha)
    with pytest.raises(ValueError, match="stochastic"):
        K.cim_forward(torch.zeros(2, 20), *args,
                      CIMConfig(activation="stochastic"))
    with pytest.raises(ValueError, match="bias rows"):
        K.cim_forward(torch.zeros(2, 18), *args, CIMConfig(),
                      bias=lay.in_alpha, bias_rows=1)
    with pytest.raises(ValueError, match="device"):
        K.cim_forward(torch.zeros(2, 20, device="meta"),
                      *(a.to("meta") for a in args), CIMConfig())


def test_fused_cpu_runs_plain_without_launching():
    lay = _layer(30, 16)
    x = torch.randn(5, 29, generator=torch.Generator().manual_seed(3))
    before = dict(K.LAUNCHES)
    for act in FORWARD_ACTS:
        cfg = CIMConfig(activation=act)
        assert torch.equal(
            tcim.forward(lay, x, cfg, bias=lay.in_alpha, bias_rows=1),
            tcim.forward(lay, x, cfg, bias=lay.in_alpha, bias_rows=1,
                         impl="plain"))
    assert K.LAUNCHES == before


# ------------------------------------------------------------- geometry

def _occupancy(g, k_x):
    """A stand-in for the runtime's count of resident blocks: an SM's
    shared memory (228 KB, 1 KB reserved per block) and registers for
    three blocks of one warp group, one of two."""
    return min(233_472 // (K.mvm_shared_bytes(g, k_x) + 1024),
               3 if g.kg == 1 else 1)


def _geometry(m, k, n, k_x=None, n_sm=K.H100_SMS):
    return K.mvm_geometry(m, k, n, k_x, occupancy=_occupancy, n_sm=n_sm)


def _check_geometry(m, k, n, k_x, n_sm=K.H100_SMS):
    g = _geometry(m, k, n, k_x, n_sm)
    assert K.mvm_shared_bytes(g, k_x) <= K.SMEM_LIMIT
    assert g.bn == 8 * g.gf * g.wc and g.cr == (K.MVM_WARPS // g.wc) * 8 \
        * g.rf
    assert g.n_ct * g.bn >= n > (g.n_ct - 1) * g.bn
    assert g.n_slices * g.bk >= k and g.bk % 16 == 0
    assert g.n_ks * g.spb >= g.n_slices > (g.n_ks - 1) * g.spb
    assert g.contiguous == 0 or g.n_slices == 1
    # a second warp group only where one block fills an SM
    one = K.MvmGeometry(*(getattr(g, f) for f, _ in g._fields_[:-1]), 1)
    assert g.kg == 1 or _occupancy(one, k_x) == 1
    assert g.kg == 1 or K.mvm_stage_bytes(g, k_x) >= 128 * g.rf * g.gf * 16
    # the persistent grid runs every (column tile, row chunk, slice) unit
    # exactly once, whatever the grid
    want = sorted((ct, rc, s) for ct in range(g.n_ct)
                  for rc in range(g.n_rc) for s in range(g.n_slices))
    for grid in (1, 7, n_sm, 2 * n_sm, 10 ** 6):
        got = sorted(u for b in range(min(grid, g.n_ct * g.n_rc * g.n_ks))
                     for u in K.mvm_units(g, grid, b))
        assert got == want
    # every bulk copy: 16-byte aligned start and size, inside its stage,
    # covering the bytes the unit reads and no 16-byte segment x does not
    # touch; for x at any 4-byte offset
    stage = K.mvm_stage_bytes(g, k_x)
    chunks = sorted({0, 1, g.n_rc - 1})
    slices = sorted({0, g.n_slices - 1})
    for base in (256, 260, 268):
        end = base + m * k_x * 4
        for rc in chunks:
            for sl in slices:
                copies = K.mvm_copies(g, m, k_x, rc, sl, base)
                for lo, nbytes, dst, first in copies:
                    assert lo % 16 == 0 and nbytes % 16 == 0 \
                        and dst % 16 == 0 and nbytes > 0
                    assert dst + nbytes <= stage
                    assert lo >= base & ~15 and lo + nbytes <= (end + 15) & ~15
                    assert 0 <= first - dst < 16
                rows = min(g.cr, m - rc * g.cr)
                k0 = sl * g.bk
                want_bytes = rows * (k_x * 4 if g.contiguous
                                     else max(min(g.bk, k_x - k0), 0) * 4)
                assert sum(nb for _, nb, _, _ in copies) >= want_bytes


@pytest.mark.parametrize("m,k,n", CNN_SHAPES)
def test_geometry_at_cnn_shapes(m, k, n):
    """Both the unfused launch (K columns) and the fused one (K - 1 columns
    and a bias row): shared memory, alignment and coverage; gd resident
    (one slice) and every column in one tile."""
    for k_x in (k, k - 1):
        _check_geometry(m, k, n, k_x)
        g = _geometry(m, k, n, k_x)
        assert g.n_ct == 1
        if m > 256:
            assert g.contiguous == 1 and g.n_ks == 1
            assert g.kg == (2 if (k, n) == (577, 64) else 1)


@pytest.mark.parametrize("m,k,n", RAGGED_SHAPES)
def test_geometry_at_ragged_shapes(m, k, n):
    """Small batches split K over the SMs; a K too long for whole-row
    chunks is sliced."""
    _check_geometry(m, k, n, k)
    g = _geometry(m, k, n)
    if m <= 257:
        assert g.n_ct * g.n_rc * g.n_ks >= min(
            K.H100_SMS // 2, g.n_ct * g.n_rc * g.n_slices)
    if k == 9000:
        assert g.contiguous == 0 and g.n_slices > 1


def test_geometry_ranks_tilings_by_the_occupancy_it_is_given():
    """The layout with the most resident blocks wins, whatever the shared
    memory alone would allow; a second warp group joins only where one
    block is resident, and only if it can launch."""
    m, k, n = 50176, 145, 32          # three warp layouts fit
    for wc in (1, 2, 4):
        g = K.mvm_geometry(m, k, n, occupancy=lambda g, kx: 3 if g.wc == wc
                           else 2, n_sm=K.H100_SMS)
        assert (g.wc, g.kg) == (wc, 1)
    g = K.mvm_geometry(m, k, n, occupancy=K.one_block, n_sm=K.H100_SMS)
    assert g.kg == 2
    g = K.mvm_geometry(m, k, n, occupancy=lambda g, kx: int(g.kg == 1),
                       n_sm=K.H100_SMS)
    assert g.kg == 1
    # a tiling the card cannot launch is never taken
    g = K.mvm_geometry(m, k, n, occupancy=lambda g, kx: int(g.stages == 3),
                       n_sm=K.H100_SMS)
    assert g.stages == 3


def test_shared_memory_rule_for_a_layer(monkeypatch):
    """check_layer's `shared-memory`: a CNN layer fits; with a limit below
    its geometry's need it is reported at stage `program`."""
    lay = _layer(577, 64)
    tverify.check_layer(lay.g_pos, lay.g_neg, bm=12544)
    need = K.mvm_shared_bytes(K.mvm_geometry(
        12544, 577, 64, occupancy=K.one_block, n_sm=K.H100_SMS), 577)
    assert need <= K.SMEM_LIMIT
    monkeypatch.setattr(tverify, "SMEM_LIMIT", need - 1)
    with pytest.raises(tverify.ChipVerifyError) as e:
        tverify.check_layer(lay.g_pos, lay.g_neg, bm=12544)
    assert (e.value.stage, e.value.invariant) == ("program",
                                                  "shared-memory")


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_kernel_and_fused_forward_match_plain_on_card():
    """Both entries of the single-matrix kernel against their plain
    versions on relaxed conductances, bit for bit: the unfused MVM in every
    activation, the fused forward in every activation it takes with one
    and two bias rows, at a contiguous, a column-split and K-split
    geometry; each launch's grid at most one block per work item."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for m, k, n in ((12544, 577, 64), (3, 577, 10), (5, 300, 500),
                    (70000, 145, 16)):
        w = torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
        lay = tcim.program(w, CIMConfig(), 3.0, mode="relaxed",
                           generator=gen)
        x = torch.randint(-7, 8, (m, k), generator=gen,
                          device=dev).to(torch.float32)
        for act in FORWARD_ACTS + ("stochastic",):
            kw = dict(activation=act, seed=SEED)
            before = K.LAUNCHES["cim_mvm"]
            got = K.cim_mvm(x, lay.gd, lay.inv_norm, lay.v_decr, **kw)
            torch.cuda.synchronize()
            assert K.LAUNCHES["cim_mvm"] == before + 1
            assert torch.equal(got, K.cim_mvm(x, lay.gd, lay.inv_norm,
                                              lay.v_decr, impl="plain",
                                              **kw)), (m, k, n, act)
        for fused in (False, True):
            g, grid = K.mvm_launch_geometry(m, k, n, k - fused, fused, dev)
            assert 1 <= grid <= g.n_ct * g.n_rc * g.n_ks
        for rows in (1, 2):
            xf = torch.randn(m, k - rows, generator=gen, device=dev) * 2
            for act in FORWARD_ACTS:
                cfg = CIMConfig(activation=act)
                got = tcim.forward(lay, xf, cfg, bias=lay.in_alpha,
                                   bias_rows=rows)
                want = tcim.forward(lay, xf, cfg, bias=lay.in_alpha,
                                    bias_rows=rows, impl="plain")
                assert torch.equal(got, want), (m, k, n, act, rows)
