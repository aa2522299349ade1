"""The copied yardstick arithmetic against hand counts: the kernels'
bound and the model FLOPs of both configurations."""
import pytest

import bp_smoke
from harness import flops, spec


def test_bound_by_hand():
    # granite's w_g: 6144 x 24576 -> 48 x 96 tiles of 128 x 256, M = 16
    tiles = 48 * 96
    nbytes = tiles * (128 * 256 * 4 + 2 * 256 * 4 + 8) + tiles * 4 \
        + 97 * 4 + 16 * 6144 * 4 + 16 * 96 * 256 * 4
    ms, by = flops.cim_bound(6144, 24576, 16, 3.35e12, 67e12)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    # at 256 rows the FP64 multiply-adds bound it
    ms, by = flops.cim_bound(6144, 24576, 256, 3.35e12, 67e12)
    assert by == "operations"
    assert ms == pytest.approx(2 * 256 * tiles * 128 * 256 / 67e12 * 1e3)
    # a ragged edge: 2048 x 1408 -> 16 x 6 tiles, the last 128 wide
    ms, _ = flops.cim_bound(2048, 1408, 4, 1.0, 1e30)
    assert ms * 1e-3 == pytest.approx(
        96 * (128 * 256 * 4 + 2 * 256 * 4 + 8) + 96 * 4 + 7 * 4
        + 4 * 2048 * 4 + 4 * 6 * 256 * 4)


def test_n_eff_of_the_configurations():
    g = spec.cell("granite20b.chat").config["model"]
    layer = 2 * 6144 * 6144 + 2 * 6144 * 128 + 3 * 6144 * 24576
    assert layer == 530_055_168          # "530 M weights a layer"
    assert flops.n_eff(g) == 4 * layer + 6144 * 49152
    d = spec.cell("dsmoe16b.chat").config["model"]
    active = 4 * 2048 * 2048 + 3 * 2048 * 2816 + 6 * 3 * 2048 * 1408 \
        + 2048 * 64
    assert flops.n_eff(d) == 2 * active + 2048 * 102400


@pytest.mark.parametrize("workload", ["granite20b.chat", "dsmoe16b.chat"])
def test_smoke_flops_by_hand(workload):
    m = bp_smoke.smoke_cell(workload).config["model"]
    per = {n: r * c * k for n, r, c, k in flops.projections(m)}
    if m["n_experts"]:
        assert per["ew_g"] == 8 * 128 * 64 and per["sw_o"] == 64 * 128
        layer = sum(v * (2 / 8 if n.startswith("ew_") else 1)
                    for n, v in per.items()) + 128 * 8
    else:
        assert per == {"wq": 128 * 128, "wk": 128 * 16, "wv": 128 * 16,
                       "wo": 128 * 128, "w_g": 128 * 256, "w_i": 128 * 256,
                       "w_o": 256 * 128}
        layer = sum(per.values())
    n_eff = 2 * layer + 128 * 512
    assert flops.n_eff(m) == n_eff
    attn = 4 * 10 * m["n_heads"] * m["head_dim"] * 2
    assert flops.model_flops_token(m, 9) == 2 * n_eff + attn
    assert flops.flops_positions(m, 3, 7) == pytest.approx(
        sum(flops.model_flops_token(m, p) for p in range(3, 7)))


def test_peaks_refuse_an_unknown_card():
    assert flops.peaks("NVIDIA H100 80GB HBM3")["fp64_flops"] == 67e12
    with pytest.raises(ValueError):
        flops.peaks("cpu")
