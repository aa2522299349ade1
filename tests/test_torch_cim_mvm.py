"""Port parity, the packed CIM MVM: the port's plain executor against the
reference's `cim_mvm_packed` (its Pallas kernel in interpret mode, as the
reference's own tests run it) on the same packed plan and inputs, for
every activation mode; and, where a CUDA device is present, the CUDA
kernel against the plain executor.

Rule (ROADMAP north star): accumulated ADC counts agree exactly except
at outputs where a contributing tile's reference |q|/v_decr lies within
f32 rounding of a .5 boundary; the raw-charge (identity) mode agrees to
f32 rounding of the sums.

JAX is imported by the fixtures that need it, so the CUDA test also runs
where only the port is installed:
    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cim_mvm.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import (assert_counts_match, boundary_hits,
                           packed_to_torch, to_numpy, to_torch)

from repro_torch.core import cim as tcim
from repro_torch.core.mapping import MatrixReq, pack_tiles, plan_layers
from repro_torch.core.types import CIMConfig, CoreSpec
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.kernels.cim_mvm import ops

ACTS = ("none", "relu", "tanh", "sigmoid", "identity")
R, C, M = 300, 500, 24          # the ragged split layer: 3 x 2 tiles


@pytest.fixture(scope="module")
def case():
    """One programmed 300x500 layer packed twice by the reference (raw
    count accumulation and folded denorms), integer inputs, and the
    reference's outputs for every activation."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.conductance import weights_to_conductances
    from repro.core.mapping import (MatrixReq as JReq, pack_tiles as jpack,
                                    plan_layers as jplan)
    from repro.core.types import CIMConfig as JCfg
    from repro.kernels.cim_mvm.ops import cim_mvm_packed

    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.1, (R, C)).astype(np.float32)
    x = rng.integers(-7, 8, (M, R)).astype(np.float32)
    cond = weights_to_conductances(jnp.asarray(w), JCfg().device)
    tiles = jplan([JReq("m", R, C)]).tiles_for("m")
    vd = rng.uniform(0.02, 0.05, len(tiles)).astype(np.float32)
    packs, outs = {}, {}
    for fold in (False, True):
        pj = jpack(tiles, cond.g_pos - cond.g_neg,
                   gsum=cond.g_pos + cond.g_neg, v_decr=jnp.asarray(vd),
                   fold_norm=fold)
        packs[fold] = pj
        for act in ACTS:
            outs[fold, act] = np.asarray(cim_mvm_packed(
                jnp.asarray(x), pj, JCfg(activation=act), interpret=True))
    return {"x": x, "packs": packs, "outs": outs}


@pytest.mark.parametrize("activation", ACTS)
def test_plain_matches_reference_counts(case, activation):
    """Raw-count packs (denorm = valid-column mask): integer sums."""
    pt = packed_to_torch(case["packs"][False])
    got = to_numpy(ops.cim_mvm_packed(to_torch(case["x"]), pt,
                                      CIMConfig(activation=activation)))
    want = case["outs"][False, activation]
    if activation == "identity":
        # f32 sums of <= 128 products in another order: relative 2^-17
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=2e-5 * np.abs(want).max())
        return
    assert_counts_match(got, want, boundary_hits(case["x"], pt, 0.5))


@pytest.mark.parametrize("activation", ("none", "relu"))
def test_plain_matches_reference_folded(case, activation):
    """Serving packs (denorm = mask * norm * v_decr): a flipped count moves
    an output by its tile's denorm; everything else agrees to the f32
    rounding of the row-split sum (the reference may contract the
    multiply-add, the port rounds twice): n_rb adds whose running sums
    stay below n_rb * n_max * max(denorm), half an ulp each, for each of
    the two executions."""
    pj = case["packs"][True]
    pt = packed_to_torch(pj)
    got = to_numpy(ops.cim_mvm_packed(to_torch(case["x"]), pt,
                                      CIMConfig(activation=activation)))
    want = case["outs"][True, activation]
    hits = boundary_hits(case["x"], pt, 0.5)
    den_max = float(np.asarray(pj.denorm_tiles).max())
    n_rb, n_max = pt.n_row_blocks, CIMConfig().out_mag_levels
    tol = hits * den_max + 2 * n_rb * 2.0 ** -24 * n_rb * n_max * den_max
    assert np.all(np.abs(got - want) <= tol)


def test_cpu_wrapper_runs_plain_without_launching():
    """A CPU tensor takes the plain version; the launch count is for the
    kernel only."""
    before = K.LAUNCHES
    tiles = plan_layers([MatrixReq("m", 40, 30)]).tiles_for("m")
    p = pack_tiles(tiles, torch.ones(40, 30))
    y = ops.packed_call(torch.ones(2, 40), p, activation="identity",
                        n_max=1, v_read=1.0)
    assert torch.equal(y, torch.full((2, 30), 40.0))
    assert K.LAUNCHES == before


def test_unported_plans_and_modes_raise():
    from repro_torch.core.mapping import schedule_tiles
    tiles = plan_layers([MatrixReq("m", 200, 70)]).tiles_for("m")
    single = pack_tiles(tiles, torch.ones(200, 70))
    for i, t in enumerate(tiles):          # two tiles time-share one core
        t.seq_slot = i
    multi = pack_tiles(tiles, torch.ones(200, 70),
                       schedule=schedule_tiles(tiles))
    assert multi.n_passes == 2
    with pytest.raises(NotImplementedError, match="B2"):
        ops.packed_call(torch.ones(2, 200), multi, activation="none",
                        n_max=127, v_read=0.5)
    with pytest.raises(NotImplementedError, match="B3"):
        ops.packed_call(torch.ones(2, 200), single, activation="stochastic",
                        n_max=127, v_read=0.5)
    with pytest.raises(ValueError, match="features"):
        ops.packed_call(torch.ones(2, 199), single, activation="none",
                        n_max=127, v_read=0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTS)
def test_kernel_matches_plain_on_card(activation):
    """The CUDA kernel against its plain version at a ragged plan and a
    full-width gemma2-9b shape: equal bit for bit (the tile dot is exact
    in FP64, every later operation the same IEEE operation in order)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for (r, c, m) in ((300, 500, 5), (3584, 2048, 4), (4096, 3584, 37)):
        w = {"m": torch.randn(r, c, generator=gen, device=dev) / r ** 0.5}
        chip = tcim.compile_chip(w, CIMConfig(), CoreSpec(n_cores=4096),
                                 "ideal", in_alpha=3.0, generator=gen)
        p = chip.layers["m"].packed
        x = torch.randint(-7, 8, (m, r), generator=gen,
                          device=dev).to(torch.float32)
        before = K.LAUNCHES
        cfg = CIMConfig(activation=activation)
        got = ops.cim_mvm_packed(x, p, cfg)
        want = ops.cim_mvm_packed(x, p, cfg, impl="plain")
        torch.cuda.synchronize()
        assert K.LAUNCHES == before + 1
        assert torch.equal(got, want), (r, c, m)
