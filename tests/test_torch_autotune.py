"""Port parity: the launch-geometry autotuner (`kernels/cim_mvm/autotune.py`),
the unfused per-slot baseline (`packed_call(fused=False)`) and the batch
block `bm` that keys the stochastic neuron's draws.

The reference's autotune and tiling tests (tests/test_precision_fused.py)
ported with injected timers: the port tunes the launch route (the split
route and the walk's item layouts, `kernel.Route`) where the reference
tunes bm, and its bm stays the reference's default. `tiling_candidates`
equals the reference's over a grid of shapes and CoreSpecs; `retile`'s
plans equal the reference's (index maps exactly, f32 tensors to
F32_RTOL) and their counts the reference's under the .5-boundary rule of
tests/_torch_parity.py. fused=False equals the reference's fused=False
under the same rule, and the port's fused=True bit for bit on integer
counts; an explicit bm with the stochastic neuron equals the reference's
packed_call(bm=b) except at bits whose noisy charge sits within rounding
of 0.

Inputs are numpy arrays from seeded generators, handed to both packages.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (F32_RTOL, assert_counts_match, boundary_hits,
                           packed_to_torch, to_numpy, to_torch)

from repro_torch.core import mapping as tmap
from repro_torch.core import verify as tverify
from repro_torch.core.types import CIMConfig, CoreSpec
from repro_torch.kernels.cim_mvm import autotune, ops
from repro_torch.kernels.cim_mvm import kernel as K

V_DECR = 0.002


def _conductances(rows, cols, seed):
    """G+ / G- of a seeded (rows, cols) weight matrix by the reference's
    mapping, as numpy."""
    import jax.numpy as jnp
    from repro.core.conductance import weights_to_conductances
    from repro.core.types import CIMConfig as JCfg
    w = np.random.default_rng(seed).normal(0, 0.1, (rows, cols))
    cond = weights_to_conductances(jnp.asarray(w, jnp.float32),
                                   JCfg().device)
    return np.asarray(cond.g_pos), np.asarray(cond.g_neg)


def _tiles(kind):
    """The reference test's plans: a 300 x 500 layer merged onto 3 cores
    (multi-pass, split runs), and a 200 x 400 layer under IR drop."""
    from repro.core.mapping import MatrixReq, ir_drop_max_cols, plan_layers
    from repro.core.types import (CIMConfig as JCfg, CoreSpec as JSpec,
                                  NonIdealityConfig)
    if kind == "merged":
        return plan_layers([MatrixReq("m", 300, 500)],
                           JSpec(n_cores=3)).tiles_for("m")
    cap = ir_drop_max_cols(JCfg(in_bits=4, out_bits=8, nonideal=(
        NonIdealityConfig(ir_drop_alpha=2e-7))))
    return plan_layers([MatrixReq("m", 200, 400)],
                       max_cols_per_core=cap).tiles_for("m")


def _packs(kind, seed=11):
    """(reference plan, the port's copy of it, G+, G-) of `kind`: 'merged',
    'irdrop', or 'transposed' (the merged plan's BL->SL pack)."""
    import jax.numpy as jnp
    from repro.core.mapping import (pack_tiles, pack_tiles_transposed,
                                    schedule_tiles)
    tiles = _tiles("merged" if kind == "transposed" else kind)
    rows = max(t.row0 + t.rows for t in tiles)
    cols = max(t.col0 + t.cols for t in tiles)
    gp, gn = _conductances(rows, cols, seed)
    gd, gs = jnp.asarray(gp - gn), jnp.asarray(gp + gn)
    sched = schedule_tiles(tiles)
    pj = pack_tiles(tiles, gd, gsum=gs, v_decr=V_DECR, schedule=sched)
    if kind == "transposed":
        pj = pack_tiles_transposed(tiles, pj, gsum=gs, v_decr=V_DECR,
                                   schedule=sched)
    return pj, packed_to_torch(pj), gp, gn


def _x(m, k, seed, lim=7):
    return np.random.default_rng(seed).integers(
        -lim, lim + 1, (m, k)).astype(np.float32)


@pytest.fixture(autouse=True)
def _clean_cache():
    autotune.clear()
    yield
    autotune.clear()


# ------------------------------------------------------- route autotuning

def test_autotune_caches_winner_and_serving_picks_it_up(monkeypatch):
    _, pt, _, _ = _packs("merged", seed=13)
    cfg = CIMConfig(in_bits=4, out_bits=8)
    x = to_torch(_x(40, 300, 22))
    assert autotune.lookup(pt, 40, cfg.activation) == 256
    assert autotune.lookup_route(pt, 40, cfg.activation) is None
    walks = tuple(K.Route("walk", lay) for lay in range(3))
    assert autotune.candidates(40) == walks
    assert autotune.candidates(17) == walks[1:]
    assert autotune.candidates(16) == (K.Route("split"),) + walks[1:]
    assert autotune.candidates(4, transpose=True) == walks[1:]
    untuned = to_numpy(ops.cim_mvm_packed(x, pt, cfg))
    fake = iter([3.0, 1.0, 2.0])

    def timer(thunk):
        thunk()                    # the sweep really executes the kernel
        return next(fake)

    winner, timings = autotune.tune(
        x, pt, activation=cfg.activation, n_max=cfg.out_mag_levels,
        v_read=cfg.v_read, timer=timer)
    assert winner == walks[1] and set(timings) == set(walks)
    # same power-of-two bucket -> cache hit, no re-measure; bm untouched
    assert autotune.lookup_route(pt, 40, cfg.activation) == winner
    assert autotune.lookup_route(pt, 64, cfg.activation) == winner
    assert autotune.lookup_route(pt, 16, cfg.activation) is None
    assert autotune.lookup(pt, 40, cfg.activation) == 256
    assert autotune.tune(x, pt, activation=cfg.activation,
                         n_max=cfg.out_mag_levels,
                         v_read=cfg.v_read) == (winner, {})
    # the serving path (route None) passes the winner to the kernel's
    # wrapper and its output is the untuned one, bit for bit
    seen = []
    wrapped = K.cim_mvm_scheduled

    def spy(*a, **kw):
        seen.append(kw["route"])
        return wrapped(*a, **kw)
    monkeypatch.setattr(K, "cim_mvm_scheduled", spy)
    got = to_numpy(ops.cim_mvm_packed(x, pt, cfg))
    assert seen == [winner]
    np.testing.assert_array_equal(got.view(np.int32), untuned.view(np.int32))
    autotune.clear()
    assert autotune.lookup_route(pt, 40, cfg.activation) is None


def test_tune_raises_on_a_candidate_that_changes_the_output(monkeypatch):
    """Every candidate is held to the default route's output before it is
    timed: one that differs fails the sweep instead of being skipped."""
    _, pt, _, _ = _packs("merged", seed=13)
    x = to_torch(_x(8, 300, 5))
    wrapped = K.cim_mvm_scheduled

    def off_by_one(*a, **kw):
        out = wrapped(*a, **kw)
        return out + 1.0 if kw["route"] == K.Route("walk", 2) else out
    monkeypatch.setattr(K, "cim_mvm_scheduled", off_by_one)
    with pytest.raises(RuntimeError, match="differs"):
        autotune.tune(x, pt, activation="none", n_max=127, v_read=0.5,
                      timer=lambda thunk: 1.0)
    assert autotune.lookup_route(pt, 8, "none") is None


def test_tune_skips_routes_that_bust_shared_memory(monkeypatch):
    """The verifier's shared-memory invariant is the skip rule: a plan
    whose every route busts the limit raises it, naming the plan."""
    _, pt, _, _ = _packs("merged", seed=3)
    x = to_torch(_x(8, 300, 6))
    monkeypatch.setattr(tverify, "SMEM_LIMIT", 1024)
    with pytest.raises(tverify.ChipVerifyError) as e:
        autotune.tune(x, pt, activation="none", n_max=127, v_read=0.5,
                      timer=lambda thunk: 1.0)
    assert e.value.invariant == "shared-memory"
    with pytest.raises(tverify.ChipVerifyError, match="split route"):
        tverify.check_packed(pt, bm=64, route=K.Route("split"))


# ------------------------------------------------------ plan-time retiling

@pytest.mark.parametrize("n_cores", [3, 8, 48, 1024])
def test_tiling_candidates_match_reference(n_cores):
    from repro.kernels.cim_mvm import autotune as jauto
    from repro.core.types import CoreSpec as JSpec
    for rows, cols in ((300, 500), (30, 60), (100, 120), (256, 256),
                       (1000, 70), (64, 1024), (3584, 14336)):
        for spec_t, spec_j in ((None, None), (CoreSpec(n_cores=n_cores),
                                              JSpec(n_cores=n_cores))):
            assert autotune.tiling_candidates(rows, cols, spec_t) == \
                jauto.tiling_candidates(rows, cols, spec_j), (rows, cols)


@pytest.mark.parametrize("bk,bn", [(128, 256), (64, 128)])
def test_retile_matches_reference(bk, bn):
    """The uniform grid at explicit caps: the port's re-pack holds the
    reference's plan (index maps exactly, f32 tensors to F32_RTOL), and
    its counts equal the reference's under the .5-boundary rule."""
    import jax.numpy as jnp
    from repro.core.mapping import multicore_mvm_packed
    from repro.core.types import CIMConfig as JCfg
    from repro.kernels.cim_mvm import autotune as jauto
    gp, gn = _conductances(300, 500, 17)
    pj = jauto.retile(jnp.asarray(gp - gn), bk, bn,
                      gsum=jnp.asarray(gp + gn), v_decr=V_DECR)
    pt = autotune.retile(to_torch(gp - gn), bk, bn,
                         gsum=to_torch(gp + gn), v_decr=V_DECR)
    for f in ("bk", "bn", "n_rows", "n_cols", "row_block", "col_block",
              "seq_slot", "n_passes", "transpose", "tile_slot", "out_slot",
              "out_col"):
        assert getattr(pt, f) == getattr(pj, f), f
    for f in ("gd_tiles", "inv_norm_tiles", "v_decr_tiles", "denorm_tiles"):
        np.testing.assert_allclose(to_numpy(getattr(pt, f)),
                                   np.asarray(getattr(pj, f)),
                                   rtol=F32_RTOL, atol=0, err_msg=f)
    x = _x(4, 300, 31)
    got = to_numpy(tmap.multicore_mvm_packed(to_torch(x), pt, CIMConfig()))
    want = np.asarray(multicore_mvm_packed(jnp.asarray(x), pj, JCfg()))
    assert_counts_match(got, want, boundary_hits(x, pt, 0.5))
    with pytest.raises(ValueError):
        autotune.retile(to_torch(gp - gn), 512, 256)   # caps outside


def test_tune_tiling_caches_winner_per_layer_signature():
    gp, gn = _conductances(100, 120, 19)
    gd, gs = to_torch(gp - gn), to_torch(gp + gn)
    x = to_torch(_x(8, 100, 23))
    cfg = CIMConfig(in_bits=4, out_bits=8)
    assert autotune.lookup_tiling(100, 120, 8, cfg.activation) is None
    cands = autotune.tiling_candidates(100, 120)
    # a strictly decreasing timer over every route of every re-pack: the
    # last candidate's last route wins
    n_runs = len(cands) * len(autotune.candidates(8))
    fake = iter(range(n_runs, 0, -1))

    def timer(thunk):
        thunk()                    # the sweep really executes each re-pack
        return float(next(fake))

    winner, timings = autotune.tune_tiling(
        x, gd, gsum=gs, v_decr=V_DECR, activation=cfg.activation,
        n_max=cfg.out_mag_levels, v_read=cfg.v_read, timer=timer)
    assert winner == cands[-1] and set(timings) == set(cands)
    assert autotune.lookup_tiling(100, 120, 8, cfg.activation) == winner
    assert autotune.lookup_tiling(100, 120, 5, cfg.activation) == winner
    assert autotune.tune_tiling(
        x, gd, gsum=gs, v_decr=V_DECR, activation=cfg.activation,
        n_max=cfg.out_mag_levels, v_read=cfg.v_read) == (winner, {})
    # a different epilogue is a different chip -> separate cache line
    assert autotune.lookup_tiling(100, 120, 8, "relu",
                                  fold_norm=True) is None
    autotune.clear()
    assert autotune.lookup_tiling(100, 120, 8, cfg.activation) is None


# ------------------------------------------------- the unfused baseline

@pytest.mark.parametrize("kind", ["merged", "irdrop", "transposed"])
def test_unfused_matches_reference_and_fused(kind):
    """fused=False against the reference's fused=False (the count rule),
    and against the port's fused=True bit for bit (fold_norm=False: the
    counts are integers, so any grouping of their sum is exact)."""
    import jax.numpy as jnp
    from repro.core.mapping import multicore_mvm_packed
    from repro.core.types import CIMConfig as JCfg
    pj, pt, _, _ = _packs(kind)
    assert pt.n_passes > 1 or kind == "irdrop"
    x = _x(4, pt.n_rows, 21)
    got = to_numpy(tmap.multicore_mvm_packed(
        to_torch(x), pt, CIMConfig(in_bits=4), scheduled=True, fused=False))
    want = np.asarray(multicore_mvm_packed(
        jnp.asarray(x), pj, JCfg(in_bits=4), scheduled=True, fused=False))
    assert_counts_match(got, want, boundary_hits(x, pt, 0.5))
    fused = to_numpy(tmap.multicore_mvm_packed(
        to_torch(x), pt, CIMConfig(in_bits=4), scheduled=True))
    np.testing.assert_array_equal(got.view(np.int32), fused.view(np.int32))
    rs, crs, cr, n_ranks, n_len = pt.run_layout(fused=False)
    assert n_len == 1 and int(rs[-1]) == pt.n_tiles
    assert n_ranks == max(np.bincount(
        [c for c, r in zip(pt.col_block, pt.out_slot)
         if pt.out_col[r] >= 0]))


@pytest.mark.parametrize("bm", [16, 32, 64])
def test_explicit_bm_keys_the_stochastic_draws_as_the_reference(bm):
    """packed_call(bm=b) with the stochastic neuron: the draws hash at
    (row % b, row // b), as the reference's grid does; equal to the
    reference's packed_call(bm=b) except at bits whose noisy charge lies
    within rounding of 0 (`boundary_counts` at the same bm)."""
    import jax.numpy as jnp
    from repro.core.mapping import MatrixReq, pack_tiles, plan_layers
    from repro.kernels.cim_mvm.ops import packed_call as jcall
    gp, gn = _conductances(100, 120, 29)
    tiles = plan_layers([MatrixReq("m", 100, 120)]).tiles_for("m")
    pj = pack_tiles(tiles, jnp.asarray(gp - gn), gsum=jnp.asarray(gp + gn),
                    v_decr=V_DECR)
    pt = packed_to_torch(pj)
    x = _x(72, 100, 33)
    kw = dict(activation="stochastic", n_max=127, v_read=0.5, seed=5)
    got = to_numpy(ops.packed_call(to_torch(x), pt, bm=bm, **kw))
    want = np.asarray(jcall(jnp.asarray(x), pj, bm=bm, **kw))
    hits = to_numpy(K.boundary_counts(
        to_torch(x), pt.gd_tiles, pt.inv_norm_tiles, pt.v_decr_tiles,
        pt.row_index, pt.run_start, pt.col_run_start, pt.col_runs,
        n_run_ranks=pt.n_run_ranks, n_run_len=pt.n_run_len, v_read=0.5,
        activation="stochastic", seed=5, bm=bm))[:, :pt.n_cols]
    assert_counts_match(got, want, hits)
    # a different block draws other bits
    other = to_numpy(ops.packed_call(to_torch(x), pt, bm=2 * bm, **kw))
    assert not np.array_equal(got, other)
