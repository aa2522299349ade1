"""Port parity, chip compiler stages 1, 2 and 5: plans, schedules and every
index map of `repro_torch.core.mapping` equal `repro.core.mapping`'s
exactly; packed f32 tensors agree to f32 rounding."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import F32_RTOL, to_numpy, to_torch

import repro.core.mapping as jmap
import repro.core.types as jtypes
import repro_torch.core.mapping as tmap
import repro_torch.core.types as ttypes

TILE_FIELDS = ("layer", "row0", "col0", "rows", "cols", "core", "replica",
               "seq_slot")
INDEX_MAPS = ("row_block", "col_block", "seq_slot", "n_passes", "transpose",
              "tile_slot", "out_slot", "out_col", "bk", "bn", "n_rows",
              "n_cols")


def _case(kind):
    """(reqs as (name, rows, cols, intensity), n_cores, target)."""
    if kind == "split":              # the ragged 300x500 layer
        return [("m", 300, 500, 1.0)], 48, "m"
    if kind == "duplicate":
        return [("hot", 100, 60, 8.0), ("cold", 64, 32, 1.0)], 48, "hot"
    if kind == "merge":              # merged cores -> multi-pass schedule
        reqs = [(f"s{i}", 30, 40, 0.5) for i in range(6)]
        return reqs + [("m", 200, 70, 1.0)], 6, "m"
    if kind == "merge-small":
        reqs = [(f"s{i}", 30, 40, 0.5) for i in range(6)]
        return reqs + [("m", 200, 70, 1.0)], 6, "s2"
    if kind == "passes":             # seq slots set by hand: 4 passes
        return [("m", 300, 500, 1.0)], 48, "m"
    if kind == "gemma-smoke":        # gemma2-9b SMOKE's seven projections
        d, q, kv, f = 128, 128, 64, 256
        reqs = [("wq", d, q, 1.0), ("wk", d, kv, 1.0), ("wv", d, kv, 1.0),
                ("wo", q, d, 1.0), ("w_g", d, f, 1.0), ("w_i", d, f, 1.0),
                ("w_o", f, d, 1.0)]
        return reqs, 48, "w_o"
    raise ValueError(kind)


KINDS = ("split", "duplicate", "merge", "merge-small", "passes",
         "gemma-smoke")


def _plans(kind):
    reqs, n_cores, target = _case(kind)
    pj = jmap.plan_layers([jmap.MatrixReq(*r) for r in reqs],
                          jtypes.CoreSpec(n_cores=n_cores))
    pt = tmap.plan_layers([tmap.MatrixReq(*r) for r in reqs],
                          ttypes.CoreSpec(n_cores=n_cores))
    if kind == "passes":             # multi-pass schedule with idle slots
        for plan in (pj, pt):
            for i, t in enumerate(plan.tiles):
                t.seq_slot = i % 4 if i < 4 else i % 3
    return reqs, pj, pt, target


def _tiles(plan):
    return [tuple(getattr(t, f) for f in TILE_FIELDS) for t in plan.tiles]


@pytest.mark.parametrize("kind", KINDS)
def test_plan_equal(kind):
    _, pj, pt, _ = _plans(kind)
    assert _tiles(pt) == _tiles(pj)
    assert (pt.n_cores_used, pt.duplicated, pt.merged) == \
        (pj.n_cores_used, pj.duplicated, pj.merged)


@pytest.mark.parametrize("kind", KINDS)
def test_schedule_equal(kind):
    reqs, pj, pt, _ = _plans(kind)
    for name, *_ in reqs:
        sj = jmap.schedule_tiles(pj.tiles_for(name))
        st = tmap.schedule_tiles(pt.tiles_for(name))
        assert (st.order, st.n_passes, st.pass_len) == \
            (sj.order, sj.n_passes, sj.pass_len)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_pack_equal(kind, fold):
    """Index maps exactly equal, tensors to f32 rounding, for single-pass
    and scheduled (idle-slot) packs, raw-count and folded denorms."""
    reqs, pj, pt, target = _plans(kind)
    r, c = next((r, c) for n, r, c, _ in reqs if n == target)
    rng = np.random.default_rng(len(kind))
    gp = rng.uniform(1, 40, (r, c)).astype(np.float32)
    gn = rng.uniform(1, 40, (r, c)).astype(np.float32)
    tj, tt = pj.tiles_for(target), pt.tiles_for(target)
    vd = rng.uniform(0.001, 0.01, len(tj)).astype(np.float32)
    kj = jmap.pack_tiles(tj, jnp.asarray(gp - gn), gsum=jnp.asarray(gp + gn),
                         v_decr=jnp.asarray(vd), fold_norm=fold,
                         schedule=jmap.schedule_tiles(tj))
    kt = tmap.pack_tiles(tt, to_torch(gp - gn), gsum=to_torch(gp + gn),
                         v_decr=to_torch(vd), fold_norm=fold,
                         schedule=tmap.schedule_tiles(tt))
    for f in INDEX_MAPS:
        assert getattr(kt, f) == getattr(kj, f), f
    np.testing.assert_array_equal(to_numpy(kt.gd_tiles),
                                  np.asarray(kj.gd_tiles))
    np.testing.assert_array_equal(to_numpy(kt.v_decr_tiles),
                                  np.asarray(kj.v_decr_tiles))
    for f in ("inv_norm_tiles", "denorm_tiles"):
        np.testing.assert_allclose(to_numpy(getattr(kt, f)),
                                   np.asarray(getattr(kj, f)),
                                   rtol=F32_RTOL, err_msg=f)
    assert to_numpy(kt.row_index).tolist() == list(kj.row_block)


@pytest.mark.parametrize("kind", KINDS)
def test_col_start_offsets(kind):
    """Single-pass packs carry CSR offsets that reproduce col_block; a
    multi-pass pack (col_block not non-decreasing) carries none."""
    reqs, _, pt, target = _plans(kind)
    r, c = next((r, c) for n, r, c, _ in reqs if n == target)
    tiles = pt.tiles_for(target)
    kt = tmap.pack_tiles(tiles, to_torch(np.ones((r, c), np.float32)),
                         schedule=tmap.schedule_tiles(tiles))
    if kt.n_passes > 1:
        assert kt.col_start is None
        return
    starts = to_numpy(kt.col_start).tolist()
    assert starts[0] == 0 and starts[-1] == kt.n_tiles
    expand = [j for j in range(len(starts) - 1)
              for _ in range(starts[j + 1] - starts[j])]
    assert tuple(expand) == kt.col_block
    assert kt.n_ranks == max(np.diff(starts))


def test_tile_blocks_equal_per_tile_slices():
    """The batched gather equals the reference's zero-padded per-tile
    slices, ragged edge included."""
    rng = np.random.default_rng(0)
    m = rng.normal(size=(300, 500)).astype(np.float32)
    tiles = tmap.plan_layers([tmap.MatrixReq("m", 300, 500)]).tiles_for("m")
    blk, cmask = tmap.tile_blocks(tiles, to_torch(m), 128, 256)
    for i, t in enumerate(tiles):
        want = np.zeros((128, 256), np.float32)
        want[:t.rows, :t.cols] = m[t.row0:t.row0 + t.rows,
                                   t.col0:t.col0 + t.cols]
        np.testing.assert_array_equal(to_numpy(blk[i]), want)
        assert to_numpy(cmask[i]).sum() == t.cols


def test_ir_drop_max_cols_match():
    for alpha in (0.0, 1e-6, 1e-5):
        cj = jtypes.CIMConfig(nonideal=jtypes.NonIdealityConfig(
            ir_drop_alpha=alpha))
        ct = ttypes.CIMConfig(nonideal=ttypes.NonIdealityConfig(
            ir_drop_alpha=alpha))
        assert tmap.ir_drop_max_cols(ct) == jmap.ir_drop_max_cols(cj)


def test_planner_rejects_over_budget():
    reqs = [tmap.MatrixReq("m", 3584, 14336)]
    with pytest.raises(ValueError, match="cores"):
        tmap.plan_layers(reqs, ttypes.CoreSpec())


def test_full_width_gemma_layer_is_single_pass():
    """One full-width gemma2-9b layer on a 6144-core chip: 6048 tiles of
    128x256, one per core, no merge — a single-pass plan (the plan only;
    no tensors are made)."""
    shapes = {"wq": (3584, 4096), "wk": (3584, 2048), "wv": (3584, 2048),
              "wo": (4096, 3584), "w_g": (3584, 14336),
              "w_i": (3584, 14336), "w_o": (14336, 3584)}
    plan = tmap.plan_layers([tmap.MatrixReq(n, *s) for n, s in shapes.items()],
                            ttypes.CoreSpec(n_cores=6144))
    assert len(plan.tiles) == 6048 and not plan.merged
    assert {(t.rows, t.cols) for t in plan.tiles} == {(128, 256)}
    for n in shapes:
        assert tmap.schedule_tiles(plan.tiles_for(n)).n_passes == 1


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_transposed_pack_equal(kind, fold):
    """The transpose view of each forward pack: index maps (tile_slot, the
    fused run layout and the swapped block maps) exactly equal, per-row
    tensors to f32 rounding, and the forward gd_tiles shared by identity,
    not copied."""
    reqs, pj, pt, target = _plans(kind)
    r, c = next((r, c) for n, r, c, _ in reqs if n == target)
    rng = np.random.default_rng(len(kind) + 7)
    gp = rng.uniform(1, 40, (r, c)).astype(np.float32)
    gn = rng.uniform(1, 40, (r, c)).astype(np.float32)
    tj, tt = pj.tiles_for(target), pt.tiles_for(target)
    vd = rng.uniform(0.001, 0.01, len(tj)).astype(np.float32)
    sj, st = jmap.schedule_tiles(tj), tmap.schedule_tiles(tt)
    fj = jmap.pack_tiles(tj, jnp.asarray(gp - gn), schedule=sj)
    ft = tmap.pack_tiles(tt, to_torch(gp - gn), schedule=st)
    kj = jmap.pack_tiles_transposed(tj, fj, gsum=jnp.asarray(gp + gn),
                                    v_decr=jnp.asarray(vd), fold_norm=fold,
                                    schedule=sj)
    kt = tmap.pack_tiles_transposed(tt, ft, gsum=to_torch(gp + gn),
                                    v_decr=to_torch(vd), fold_norm=fold,
                                    schedule=st)
    for f in INDEX_MAPS:
        assert getattr(kt, f) == getattr(kj, f), f
    assert kt.gd_tiles is ft.gd_tiles
    assert kt.col_start is None
    assert to_numpy(kt.tile_index).tolist() == list(kj.tile_slot)
    np.testing.assert_array_equal(to_numpy(kt.v_decr_tiles),
                                  np.asarray(kj.v_decr_tiles))
    for f in ("inv_norm_tiles", "denorm_tiles"):
        np.testing.assert_allclose(to_numpy(getattr(kt, f)),
                                   np.asarray(getattr(kj, f)),
                                   rtol=F32_RTOL, err_msg=f)


def test_transpose_tiles_equal():
    _, pj, pt, target = _plans("split")
    want = [tuple(getattr(t, f) for f in TILE_FIELDS)
            for t in jmap.transpose_tiles(pj.tiles_for(target))]
    got = [tuple(getattr(t, f) for f in TILE_FIELDS)
           for t in tmap.transpose_tiles(pt.tiles_for(target))]
    assert got == want


@pytest.mark.parametrize("n_units,n_cores", [(795, 7), (140, 2), (10, 3)])
def test_interleave_assignment_equal(n_units, n_cores):
    np.testing.assert_array_equal(
        to_numpy(tmap.interleave_assignment(n_units, n_cores)),
        np.asarray(jmap.interleave_assignment(n_units, n_cores)))


@pytest.mark.parametrize("kind", KINDS)
def test_run_tables_match_fused_layout(kind):
    """The scheduled and transposed kernels' run tables, forward and
    transposed: run_start holds each run's slots (out_slot), col_runs each
    column block's live runs in run order (out_col, idle runs left out)."""
    reqs, _, pt, target = _plans(kind)
    r, c = next((r, c) for n, r, c, _ in reqs if n == target)
    tiles = pt.tiles_for(target)
    sched = tmap.schedule_tiles(tiles)
    fwd = tmap.pack_tiles(tiles, to_torch(np.ones((r, c), np.float32)),
                          schedule=sched)
    bwd = tmap.pack_tiles_transposed(tiles, fwd, schedule=sched)
    for p in (fwd, bwd):
        run_start = to_numpy(p.run_start).tolist()
        assert [r for r in range(len(p.out_col))
                for _ in range(run_start[r + 1] - run_start[r])] \
            == list(p.out_slot)
        crs = to_numpy(p.col_run_start).tolist()
        runs = to_numpy(p.col_runs).tolist()
        for j in range(p.n_col_blocks):
            assert runs[crs[j]:crs[j + 1]] == \
                [r for r, b in enumerate(p.out_col) if b == j]
        assert crs[-1] == sum(1 for b in p.out_col if b >= 0)
