"""The split route of the packed and scheduled CIM kernels (decode, M <= 16
rows): its two kernels' plain versions, `cim_terms_plain` (every live
tile's counts * weight) and `cim_fold_plain` (each output's terms summed
in slot order inside a run and folded in run order), composed as the
wrappers launch them, against `cim_runs_plain` (the walk's plain version)
and against the reference's Pallas kernels; each wrapper's route (the
transposed kernel takes the walk at every M), the walk's geometry
(forward and transposed), the plan's live-slot table and the verifier's
route invariants.

Rules: the composition equals `cim_runs_plain` bit for bit (int32 views,
so the sign of zero counts): the same exact FP64 tile dots rounded once,
the same f32 operations in the same order. Against the reference the
counts rule of `_torch_parity` holds (equal except where a tile's |q| /
v_decr lies within rounding of a .5 boundary). The CUDA kernels are held
against these plain versions on the card (`tests/test_torch_cim_mvm.py`,
`chip_smoke.py`).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (assert_counts_match, boundary_hits,
                           packed_to_torch, to_numpy, to_torch)

from repro_torch.core import cim as tcim
from repro_torch.core import verify as tverify
from repro_torch.core.mapping import MatrixReq, pack_tiles, plan_layers
from repro_torch.core.types import CIMConfig, CoreSpec, NonIdealityConfig
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.kernels.cim_mvm import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import nn as tnn

ACTS = ("none", "relu", "tanh", "sigmoid", "identity", "stochastic")
ROWS = (1, 4, 5, 16)            # decode batches of the split route
SEED = 91                       # the stochastic neuron's salt
PLAN_SETS = ("single-pass", "merged-core", "ir-drop")


def _smoke_plans(**chip):
    """Layer 0's seven projection plans of the gemma2-9b SMOKE model as
    `serve_static` deploys them on `chip`."""
    res = tserve.serve_static("gemma2-9b", smoke=True, cim=True,
                              device="cpu", batch=1, prompt_len=2, gen=1,
                              **chip)
    layers = res.params["layers"]
    return {k[:-4]: v[0].packed for k, v in sorted(layers.items())
            if k.endswith("_cim")}


def _layer_plan(r, c, cores, alpha, seed, direction="fwd"):
    """One r x c layer (and a 100 x 60 neighbour that shares its cores)
    compiled on a `cores`-core chip at IR-drop alpha; its plan in
    `direction` (bwd: the transposed kernel's)."""
    gen = torch.Generator().manual_seed(seed)
    w = {"m": torch.randn(r, c, generator=gen) / r ** 0.5,
         "s": torch.randn(100, 60, generator=gen)}
    cfg = CIMConfig(nonideal=NonIdealityConfig(ir_drop_alpha=alpha))
    chip = tcim.compile_chip(w, cfg, CoreSpec(n_cores=cores), "ideal",
                             in_alpha=3.0, directions=("fwd", direction),
                             generator=gen)
    return chip.layers_for(direction)["m"].packed


@pytest.fixture(scope="module")
def plans():
    """The three plan sets: the SMOKE model's default chip (single-pass,
    the packed kernel), its 4-core chip (a two-pass scheduled w_o) with a
    300 x 500 layer merged onto 4 cores (idle slots, column blocks split
    over runs), and its IR-drop chip (47-column tiles) with a 1024 x 700
    layer scheduled on 40 IR-drop cores."""
    return {
        "single-pass": _smoke_plans(),
        "merged-core": {**_smoke_plans(cim_cores=4),
                        "m300x500": _layer_plan(300, 500, 4, 0.0, 1)},
        "ir-drop": {**_smoke_plans(cim_ir_drop=2e-7),
                    "m1024x700": _layer_plan(1024, 700, 40, 2e-7, 2)}}


def _route_tables(p):
    """The run tables, live-slot table and loop bounds the wrapper of
    p's route hands the split launch: the packed kernel's one run per
    column block (col_start, an arange, every slot live), the scheduled
    kernel's plan tables."""
    if p.route() == "cim_mvm_packed":
        ar = torch.arange(p.n_col_blocks + 1, dtype=torch.int32)
        return (p.col_start, ar, ar[:-1]), None, 1, p.n_ranks
    return ((p.run_start, p.col_run_start, p.col_runs), p.live_slots,
            p.n_run_ranks, p.n_run_len)


def split_plain(x, p, den, **kw):
    """The split route's plain composition: terms, then the fold."""
    tables, live, ranks, run_len = _route_tables(p)
    terms = K.cim_terms_plain(x, p.gd_tiles, p.inv_norm_tiles, den,
                              p.v_decr_tiles, p.row_index, live, **kw)
    return K.cim_fold_plain(terms, *tables, n_run_ranks=ranks,
                            n_run_len=run_len)


def walk_plain(x, p, den, **kw):
    """The wrapper's own plain version (a CPU tensor) of p's route."""
    tiles = (p.gd_tiles, p.inv_norm_tiles, den, p.v_decr_tiles)
    if p.route() == "cim_mvm_packed":
        return K.cim_mvm_packed(x, *tiles, p.row_index, p.col_start,
                                n_row_blocks=p.n_row_blocks,
                                n_ranks=p.n_ranks, **kw)
    return K.cim_mvm_scheduled(x, *tiles, p.row_index, p.run_start,
                               p.col_run_start, p.col_runs, p.live_slots,
                               n_run_ranks=p.n_run_ranks,
                               n_run_len=p.n_run_len, **kw)


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("plan_set", PLAN_SETS)
def test_split_composition_equals_walk_bitwise(plans, plan_set, activation):
    """terms then fold equal cim_runs_plain bit for bit on every plan of
    the set, with the plan's denorm and with the valid-column mask as the
    accumulation weight, at every decode batch of the split route."""
    rng = np.random.default_rng(3)
    routes = set()
    for name, p in plans[plan_set].items():
        routes.add(p.route())
        mask = (p.inv_norm_tiles > 0).to(torch.float32)
        for den in (p.denorm_tiles, mask):
            for m in ROWS:
                x = torch.from_numpy(rng.integers(
                    -7, 8, (m, p.n_rows)).astype(np.float32))
                kw = dict(activation=activation, n_max=127, v_read=0.5,
                          seed=SEED)
                got = split_plain(x, p, den, **kw)
                want = walk_plain(x, p, den, **kw)
                assert got.shape == want.shape
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), (name, m)
    assert "cim_mvm_scheduled" in routes or plan_set == "single-pass"
    if plan_set == "ir-drop":
        assert {p.bn for p in plans[plan_set].values()} == {47}


# ----------------------------------------------- against the reference

R, C, M = 300, 500, 4


@pytest.fixture(scope="module")
def reference():
    """The 300 x 500 layer packed by the reference single-pass and merged
    onto 4 cores (scheduled), raw counts, and ONE reference run of each
    (Pallas interpret mode, batch block 256) at M = 4."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import mapping as jm
    from repro.core.conductance import weights_to_conductances
    from repro.core.types import CIMConfig as JCfg, CoreSpec as JSpec
    from repro.kernels.cim_mvm.ops import cim_mvm_packed

    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.1, (R, C)).astype(np.float32)
    x = rng.integers(-7, 8, (M, R)).astype(np.float32)
    cond = weights_to_conductances(jnp.asarray(w), JCfg().device)
    gd, gs = cond.g_pos - cond.g_neg, cond.g_pos + cond.g_neg
    packs, outs = {}, {}
    for kind, spec in (("packed", JSpec()), ("scheduled", JSpec(n_cores=4))):
        tiles = jm.plan_layers([jm.MatrixReq("m", R, C),
                                jm.MatrixReq("s", 100, 60)],
                               spec).tiles_for("m")
        sched = jm.schedule_tiles(tiles) if kind == "scheduled" else None
        vd = jnp.asarray(rng.uniform(0.02, 0.05, len(tiles)), jnp.float32)
        pj = jm.pack_tiles(tiles, gd, gsum=gs, v_decr=vd, fold_norm=False,
                           schedule=sched)
        packs[kind] = pj
        outs[kind] = np.asarray(cim_mvm_packed(
            jnp.asarray(x), pj, JCfg(), seed=SEED, bm=256, interpret=True))
    return {"x": x, "packs": packs, "outs": outs}


@pytest.mark.parametrize("kind", ("packed", "scheduled"))
def test_split_composition_matches_reference(reference, kind):
    """The composition on the reference's own plan against the
    reference's packed / scheduled kernel: the counts rule."""
    pt = packed_to_torch(reference["packs"][kind])
    assert pt.route() == f"cim_mvm_{kind}"
    got = to_numpy(split_plain(to_torch(reference["x"]), pt,
                               pt.denorm_tiles, activation="none",
                               n_max=CIMConfig().out_mag_levels,
                               v_read=CIMConfig().v_read,
                               seed=SEED))[:, :pt.n_cols]
    assert_counts_match(got, reference["outs"][kind],
                        boundary_hits(reference["x"], pt, 0.5))


# ------------------------------------------------- the transposed kernel

def _rbm_plan(n_vis, n_hid, interleave, seed):
    """The transposed (h->v) plan of a random RBM deployed as the recovery
    does: the augmented (n_vis + 1, n_hid + 1) array, pixel-interleaved or
    not."""
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(n_vis, n_hid, generator=gen) * 0.3,
              "a": torch.randn(n_vis, generator=gen) * 0.1,
              "b": torch.randn(n_hid, generator=gen) * 0.1}
    v_cal = (torch.rand(64, n_vis, generator=gen) < 0.5).to(torch.float32)
    crbm = tnn.deploy_rbm_cim(params, CIMConfig(in_bits=2), v_cal,
                              interleave=interleave, generator=gen)
    return crbm.chip.layers_for("bwd")["rbm"].packed


TRANS_PLANS = ("rbm", "rbm interleaved", "m300x500 merged",
               "m1024x700 ir-drop")


@pytest.fixture(scope="module")
def trans_plans():
    """Transposed plans: the RBM at paper geometry (795 x 121, 7 tiles of
    128 x 121), the smoke RBM pixel-interleaved (70 x 33 tiles: stored
    rows off the 16-byte grid), the ragged layer merged onto 4 cores
    (multi-pass, idle slots, output blocks split over runs) and an
    IR-drop layer (47-column tiles)."""
    return {"rbm": _rbm_plan(794, 120, False, 5),
            "rbm interleaved": _rbm_plan(138, 32, True, 6),
            "m300x500 merged": _layer_plan(300, 500, 4, 0.0, 7, "bwd"),
            "m1024x700 ir-drop": _layer_plan(1024, 700, 40, 2e-7, 8, "bwd")}


@pytest.mark.parametrize("name", TRANS_PLANS)
def test_transposed_plans_take_the_walk(trans_plans, name):
    """Every transposed plan (stored tiles of 128 x 121, 70 x 33, a
    multi-pass merge and 47-column IR-drop tiles) takes the walk at every
    batch: its geometry over the stored tile's column axis covers every
    output exactly once and fits a Hopper block, and the verifier passes
    it at decode and prefill batches."""
    p = trans_plans[name]
    assert p.route() == "cim_mvm_transposed" and p.transpose
    for m in (1, 4, 16, 17, 64, 256):
        g = K.walk_geometry(m, p.bk, p.bn, p.n_col_blocks, trans=True)
        assert (_walk_cover(g, m, p.bn, p.n_col_blocks) == 1).all()
        assert K.walk_shared_bytes(g) <= K.SMEM_LIMIT
        tverify.check_packed(p, bm=m)
    shape = tuple(p.gd_tiles.shape[1:])
    assert shape == {"rbm": (128, 121), "rbm interleaved": (70, 33),
                     "m300x500 merged": (128, 256),
                     "m1024x700 ir-drop": (128, 47)}[name]
    if name == "m300x500 merged":
        assert p.n_passes > 1 and len(p.live_slots) < p.n_tiles


# ------------------------------------------------ route, tables, verifier

@pytest.mark.parametrize("kernel", K.SPLIT_KERNELS + ("cim_mvm_transposed",))
def test_every_wrapper_picks_its_route(monkeypatch, kernel):
    """Each wrapper with a CUDA-side tensor (here a meta one, the launch
    functions replaced by recorders) takes one launch function per call:
    the packed and scheduled kernels the split route up to 16 rows and
    the walk above, the transposed kernel the walk at every M."""
    calls = []
    monkeypatch.setattr(K, "launch_split", lambda k, x, *a, **kw:
                        calls.append(("split", k)) or x)
    monkeypatch.setattr(K, "launch_walk", lambda k, x, *a, **kw:
                        calls.append(("walk", k)) or x)
    if kernel == "cim_mvm_transposed":
        p = _layer_plan(300, 500, 4, 0.0, 9, "bwd")
    else:
        p = pack_tiles(plan_layers([MatrixReq("m", 300, 500)])
                       .tiles_for("m"), torch.ones(300, 500))
    rows = (1, 4, 5, 16, 17, 64, 256)
    for m in rows:
        x = torch.empty((m, p.n_rows), device="meta")
        ops.packed_call(x, p, activation="none", n_max=127, v_read=0.5,
                        scheduled=kernel == "cim_mvm_scheduled" or None)
    edge = 16 if kernel in K.SPLIT_KERNELS else 0
    assert calls == [("split" if m <= edge else "walk", kernel)
                     for m in rows]


def test_route_picks_split_up_to_16_rows():
    """M <= 16 takes the split route (4- and 16-row term blocks), M > 16
    the walk; neither launch function takes a CPU tensor."""
    assert K.split_route(16) and not K.split_route(17)
    assert K.split_route(1) and not K.split_route(256)
    assert [K.split_rows(m) for m in (1, 4, 5, 16)] == [4, 4, 16, 16]
    assert K.walk_geometry(17, 128, 256, 8).bm == 32
    p = pack_tiles(plan_layers([MatrixReq("m", 40, 32)]).tiles_for("m"),
                   torch.ones(40, 32))
    x = torch.ones(4, 40)
    tiles = (p.inv_norm_tiles, p.denorm_tiles, p.v_decr_tiles)
    kw = dict(activation="none", n_max=127, v_read=0.5, seed=0)
    with pytest.raises(ValueError, match="device"):
        K.launch_split("cim_mvm_packed", x, p.gd_tiles, tiles, p.row_index,
                       (p.col_start, None, None), None, 1, **kw)
    with pytest.raises(ValueError, match="device"):
        K.launch_walk("cim_mvm_packed", x, p.gd_tiles, tiles,
                      (p.row_index, p.col_start), 1, 40, 32, **kw)


# the projections of one full-width gemma2-9b layer (rows, columns), on
# 128 x 256 tiles
LAYER = {"wq": (3584, 4096), "wk": (3584, 2048), "wo": (4096, 3584),
         "w_g": (3584, 14336), "w_o": (14336, 3584)}
# (m, bk, bn, n_cb): full-width shapes across the route's edge, ragged
# rows, bn = 47 (IR-drop tiles), bk = 35 (a 35-row layer), one column block
WALK_SHAPES = [(m, 128, 256, c // 256) for m in (1, 17, 32, 64, 256)
               for c in (2048, 14336)] + [
    (37, 128, 47, 15), (256, 128, 47, 76), (300, 35, 47, 10),
    (64, 35, 47, 1), (5, 100, 60, 1), (129, 256, 256, 3)]


def _walk_cover(g, m, bn, n_cb):
    """Each output (row, column block, column) the walk's items own, as
    the kernel decodes an item (the row blocks of one strip
    consecutive), counted."""
    owned = np.zeros((m, n_cb, bn), np.int32)
    for item in range(g.n_items):
        rbk, rest = item % g.n_rbk, item // g.n_rbk
        strip, cb = rest % g.n_strips, rest // g.n_strips
        owned[rbk * g.bm:(rbk + 1) * g.bm, cb,
              strip * g.bn_blk:(strip + 1) * g.bn_blk] += 1
    return owned


@pytest.mark.parametrize("shape", WALK_SHAPES,
                         ids=[f"m{m}-bk{bk}-bn{bn}-cb{c}"
                              for m, bk, bn, c in WALK_SHAPES])
def test_walk_geometry_covers_every_output_once(shape):
    """The walk's items cover every output of every column block exactly
    once (ragged rows, bn = 47 and bk = 35 included), each item no
    taller than 32 rows where 32 cover the batch; a stage holds a whole
    number of 16-row blocks of k, at most 64 rows, and one block's
    shared memory fits a Hopper block's 232,448 bytes."""
    m, bk, bn, n_cb = shape
    g = K.walk_geometry(m, bk, bn, n_cb)
    assert (g.bm, g.bn_blk) == K.WALK_ITEMS[g.layout]
    assert g.n_items == g.n_rbk * g.n_strips * n_cb
    assert (g.n_rbk - 1) * g.bm < m <= g.n_rbk * g.bm
    assert (g.n_strips - 1) * g.bn_blk < bn <= g.n_strips * g.bn_blk
    assert (_walk_cover(g, m, bn, n_cb) == 1).all()
    assert m > 32 or g.bm == 32
    assert g.kc % 16 == 0 and 16 <= g.kc <= K.WALK_MAX_CHUNK
    assert g.kc >= min(bk, K.WALK_MAX_CHUNK)
    assert K.walk_shared_bytes(g) <= K.SMEM_LIMIT == 232_448
    # a staged row holds its 16-byte cover at the conflict-free pitches
    assert K.walk_x_pitch(g.kc) >= g.kc + 16      # int8 x
    assert K.walk_x_pitch(g.kc) % 32 == 16
    assert K.walk_g_pitch(g.bn_blk) * 4 >= g.bn_blk * 4 + 16
    assert K.walk_g_pitch(g.bn_blk) % 8 == 4


# (m, bk, bn, n_cb) of transposed walks (bk: the stored columns it
# contracts, bn: the stored rows it outputs): gemma2-9b w_g / w_o bwd on
# 128 x 256 tiles, the RBM (121 columns), the interleaved smoke RBM (33),
# IR-drop tiles (47), a ragged 250-column layer and one column block
TRANS_WALK_SHAPES = [(m, 256, 128, n_cb) for m in (17, 32, 256)
                     for n_cb in (28, 112)] + [
    (64, 121, 128, 7), (64, 33, 70, 2), (37, 47, 128, 8), (300, 250, 70, 3),
    (17, 60, 100, 1)]


@pytest.mark.parametrize("shape", TRANS_WALK_SHAPES,
                         ids=[f"m{m}-bk{bk}-bn{bn}-cb{c}"
                              for m, bk, bn, c in TRANS_WALK_SHAPES])
def test_transposed_walk_geometry_covers_every_output_once(shape):
    """The transposed walk's items cover every output (a stored row of its
    block) exactly once; a stage holds the strip's stored rows over at
    most 128 stored columns, or, where the stored rows are off the
    16-byte grid (no tensor copy), all of them in one chunk (at most 256)
    for one bulk copy; one block's shared memory fits a Hopper block."""
    m, bk, bn, n_cb = shape
    g = K.walk_geometry(m, bk, bn, n_cb, trans=True)
    assert g.trans == 1 and (g.bm, g.bn_blk) == K.WALK_ITEMS[g.layout]
    assert g.n_items == g.n_rbk * g.n_strips * n_cb
    assert (_walk_cover(g, m, bn, n_cb) == 1).all()
    assert m > 32 or g.bm == 32
    assert g.kc % 16 == 0 and g.kc >= min(bk, K.WALK_MAX_CHUNK)
    if bk % 4:
        assert bk <= g.kc <= 2 * K.WALK_MAX_CHUNK       # one chunk
    else:
        assert g.kc <= K.WALK_MAX_CHUNK
    # the stage's stored rows at a pitch of 4 mod 8 words hold a chunk's
    # columns, or a bulk copy's cover of the strip's rows at pitch bk
    pitch = K.walk_g_pitch(g.kc)
    assert pitch % 8 == 4 and pitch >= g.kc + 4
    assert g.bn_blk * pitch * 4 >= g.bn_blk * bk * 4 + 16 or bk > g.kc
    assert K.walk_shared_bytes(g) <= K.SMEM_LIMIT
    forward = K.walk_geometry(m, bk, bn, n_cb)
    assert K.walk_shared_bytes(g) == K.WALK_BARRIER_BYTES + g.stages * (
        g.bm * K.walk_x_pitch(g.kc) + g.bn_blk * pitch * 4)
    assert (forward.layout, forward.n_items) == (g.layout, g.n_items)


@pytest.mark.parametrize("name", sorted(LAYER))
def test_walk_geometry_fills_the_card(name):
    """At prefill (M = 256) every full-width layer shape gives at least
    one item per H100 SM; at M = 17, one row past the split route, more
    blocks than the first walk's grid (32-row blocks x 128-column
    sub-blocks of each column block: 16 for wk)."""
    r, c = LAYER[name]
    n_cb = c // 256
    assert K.walk_geometry(256, 128, 256, n_cb).n_items >= K.H100_SMS
    old = -(-17 // 32) * n_cb * (256 // 128)
    assert K.walk_geometry(17, 128, 256, n_cb).n_items > max(old, 32)


def test_live_slots_skip_idle_slots(plans):
    """The live-slot table lists the slots of live runs in slot order; the
    merged plan has idle slots, and the fold never reads them (NaN terms
    there leave its output unchanged)."""
    p = plans["merged-core"]["m300x500"]
    live = [s for s in range(p.n_tiles) if p.out_col[p.out_slot[s]] >= 0]
    assert p.live_slots.tolist() == live
    assert 0 < len(live) < p.n_tiles
    single = plans["single-pass"]["w_o"]
    assert single.live_slots.tolist() == list(range(single.n_tiles))
    x = torch.from_numpy(np.random.default_rng(4).integers(
        -7, 8, (4, p.n_rows)).astype(np.float32))
    kw = dict(activation="none", n_max=127, v_read=0.5, seed=0)
    terms = K.cim_terms_plain(x, p.gd_tiles, p.inv_norm_tiles,
                              p.denorm_tiles, p.v_decr_tiles, p.row_index,
                              p.live_slots, **kw)
    idle = torch.ones(p.n_tiles, dtype=torch.bool)
    idle[p.live_slots.long()] = False
    poisoned = terms.clone()
    poisoned[idle] = float("nan")
    fold = dict(n_run_ranks=p.n_run_ranks, n_run_len=p.n_run_len)
    tables = (p.run_start, p.col_run_start, p.col_runs)
    assert torch.equal(K.cim_fold_plain(poisoned, *tables, **fold),
                       K.cim_fold_plain(terms, *tables, **fold))
    stale = dataclasses.replace(p)
    stale.live_slots = stale.live_slots[1:]
    with pytest.raises(tverify.ChipVerifyError) as e:
        tverify.check_packed(stale)
    assert e.value.invariant == "run-offsets"


def test_verifier_models_the_transposed_walk(trans_plans, monkeypatch):
    """`shared-memory` checks a transposed plan's walk at the batch (its
    only route: no split route is checked at a decode batch), over the
    stored tile's column axis."""
    p = trans_plans["rbm"]
    assert (p.bk, p.bn) == (121, 128)     # 121 stored columns -> 128 rows
    g = K.walk_geometry(64, p.bk, p.bn, p.n_col_blocks, trans=True)
    assert g.kc == 128                    # one chunk of all 121 columns
    monkeypatch.setattr(tverify, "SMEM_LIMIT", K.walk_shared_bytes(g) - 1)
    with pytest.raises(tverify.ChipVerifyError) as e:
        tverify.check_packed(p, bm=64)
    assert e.value.invariant == "shared-memory" and "walk" in str(e.value)
    # at 4 rows the walk's 32-row items need less: nothing else is checked
    small = K.walk_geometry(4, p.bk, p.bn, p.n_col_blocks, trans=True)
    monkeypatch.setattr(tverify, "SMEM_LIMIT", K.walk_shared_bytes(small))
    tverify.check_packed(p, bm=4)
    # read on the forward axis the same tiles would need other stages
    assert K.walk_shared_bytes(g) != K.walk_shared_bytes(
        K.walk_geometry(64, p.bk, p.bn, p.n_col_blocks))


def test_verifier_models_the_split_route(plans, monkeypatch):
    """`shared-memory` checks the split route's dynamic bytes at a decode
    batch (and beside the walk at a prefill batch); `bulk-copy` refuses
    tile bytes that are not a multiple of 16. Every plan here passes."""
    for plan_set in plans.values():
        for p in plan_set.values():
            for bm in (1, 4, 16, 17, 256):
                tverify.check_packed(p, bm=bm)
    p = plans["single-pass"]["w_g"]
    assert (p.bk, p.bn) == (128, 256)
    assert K.split_shared_bytes(4, 128, 256) == 53424
    assert K.split_shared_bytes(16, 128, 256) == 65712
    assert K.split_shared_bytes(16, 128, 47) == 128 + 3 * (16 * 47 * 4 + 16) \
        + 128 * 16 * 8
    # a limit below the split route's need: its decode batch (16 rows)
    # is checked first, beside the batch's own route
    monkeypatch.setattr(tverify, "SMEM_LIMIT",
                        K.split_shared_bytes(16, p.bk, p.bn) - 1)
    for bm in (4, 256):
        with pytest.raises(tverify.ChipVerifyError) as e:
            tverify.check_packed(p, bm=bm)
        assert e.value.invariant == "shared-memory"
        assert "split route" in str(e.value)
    monkeypatch.undo()
    # tiles whose bytes are not a multiple of 16 (the bulk copy moves the
    # aligned cover of each chunk) pass; a chunk of another length would
    # shift the chunks of one tile against each other
    odd = pack_tiles(plan_layers([MatrixReq("m", 5, 3)]).tiles_for("m"),
                     torch.ones(5, 3))
    assert odd.bk * odd.bn * 4 % 16
    tverify.check_packed(odd)
    monkeypatch.setattr(tverify, "SPLIT_CHUNK_ROWS", 3)
    with pytest.raises(tverify.ChipVerifyError) as e:
        tverify.check_packed(odd)
    assert e.value.invariant == "bulk-copy"
