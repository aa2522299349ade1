"""Port parity, the CIM MVM kernels: the port's plain executors against
the reference's `cim_mvm_packed` (its Pallas kernels in interpret mode, as
the reference's own tests run them, batch block pinned to 256) on the same
packed plans and inputs, for every activation mode — single-pass plans
(the packed kernel), merged-core and hand-scheduled plans whose column
blocks split across runs (the scheduled kernel) and their transpose views
(the transposed kernel); and, where a CUDA device is present, each CUDA
kernel against its plain executor.

Rule (ROADMAP north star): accumulated ADC counts agree exactly except
at outputs where a contributing tile's reference |q|/v_decr lies within
f32 rounding of a .5 boundary, and stochastic bits except where q plus
the noise lies within rounding of 0 (both sets computed by
`boundary_hits`); the raw-charge (identity) mode agrees to f32 rounding of
the sums.

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

ACTS = ("none", "relu", "tanh", "sigmoid", "identity", "stochastic")
R, C, M = 300, 500, 24          # the ragged split layer: 3 x 2 tiles
SEED = 77                       # the stochastic neuron's salt


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
                jnp.asarray(x), pj, JCfg(activation=act), seed=SEED, bm=256,
                interpret=True))
    return {"x": x, "packs": packs, "outs": outs}


@pytest.mark.parametrize("activation", ACTS)
def test_plain_matches_reference_counts(case, activation):
    """Raw-count packs (denorm = valid-column mask): integer sums."""
    pt = packed_to_torch(case["packs"][False])
    got = to_numpy(ops.cim_mvm_packed(to_torch(case["x"]), pt,
                                      CIMConfig(activation=activation),
                                      seed=SEED))
    want = case["outs"][False, activation]
    _assert_route_match(got, want, case["x"], pt, activation)


def _assert_route_match(got, want, x, pt, activation):
    if activation == "identity":
        # f32 sums of <= 256 products in another order: relative 2^-17
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=2e-5 * np.abs(want).max())
        return
    assert_counts_match(got, want, boundary_hits(x, pt, 0.5, activation,
                                                 SEED))


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
    """A CPU tensor takes the plain version of every route; the launch
    counts are for the kernels only."""
    from repro_torch.core.mapping import (pack_tiles_transposed,
                                          schedule_tiles)
    before = dict(K.LAUNCHES)
    tiles = plan_layers([MatrixReq("m", 40, 30)]).tiles_for("m")
    p = pack_tiles(tiles, torch.ones(40, 30))
    y = ops.packed_call(torch.ones(2, 40), p, activation="identity",
                        n_max=1, v_read=1.0)
    assert torch.equal(y, torch.full((2, 30), 40.0))
    y = ops.packed_call(torch.ones(2, 40), p, activation="identity",
                        n_max=1, v_read=1.0, scheduled=True)
    assert torch.equal(y, torch.full((2, 30), 40.0))
    pb = pack_tiles_transposed(tiles, p, schedule=schedule_tiles(tiles))
    y = ops.packed_call(torch.ones(2, 30), pb, activation="identity",
                        n_max=1, v_read=1.0)
    assert torch.equal(y, torch.full((2, 40), 30.0))
    assert K.LAUNCHES == before


def test_unported_plans_and_modes_raise():
    """Routing refuses what the reference refuses (a multi-pass plan on
    the tile-grid kernel), an input of the wrong width and an unknown
    activation."""
    from repro_torch.core.mapping import schedule_tiles
    tiles = plan_layers([MatrixReq("m", 200, 70)]).tiles_for("m")
    single = pack_tiles(tiles, torch.ones(200, 70))
    for i, t in enumerate(tiles):          # two tiles time-share one core
        t.seq_slot = i
    multi = pack_tiles(tiles, torch.ones(200, 70),
                       schedule=schedule_tiles(tiles))
    assert multi.n_passes == 2
    assert multi.route() == "cim_mvm_scheduled"
    assert single.route(scheduled=True) == "cim_mvm_scheduled"
    with pytest.raises(ValueError, match="passes"):
        ops.packed_call(torch.ones(2, 200), multi, activation="none",
                        n_max=127, v_read=0.5, scheduled=False)
    with pytest.raises(ValueError, match="features"):
        ops.packed_call(torch.ones(2, 199), single, activation="none",
                        n_max=127, v_read=0.5)
    with pytest.raises(ValueError, match="activation"):
        ops.packed_call(torch.ones(2, 200), single, activation="softmax",
                        n_max=127, v_read=0.5)


# ------------------------------------------- scheduled and transposed runs

RUN_PLANS = ("split-runs", "merged")


@pytest.fixture(scope="module")
def runs_case():
    """Two multi-pass plans of the ragged 300x500 layer, each packed by
    the reference forward and transposed, with raw-count and folded
    denorms, and the reference's outputs: every activation on the raw
    packs, 'none' on the folded ones, and stochastic bits at M = 300 (two
    hash batch blocks).

      split-runs: seq slots set by hand, 4 passes: column blocks split
                  over several runs, idle slots, a run across a pass.
      merged:     the planner merging onto 4 cores (3 passes)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import mapping as jm
    from repro.core.conductance import weights_to_conductances
    from repro.core.types import CIMConfig as JCfg, CoreSpec as JSpec
    from repro.kernels.cim_mvm.ops import cim_mvm_packed

    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.1, (R, C)).astype(np.float32)
    cond = weights_to_conductances(jnp.asarray(w), JCfg().device)
    gd, gs = cond.g_pos - cond.g_neg, cond.g_pos + cond.g_neg
    xs = {"fwd": rng.integers(-7, 8, (M, R)).astype(np.float32),
          "bwd": rng.integers(-7, 8, (M, C)).astype(np.float32)}
    x300 = {"fwd": rng.integers(-7, 8, (300, R)).astype(np.float32),
            "bwd": rng.integers(-7, 8, (300, C)).astype(np.float32)}
    packs, outs = {}, {}
    for kind in RUN_PLANS:
        if kind == "split-runs":
            tiles = jm.plan_layers([jm.MatrixReq("m", R, C)]).tiles_for("m")
            for i, t in enumerate(tiles):
                t.seq_slot = i % 4 if i < 4 else i % 3
        else:
            tiles = jm.plan_layers([jm.MatrixReq("m", R, C),
                                    jm.MatrixReq("s", 100, 60)],
                                   JSpec(n_cores=4)).tiles_for("m")
        sched = jm.schedule_tiles(tiles)
        vd = jnp.asarray(rng.uniform(0.02, 0.05, len(tiles)), jnp.float32)
        for fold in (False, True):
            pf = jm.pack_tiles(tiles, gd, gsum=gs, v_decr=vd, fold_norm=fold,
                               schedule=sched)
            pb = jm.pack_tiles_transposed(tiles, pf, gsum=gs, v_decr=vd,
                                          fold_norm=fold, schedule=sched)
            assert pf.n_passes > 1
            packs[kind, "fwd", fold], packs[kind, "bwd", fold] = pf, pb
            for d, p in (("fwd", pf), ("bwd", pb)):
                for act in (ACTS if not fold else ("none",)):
                    outs[kind, d, fold, act] = np.asarray(cim_mvm_packed(
                        jnp.asarray(xs[d]), p, JCfg(activation=act),
                        seed=SEED, bm=256, interpret=True))
                if not fold:
                    outs[kind, d, "m300"] = np.asarray(cim_mvm_packed(
                        jnp.asarray(x300[d]), p,
                        JCfg(activation="stochastic"), seed=SEED, bm=256,
                        interpret=True))
    return {"x": xs, "x300": x300, "packs": packs, "outs": outs}


def _run_plain(runs_case, kind, direction, fold, activation, x=None):
    pt = packed_to_torch(runs_case["packs"][kind, direction, fold])
    x = runs_case["x"][direction] if x is None else x
    got = to_numpy(ops.cim_mvm_packed(to_torch(x), pt,
                                      CIMConfig(activation=activation),
                                      seed=SEED))
    return got, pt


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("kind", RUN_PLANS)
def test_scheduled_plain_matches_reference(runs_case, kind, activation):
    """The scheduled executor (per-run partials folded in run order) on
    raw-count packs: the counts rule."""
    got, pt = _run_plain(runs_case, kind, "fwd", False, activation)
    assert pt.route() == "cim_mvm_scheduled"
    _assert_route_match(got, runs_case["outs"][kind, "fwd", False,
                                               activation],
                        runs_case["x"]["fwd"], pt, activation)


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("kind", RUN_PLANS)
def test_transposed_plain_matches_reference(runs_case, kind, activation):
    """The transposed executor (shared forward stack through tile_slot,
    per-row normalizers, hash keyed on the stack position): the counts
    rule."""
    got, pt = _run_plain(runs_case, kind, "bwd", False, activation)
    assert pt.route() == "cim_mvm_transposed"
    _assert_route_match(got, runs_case["outs"][kind, "bwd", False,
                                               activation],
                        runs_case["x"]["bwd"], pt, activation)


@pytest.mark.parametrize("m", (1, 4, 17, 300))
@pytest.mark.parametrize("kind", RUN_PLANS)
def test_transposed_launches_the_walk_on_reference_plans(runs_case, kind, m,
                                                         monkeypatch):
    """The transposed wrapper, given a CUDA-side (here meta) x, launches
    the walk at every M, decode included, on the reference's bwd plan read
    on its stored column axis: in width the stored columns, out width the
    stored rows, one output block per forward row block. That geometry
    covers every output once and the verifier passes the plan."""
    from repro_torch.core import verify as tverify
    pt = packed_to_torch(runs_case["packs"][kind, "bwd", False])
    calls = []
    monkeypatch.setattr(K, "launch_walk", lambda *a, **kw: calls.append(a)
                        or torch.empty((m, a[5] * a[7]), device="meta"))
    monkeypatch.setattr(K, "launch_split", None)
    out = ops.packed_call(torch.empty((m, pt.n_rows), device="meta"), pt,
                          activation="none", n_max=127, v_read=0.5)
    assert tuple(out.shape) == (m, pt.n_cols) and len(calls) == 1
    kernel, n_cb, in_w, out_w = calls[0][0], *calls[0][5:8]
    _, bk_f, bn_f = pt.gd_tiles.shape
    assert kernel == "cim_mvm_transposed"
    assert (n_cb, in_w, out_w) == (pt.n_col_blocks, bn_f, bk_f)
    g = K.walk_geometry(m, in_w, out_w, n_cb, trans=True)
    assert g.trans == 1 and g.n_items == g.n_rbk * g.n_strips * n_cb
    assert (g.n_rbk - 1) * g.bm < m <= g.n_rbk * g.bm
    assert (g.n_strips - 1) * g.bn_blk < out_w <= g.n_strips * g.bn_blk
    assert K.walk_shared_bytes(g) <= K.SMEM_LIMIT
    tverify.check_packed(pt, bm=m)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("kind", RUN_PLANS)
def test_runs_folded_match_reference(runs_case, kind, direction):
    """Serving packs (fold_norm): a flipped count moves an output by its
    tile's denorm; the rest agrees to f32 rounding of each run's sum and
    of the fold (the reference may contract a multiply-add): two
    executions, each at most n_terms adds of running sums below n_terms *
    n_max * max(denorm), half an ulp each."""
    got, pt = _run_plain(runs_case, kind, direction, True, "none")
    want = runs_case["outs"][kind, direction, True, "none"]
    hits = boundary_hits(runs_case["x"][direction], pt, 0.5)
    den_max = float(pt.denorm_tiles.max())
    n_terms = pt.n_run_ranks * pt.n_run_len + pt.n_run_ranks
    n_max = CIMConfig().out_mag_levels
    tol = hits * den_max + 2 * n_terms * 2.0 ** -24 * n_terms * n_max \
        * den_max
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_stochastic_hash_rows_past_one_batch_block(runs_case, direction):
    """At M = 300 the reference runs two batch blocks of 256 rows: the
    hash's row and row-block salts follow them (the merged plan)."""
    x = runs_case["x300"][direction]
    got, pt = _run_plain(runs_case, "merged", direction, False,
                         "stochastic", x=x)
    assert_counts_match(got, runs_case["outs"]["merged", direction, "m300"],
                        boundary_hits(x, pt, 0.5, "stochastic", SEED))


def test_run_walk_of_single_pass_plan_is_the_packed_order(case):
    """Forced onto a single-pass plan, the scheduled executor equals the
    packed one exactly: one run per column block, the same sums."""
    pt = packed_to_torch(case["packs"][True])
    x = to_torch(case["x"])
    for act in ACTS:
        cfg = CIMConfig(activation=act)
        assert torch.equal(ops.cim_mvm_packed(x, pt, cfg, seed=SEED),
                           ops.cim_mvm_packed(x, pt, cfg, seed=SEED,
                                              scheduled=True)), act


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
        before = K.LAUNCHES["cim_mvm_packed"]
        cfg = CIMConfig(activation=activation)
        got = ops.cim_mvm_packed(x, p, cfg, seed=SEED)
        want = ops.cim_mvm_packed(x, p, cfg, seed=SEED, impl="plain")
        torch.cuda.synchronize()
        assert K.LAUNCHES["cim_mvm_packed"] == before + 1
        assert torch.equal(got, want), (r, c, m)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTS)
def test_run_kernels_match_plain_on_card(activation):
    """The scheduled and transposed CUDA kernels against their plain
    versions on merged-core chips compiled with both directions (a ragged
    layer, an IR-drop layer at bn = 47, and M across one and two hash
    batch blocks): equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.core.types import NonIdealityConfig
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for (r, c, cores, alpha, m) in ((300, 500, 4, 0.0, 5),
                                    (1024, 700, 40, 2e-7, 37),
                                    (3584, 2048, 200, 0.0, 300)):
        ccfg = CIMConfig(activation=activation,
                         nonideal=NonIdealityConfig(ir_drop_alpha=alpha))
        w = {"m": torch.randn(r, c, generator=gen, device=dev) / r ** 0.5,
             "s": torch.randn(100, 60, generator=gen, device=dev)}
        chip = tcim.compile_chip(w, ccfg, CoreSpec(n_cores=cores), "ideal",
                                 in_alpha=3.0, directions=("fwd", "bwd"),
                                 generator=gen)
        for d, width in (("fwd", r), ("bwd", c)):
            p = chip.layers_for(d)["m"].packed
            kernel = p.route()
            assert kernel != "cim_mvm_packed", (r, c, d)
            x = torch.randint(-7, 8, (m, width), generator=gen,
                              device=dev).to(torch.float32)
            before = K.LAUNCHES[kernel]
            got = ops.cim_mvm_packed(x, p, ccfg, seed=SEED)
            want = ops.cim_mvm_packed(x, p, ccfg, seed=SEED, impl="plain")
            torch.cuda.synchronize()
            assert K.LAUNCHES[kernel] == before + 1
            assert torch.equal(got, want), (r, c, d, m)


SPLIT_CASES = ((3584, 2048, 4096, 0.0), (300, 500, 4, 0.0),
               (1024, 700, 40, 2e-7), (35, 300, 48, 2e-7),
               (35, 470, 5, 2e-7))


def _plan_call(x, p, den, **kw):
    """p's own kernel (packed or scheduled) with `den` as its weight."""
    tiles = (p.gd_tiles, p.inv_norm_tiles, den, p.v_decr_tiles)
    if p.route() == "cim_mvm_packed":
        return K.cim_mvm_packed(x, *tiles, p.row_index, p.col_start,
                                n_row_blocks=p.n_row_blocks,
                                n_ranks=p.n_ranks, **kw)
    return K.cim_mvm_scheduled(x, *tiles, p.row_index, p.run_start,
                               p.col_run_start, p.col_runs, p.live_slots,
                               n_run_ranks=p.n_run_ranks,
                               n_run_len=p.n_run_len, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTS)
def test_split_route_matches_plain_on_card(activation):
    """The packed and scheduled kernels at decode batches (M = 1, 4, 16:
    the split route) and one row past it (M = 17: the walk) against their
    plain versions, with the plan's denorm and with the valid-column mask:
    a full-width single-pass wk, the ragged layer merged onto 4 cores
    (idle slots), an IR-drop layer at bn = 47 scheduled, and 35-row
    IR-drop layers whose 6,580-byte tiles are not multiples of 16 bytes
    (single-pass and scheduled). Equal bit for bit, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.core.types import NonIdealityConfig
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)
    for (r, c, cores, alpha) in SPLIT_CASES:
        ccfg = CIMConfig(nonideal=NonIdealityConfig(ir_drop_alpha=alpha))
        w = {"m": torch.randn(r, c, generator=gen, device=dev) / r ** 0.5,
             "s": torch.randn(100, 60, generator=gen, device=dev)}
        p = tcim.compile_chip(w, ccfg, CoreSpec(n_cores=cores), "ideal",
                              in_alpha=3.0,
                              generator=gen).layers["m"].packed
        kernel = p.route()
        mask = (p.inv_norm_tiles > 0).to(torch.float32)
        for m in (1, 4, 16, 17):
            x = torch.randint(-7, 8, (m, r), generator=gen,
                              device=dev).to(torch.float32)
            for den in (p.denorm_tiles, mask):
                kw = dict(activation=activation, seed=SEED)
                before = K.LAUNCHES[kernel]
                got = _plan_call(x, p, den, **kw)
                want = _plan_call(x, p, den, impl="plain", **kw)
                torch.cuda.synchronize()
                assert K.LAUNCHES[kernel] == before + 1
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), (r, c, m)


WALK_CASES = ((300, 500, 4096, 0.0), (3584, 2048, 4096, 0.0),
              (300, 500, 4, 0.0), (1024, 700, 40, 2e-7), (35, 470, 5, 2e-7))


def _walk_call(x, p, den, **kw):
    """p's own kernel (packed or scheduled) through its walk at any M, with
    `den` as the weight."""
    kernel = p.route()
    tables = ((p.row_index, p.col_start) if kernel == "cim_mvm_packed"
              else (p.row_index, p.run_start, p.col_run_start, p.col_runs))
    return K.launch_walk(kernel, x, p.gd_tiles,
                         (p.inv_norm_tiles, den, p.v_decr_tiles), tables,
                         p.n_col_blocks, p.bk, p.bn, n_max=127, v_read=0.5,
                         **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTS)
def test_walk_matches_plain_on_card(activation):
    """The packed and scheduled kernels' walk (csrc/cim_walk.cuh) against
    `cim_runs_plain` at M = 17, 32, 64 and 256, with the plan's denorm and
    with the valid-column mask: a ragged and a full-width single-pass
    plan (packed), the ragged layer merged onto 4 cores (scheduled, idle
    slots), an IR-drop layer at bn = 47 scheduled, and a 35-row IR-drop
    layer whose tiles and x rows sit off the 16-byte grid. Equal bit for
    bit, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.core.types import NonIdealityConfig
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2)
    routes = set()
    for (r, c, cores, alpha) in WALK_CASES:
        ccfg = CIMConfig(nonideal=NonIdealityConfig(ir_drop_alpha=alpha))
        w = {"m": torch.randn(r, c, generator=gen, device=dev) / r ** 0.5,
             "s": torch.randn(100, 60, generator=gen, device=dev)}
        p = tcim.compile_chip(w, ccfg, CoreSpec(n_cores=cores), "ideal",
                              in_alpha=3.0,
                              generator=gen).layers["m"].packed
        kernel = p.route()
        routes.add(kernel)
        mask = (p.inv_norm_tiles > 0).to(torch.float32)
        for m in (17, 32, 64, 256):
            x = torch.randint(-7, 8, (m, r), generator=gen,
                              device=dev).to(torch.float32)
            for den in (p.denorm_tiles, mask):
                kw = dict(activation=activation, seed=SEED)
                before = K.LAUNCHES[kernel]
                got = _walk_call(x, p, den, **kw)
                want = _plan_call(x, p, den, impl="plain", **kw)
                torch.cuda.synchronize()
                assert K.LAUNCHES[kernel] == before + 1
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), (r, c, cores, m)
    assert routes == {"cim_mvm_packed", "cim_mvm_scheduled"}


def _rbm_bwd_plan(n_vis, n_hid, interleave, gen, dev):
    """The h->v plan of a random RBM deployed on the card as the recovery
    deploys it."""
    from repro_torch.models import nn as tnn
    params = {"w": torch.randn(n_vis, n_hid, generator=gen, device=dev) * .3,
              "a": torch.randn(n_vis, generator=gen, device=dev) * 0.1,
              "b": torch.randn(n_hid, generator=gen, device=dev) * 0.1}
    v_cal = (torch.rand(64, n_vis, generator=gen, device=dev) < 0.5).float()
    crbm = tnn.deploy_rbm_cim(params, CIMConfig(in_bits=2), v_cal,
                              interleave=interleave, generator=gen)
    return crbm.chip.layers_for("bwd")["rbm"].packed


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTS)
def test_transposed_walk_matches_plain_on_card(activation):
    """The transposed kernel (the walk at every M) against
    `cim_runs_plain` at M = 1, 4, 16, 17 and 64, with the plan's denorm
    and with the valid-row mask: the RBM at paper geometry (128 x 121
    tiles), the interleaved smoke RBM (70 x 33 tiles, stored rows off the
    16-byte grid) and a full-width w_g's bwd plan on a 3072-core chip (256
    stored columns). Equal bit for bit, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(3)
    w = {n: torch.randn(r, c, generator=gen, device=dev) / r ** 0.5
         for n, (r, c) in (("w_g", (3584, 14336)), ("wq", (3584, 4096)))}
    chip = tcim.compile_chip(w, CIMConfig(), CoreSpec(n_cores=3072), "ideal",
                             in_alpha=3.0, directions=("fwd", "bwd"),
                             generator=gen)
    plans = (_rbm_bwd_plan(794, 120, False, gen, dev),
             _rbm_bwd_plan(138, 32, True, gen, dev),
             chip.layers_for("bwd")["w_g"].packed)
    assert [tuple(p.gd_tiles.shape[1:]) for p in plans] == \
        [(128, 121), (70, 33), (128, 256)]
    for p in plans:
        mask = (p.inv_norm_tiles > 0).to(torch.float32)
        for m in (1, 4, 16, 17, 64):
            x = torch.randint(-7, 8, (m, p.n_rows), generator=gen,
                              device=dev).to(torch.float32)
            for den in (p.denorm_tiles, mask):
                kw = dict(activation=activation, n_max=127, v_read=0.5,
                          seed=SEED)
                tiles = (p.gd_tiles, p.inv_norm_tiles, den, p.v_decr_tiles)
                tables = (p.row_index, p.tile_index, p.run_start,
                          p.col_run_start, p.col_runs)
                runs = dict(n_run_ranks=p.n_run_ranks, n_run_len=p.n_run_len)
                before = K.LAUNCHES["cim_mvm_transposed"]
                got = K.cim_mvm_transposed(x, *tiles, *tables, **runs, **kw)
                want = K.cim_mvm_transposed(x, *tiles, *tables, impl="plain",
                                            **runs, **kw)
                torch.cuda.synchronize()
                assert K.LAUNCHES["cim_mvm_transposed"] == before + 1
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), (p.bk, p.bn, m)


# ------------------------------------------------------------- hash PRNG

HASH_CASES = [((4, 7), (0,)), ((256, 128), (12345, 3, 77)),
              ((5, 300), (-7, 0, 2 ** 31 - 1)), ((3, 2, 9), (1, 2)),
              ((1, 47), ())]


@pytest.mark.parametrize("shape,salts", HASH_CASES)
def test_hash_prng_matches_reference(shape, salts):
    """hash_bits and hash_uniform equal the reference's bit for bit
    (uint32 wraparound written in masked int64); hash_normal to a few
    ulps: its log, sqrt and cos are other libraries' f32 approximations
    of the same functions."""
    jp = pytest.importorskip("repro.kernels.prng")
    from repro_torch.kernels import prng as tp
    np.testing.assert_array_equal(
        to_numpy(tp.hash_bits(shape, *salts)),
        np.asarray(jp.hash_bits(shape, *salts)).astype(np.int64))
    np.testing.assert_array_equal(to_numpy(tp.hash_uniform(shape, *salts)),
                                  np.asarray(jp.hash_uniform(shape, *salts)))
    np.testing.assert_allclose(to_numpy(tp.hash_normal(shape, *salts)),
                               np.asarray(jp.hash_normal(shape, *salts)),
                               rtol=1e-6, atol=1e-6)
