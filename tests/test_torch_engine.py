"""Port parity, the chip compiler's serving surface (`repro_torch.core`):
`CIMEngine` forward and transposed against `repro.core.CIMEngine`, per-name
PACT clips (`in_alpha` dicts, the 1.0 fallback, the unknown-name error),
`compile_chip(reqs=)`, `multicore_mvm_packed` (the exact tiled matmul with
cfg None, and the CIM datapath) and the per-tile loop `multicore_mvm`.

Inputs are numpy arrays from seeded generators, handed to both packages.
Tolerances: plans and index maps exactly; CIM outputs by the count rule
of tests/test_torch_compile_chip.py (one count per tile whose |q|/v_decr
sits on a .5 boundary, `boundary_hits`); the exact tiled matmul within
MATMUL_RTOL of |x| @ |W| (f32 sums in another order: the reference's f32
dot per tile against the port's FP64 dot rounded once, then the tiles'
f32 sum), and bit for bit on integer x and weights on a 2^-12 grid,
where every tile's dot and the tiles' f32 sum in slot order are exact in
both packages.
"""
import numpy as np
import pytest
import torch

from _torch_parity import boundary_hits, packed_to_torch, to_numpy, to_torch

import repro_torch.core as tcore
from repro_torch.core import cim as tcim
from repro_torch.core import mapping as tmap
from repro_torch.core.quant import quantize_to_int
from repro_torch.core.types import CIMConfig, CoreSpec, NonIdealityConfig
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.models import nn as tnn

SHAPES = {"fc1": (200, 300), "fc2": (128, 64), "fc3": (300, 70)}
ALPHA = {"fc1": 2.0, "fc3": 2.5}           # fc2 takes the 1.0 fallback
ALPHA_BWD = {"fc2": 1.5}                   # fc1, fc3 take 1.0
MATMUL_RTOL = 2.0 ** -24 * 64


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    w = {n: rng.normal(0, 0.1, s).astype(np.float32)
         for n, s in SHAPES.items()}
    x_cal = {n: (2.0 * rng.standard_normal((64, s[0]))).astype(np.float32)
             for n, s in SHAPES.items()}
    x_bwd = {n: (1.5 * rng.standard_normal((64, s[1]))).astype(np.float32)
             for n, s in SHAPES.items()}
    x = {n: rng.normal(0, 1.2, (6, s[0])).astype(np.float32)
         for n, s in SHAPES.items()}
    xb = {n: rng.normal(0, 1.0, (5, s[1])).astype(np.float32)
          for n, s in SHAPES.items()}
    return w, x_cal, x_bwd, x, xb


@pytest.fixture(scope="module")
def engines():
    """One bidirectional chip per package on a merged-core CoreSpec, from
    the same weights, clips and calibration batches; both engines'
    forward and transposed outputs on the same activations."""
    import jax
    import jax.numpy as jnp
    from repro.core import CIMEngine as JEngine
    from repro.core.types import CIMConfig as JCfg, CoreSpec as JSpec
    w, x_cal, x_bwd, x, xb = _inputs()
    kw = dict(in_alpha=ALPHA, directions=("fwd", "bwd"),
              in_alpha_bwd=ALPHA_BWD)
    je = JEngine(JCfg(), JSpec(n_cores=6), mode="ideal")
    je.program(jax.random.PRNGKey(3),
               {n: jnp.asarray(v) for n, v in w.items()},
               x_cal={n: jnp.asarray(v) for n, v in x_cal.items()},
               x_cal_bwd={n: jnp.asarray(v) for n, v in x_bwd.items()}, **kw)
    te = tcore.CIMEngine(CIMConfig(), CoreSpec(n_cores=6), mode="ideal",
                         device="cpu")
    launches = sum(K.LAUNCHES.values())
    te.program(w, x_cal=x_cal, x_cal_bwd=x_bwd, **kw)
    out = {"j": je, "t": te, "x": x, "xb": xb}
    for d, xs in (("fwd", x), ("bwd", xb)):
        out[f"ref_{d}"] = {n: np.asarray(je.forward(n, jnp.asarray(v),
                                                    direction=d))
                           for n, v in xs.items()}
        out[f"got_{d}"] = {n: to_numpy(te.forward(n, to_torch(v),
                                                  direction=d))
                           for n, v in xs.items()}
    out["launches"] = sum(K.LAUNCHES.values()) - launches
    return out


def test_engine_plan_equals_reference(engines):
    fields = ("layer", "row0", "col0", "rows", "cols", "core", "replica",
              "seq_slot")
    tiles = lambda p: [tuple(getattr(t, f) for f in fields)
                       for t in p.tiles]
    assert tiles(engines["t"].plan) == tiles(engines["j"].plan)
    assert all(n in engines["t"] for n in SHAPES)
    assert "fc9" not in engines["t"]
    assert any(p.packed.n_passes > 1 for p in engines["t"].layers.values())


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_per_name_alpha_with_fallback(engines, direction):
    """Each matrix's clip in each direction is its dict entry, 1.0 where
    the dict has none, as the reference's."""
    want = ALPHA if direction == "fwd" else ALPHA_BWD
    for n in SHAPES:
        got = float(engines["t"].chip.layers_for(direction)[n].layer
                    .in_alpha)
        ref = float(engines["j"].chip.layers_for(direction)[n].layer
                    .in_alpha)
        assert got == ref == want.get(n, 1.0), (direction, n)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_engine_forward_matches_reference(engines, direction, name):
    """One launch per forward (the plain version here): outputs within one
    count per .5-boundary tile of the reference's."""
    pcl = engines["t"].chip.layers_for(direction)[name]
    x = engines["x" if direction == "fwd" else "xb"][name]
    got = engines[f"got_{direction}"][name]
    want = engines[f"ref_{direction}"][name]
    cfg = CIMConfig()
    x_int, scale = quantize_to_int(to_torch(x), pcl.layer.in_alpha,
                                   cfg.in_bits)
    hits = boundary_hits(to_numpy(x_int).astype(np.float32), pcl.packed,
                         cfg.v_read)
    lsb = float(pcl.packed.denorm_tiles.max() * pcl.layer.w_max * scale
                / (cfg.v_read * cfg.device.g_max))
    tol = hits * lsb * 1.001 + 1e-5 * np.abs(want).max()
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol)


def test_engine_on_cpu_launches_no_kernel(engines):
    assert engines["launches"] == 0


def test_engine_refuses_oracle_only_configs():
    """Per-phase non-idealities other than IR drop need the bit-serial
    oracle: the engine raises, as the reference's does."""
    from repro.core import CIMEngine as JEngine
    from repro.core.types import (CIMConfig as JCfg,
                                  NonIdealityConfig as JNI)
    with pytest.raises(ValueError, match="oracle"):
        JEngine(JCfg(nonideal=JNI(coupling_sigma=0.1)))
    with pytest.raises(ValueError, match="oracle"):
        tcore.CIMEngine(CIMConfig(nonideal=NonIdealityConfig(
            coupling_sigma=0.1)), device="cpu")


def test_engine_forward_needs_a_chip():
    eng = tcore.CIMEngine(CIMConfig(), device="cpu")
    assert eng.plan is None and eng.layers == {}
    with pytest.raises(ValueError, match="program"):
        eng.forward("fc1", torch.zeros(1, 4))


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.CIMEngine(CIMConfig())


def test_compile_chip_reqs_plan_equals_reference():
    """MatrixReq intensities steer duplication onto spare cores: the plan
    (tiles, replicas, the duplicated map) equals the reference's; reqs
    whose names differ from the weights' raise in both."""
    import jax
    import jax.numpy as jnp
    from repro.core import cim as jcim
    from repro.core.mapping import MatrixReq as JReq
    from repro.core.types import CIMConfig as JCfg, CoreSpec as JSpec
    w, x_cal, _, _, _ = _inputs(1)
    shapes = [(n, *s) for n, s in sorted(SHAPES.items())]
    intens = {"fc1": 4.0, "fc2": 1.0, "fc3": 2.0}
    jreqs = [JReq(n, r, c, intens[n]) for n, r, c in shapes]
    treqs = [tmap.MatrixReq(n, r, c, intens[n]) for n, r, c in shapes]
    cj = jcim.compile_chip(jax.random.PRNGKey(0),
                           {n: jnp.asarray(v) for n, v in w.items()},
                           JCfg(), JSpec(n_cores=12), "ideal", reqs=jreqs,
                           x_cal={n: jnp.asarray(v)
                                  for n, v in x_cal.items()})
    ct = tcim.compile_chip({n: to_torch(v) for n, v in w.items()},
                           CIMConfig(), CoreSpec(n_cores=12), "ideal",
                           reqs=treqs,
                           x_cal={n: to_torch(v) for n, v in x_cal.items()})
    fields = ("layer", "row0", "col0", "rows", "cols", "core", "replica",
              "seq_slot")
    assert [tuple(getattr(t, f) for f in fields) for t in ct.plan.tiles] \
        == [tuple(getattr(t, f) for f in fields) for t in cj.plan.tiles]
    assert ct.plan.duplicated == cj.plan.duplicated
    assert sum(ct.plan.duplicated.values()) > 0
    for n in SHAPES:
        for f in ("row_block", "col_block", "seq_slot", "tile_slot",
                  "out_slot", "out_col", "n_passes"):
            assert getattr(ct.layers[n].packed, f) == \
                getattr(cj.layers[n].packed, f), (n, f)
    bad = treqs[:2]
    with pytest.raises(ValueError, match="reqs names"):
        tcim.compile_chip({n: to_torch(v) for n, v in w.items()},
                          CIMConfig(), reqs=bad)
    with pytest.raises(ValueError, match="reqs names"):
        jcim.compile_chip(jax.random.PRNGKey(0),
                          {n: jnp.asarray(v) for n, v in w.items()},
                          JCfg(), reqs=jreqs[:2])


def test_deploy_packed_stack_rejects_unknown_alpha_name():
    """A per-name in_alpha that names no projection of the stack raises in
    both packages with the reference's words."""
    import jax
    import jax.numpy as jnp
    from repro.core.types import CIMConfig as JCfg
    from repro.models import nn as jnn
    w = np.random.default_rng(0).normal(0, 0.1, (1, 64, 32)) \
        .astype(np.float32)
    with pytest.raises(ValueError, match="match no projection"):
        jnn.deploy_packed_stack(jax.random.PRNGKey(0),
                                {"wq": jnp.asarray(w)}, JCfg(),
                                in_alpha={"w_q": 2.0})
    with pytest.raises(ValueError, match="match no projection"):
        tnn.deploy_packed_stack({"wq": to_torch(w)}, CIMConfig(),
                                in_alpha={"w_q": 2.0})
    got = tnn.deploy_packed_stack({"wq": to_torch(w), "wk": to_torch(w)},
                                  CIMConfig(), in_alpha={"wq": 2.0})
    assert float(got["wq"][0].layer.in_alpha) == 2.0
    assert float(got["wk"][0].layer.in_alpha) == 1.0


# ------------------------------------------------ the packed executors

def _raw_plans(seed=4):
    """Raw-weight packs (no conductances) of one (200, 500) matrix on both
    packages: single-pass, merged (2 cores: multi-pass) and the merged
    plan's transpose, with the weights and activations that drive them."""
    import jax.numpy as jnp
    from repro.core import mapping as jmap
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.1, (200, 500)).astype(np.float32)
    out = {}
    for label, cores in (("single-pass", 48), ("merged", 2)):
        tiles = jmap.plan_layers([jmap.MatrixReq("m", 200, 500)],
                                 jmap.CoreSpec(n_cores=cores)).tiles_for("m")
        sched = jmap.schedule_tiles(tiles)
        pj = jmap.pack_tiles(tiles, jnp.asarray(w), schedule=sched)
        out[label] = (pj, tiles, False)
        if label == "merged":
            out["transposed"] = (jmap.pack_tiles_transposed(
                tiles, pj, schedule=sched), tiles, True)
    return w, out


@pytest.mark.parametrize("plan", ["single-pass", "merged", "transposed"])
@pytest.mark.parametrize("xkind", ["float", "integer"])
def test_multicore_mvm_packed_exact_matmul(plan, xkind):
    """cfg None: the exact tiled matmul through the identity epilogue, on
    every route, against the reference's and x @ W within f32 rounding;
    bit for bit on integer x (|x| <= 7) and weights on the 2^-12 grid,
    where every tile's dot is exact in both packages (f32 there, FP64
    here) and the tiles' sum in slot order too."""
    import dataclasses
    import jax.numpy as jnp
    from repro.core import mapping as jmap
    w, plans = _raw_plans()
    pj, _, transpose = plans[plan]
    rng = np.random.default_rng(7)
    k = 500 if transpose else 200
    if xkind == "integer":
        x = rng.integers(-7, 8, (6, k)).astype(np.float32)
        pj = dataclasses.replace(
            pj, gd_tiles=jnp.round(pj.gd_tiles * 2.0 ** 12) / 2.0 ** 12)
    else:
        x = rng.normal(0, 1.0, (6, k)).astype(np.float32)
    pt = packed_to_torch(pj)
    launches = sum(K.LAUNCHES.values())
    got = to_numpy(tcore.multicore_mvm_packed(to_torch(x), pt))
    assert sum(K.LAUNCHES.values()) == launches
    want = np.asarray(jmap.multicore_mvm_packed(jnp.asarray(x), pj))
    if xkind == "integer":
        np.testing.assert_array_equal(got, want)
        return
    wf = w.T if transpose else w
    band = MATMUL_RTOL * (np.abs(x) @ np.abs(wf))
    assert np.all(np.abs(got - want) <= band)
    exact = x.astype(np.float64) @ wf.astype(np.float64)
    assert np.all(np.abs(got - exact) <= band)


def test_multicore_mvm_packed_cim_datapath_matches_reference():
    """With a CIMConfig: the packed CIM datapath on integer x (the pack's
    de-normalized charge units), within one count per .5-boundary tile
    of the reference's plus f32 rounding of the tiles' weighted sum."""
    import jax
    import jax.numpy as jnp
    from repro.core import cim as jcim
    from repro.core import mapping as jmap
    from repro.core.types import CIMConfig as JCfg
    w, x_cal, _, _, _ = _inputs(2)
    cj = jcim.compile_chip(jax.random.PRNGKey(0),
                           {"fc1": jnp.asarray(w["fc1"])}, JCfg(),
                           mode="ideal",
                           x_cal={"fc1": jnp.asarray(x_cal["fc1"])})
    pj = cj.layers["fc1"].packed
    x = np.random.default_rng(3).integers(-7, 8, (5, 200)).astype(np.float32)
    pt = packed_to_torch(pj)
    got = to_numpy(tcore.multicore_mvm_packed(to_torch(x), pt, CIMConfig()))
    want = np.asarray(jmap.multicore_mvm_packed(jnp.asarray(x), pj, JCfg()))
    hits = boundary_hits(x, pt, 0.5)
    tol = hits * float(pt.denorm_tiles.max()) * 1.001 \
        + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("plan", ["merged", "transposed"])
def test_multicore_mvm_packed_unfused_matches_reference(plan):
    """fused=False (the per-slot partial baseline) against the reference's
    fused=False, bit for bit on integer x (|x| <= 7) and weights on the
    2^-12 grid, and against the port's fused result."""
    import dataclasses
    import jax.numpy as jnp
    from repro.core import mapping as jmap
    _, plans = _raw_plans()
    pj, _, transpose = plans[plan]
    pj = dataclasses.replace(
        pj, gd_tiles=jnp.round(pj.gd_tiles * 2.0 ** 12) / 2.0 ** 12)
    x = np.random.default_rng(9).integers(
        -7, 8, (6, 500 if transpose else 200)).astype(np.float32)
    pt = packed_to_torch(pj)
    got = to_numpy(tcore.multicore_mvm_packed(to_torch(x), pt, fused=False))
    want = np.asarray(jmap.multicore_mvm_packed(jnp.asarray(x), pj,
                                                fused=False))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, to_numpy(tcore.multicore_mvm_packed(to_torch(x), pt)))


@pytest.mark.parametrize("plan", ["single-pass", "merged"])
def test_multicore_mvm_loop_matches_reference(plan):
    """The per-tile loop, with a matmul_fn that reads its tile (a per-core
    gain), against the reference's loop; and with the exact product
    against the packed executor's exact matmul."""
    import jax.numpy as jnp
    from repro.core import mapping as jmap
    w, plans = _raw_plans()
    pj, tiles, _ = plans[plan]
    x = np.random.default_rng(8).normal(0, 1, (4, 200)).astype(np.float32)
    gain = lambda t: 1.0 + 0.25 * (t.core % 3)
    want = np.asarray(jmap.multicore_mvm(
        jnp.asarray(x), jnp.asarray(w), tiles,
        lambda xt, wt, t: (xt @ wt) * gain(t)))
    got = to_numpy(tcore.multicore_mvm(
        to_torch(x), to_torch(w), tiles,
        lambda xt, wt, t: (xt @ wt) * gain(t)))
    band = MATMUL_RTOL * 4 * (np.abs(x) @ np.abs(w))
    assert np.all(np.abs(got - want) <= band)
    exact = to_numpy(tcore.multicore_mvm(to_torch(x), to_torch(w), tiles,
                                         lambda xt, wt, t: xt @ wt))
    packed = to_numpy(tcore.multicore_mvm_packed(to_torch(x),
                                                 packed_to_torch(pj)))
    assert np.all(np.abs(exact - packed) <= band)


@pytest.mark.cuda
def test_multicore_mvm_packed_on_card():
    """On the card the exact matmul launches its kernel once: the split
    route on any float x, the walk on integers; bit for bit against the
    plain version (integer x, weights on the 2^-23 grid), and the walk
    refuses x it would read wrongly as int8."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    w = torch.round(torch.randn(3584, 1024, generator=gen, device=dev)
                    * 2.0 ** 20) / 2.0 ** 23
    tiles = tmap.plan_layers([tmap.MatrixReq("m", 3584, 1024)],
                             CoreSpec(n_cores=4096)).tiles_for("m")
    pt = tmap.pack_tiles(tiles, w)
    for m in (4, 32):
        x = torch.randint(-127, 128, (m, 3584), generator=gen,
                          device=dev).to(torch.float32)
        before = K.LAUNCHES["cim_mvm_packed"]
        got = tcore.multicore_mvm_packed(x, pt)
        want = tcore.multicore_mvm_packed(x, pt, impl="plain")
        torch.cuda.synchronize()
        assert K.LAUNCHES["cim_mvm_packed"] == before + 1
        assert torch.equal(got, want), m
    with pytest.raises(ValueError, match="int8"):
        tcore.multicore_mvm_packed(x + 0.5, pt)
