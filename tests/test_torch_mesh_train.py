"""Port parity, training on a mesh: the expert-parallel MoE FFN
(`models/moe.moe_ffn_ep_shardmap`), the sharded train step
(`launch/steps.make_train_step(grad_spec=, data_axes=, mesh=,
grad_sync=)`) and the placement helpers under them
(`distributed/sharding.shard_tensor` / `gather` / `Sharded`), against the
JAX reference on the CPU.

The reference's meshed runs need several devices: they run once per
module in a child process with eight CPU host devices
(`tests/_torch_mesh_child.py`, which also draws the inputs and writes
them beside its results), on a (2, 2) ('data', 'model') mesh. The port
runs on `Mesh([['cpu'] * 2] * 2)`.

Tolerances:
  * EP MoE: within EP_RTOL = 1e-6 of the output's largest magnitude, with
    the same dropped routes (the port counts them; the tokens that a drop
    changes are the same in both packages);
  * sharded train step (smoke gemma2-9b, 1 layer, f32, two steps of a
    (4, 17) batch each, accum 2, lr 1e-3, grad_spec = zero_pspecs(...,
    min_size 1024)): each step's loss and gradient norm within STEP_RTOL
    = 1e-6; params after each step, against the reference's sharded step
    and the port's unsharded one, within PARAM_ATOL = 1e-6 where every
    step's gradient so far (the unsharded batch's, before the clip) is
    above GRAD_FLOOR = 1e-6 of its norm or exactly zero, else 2 lr a
    step: below it the sign of a rounding-sized gradient decides AdamW's
    first update (the rule of tests/test_torch_lm_train.py, there at 1e-4
    of the norm; here the floor is lower, so more params are held at
    1e-6: the MoE's routed experts take gradients mostly under 1e-4 of
    the norm, which agree all the same). A block of the gradient that
    reached the wrong shard, a shard AdamW skipped or one not written
    back moves well-conditioned params by about lr.
"""
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tT
from repro_torch.train.optimizer import tree_leaves, tree_unflatten

EP_RTOL = 1e-6
STEP_RTOL = 1e-6
PARAM_ATOL = 1e-6
GRAD_FLOOR = 1e-6
LR = 1e-3
STEPS = 2
ZERO_MIN = 1024
CHILD = Path(__file__).with_name("_torch_mesh_child.py")
MESH = Mesh([["cpu"] * 2] * 2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The child's arrays (module docstring): its three cases at once, a
    process each."""
    tmp = tmp_path_factory.mktemp("mesh_ref")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    cases = ("ep", "train", "moe_train")
    procs = [subprocess.Popen([sys.executable, str(CHILD),
                               str(tmp / f"{c}.npz"), c], env=env, cwd=root,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL) for c in cases]
    try:
        for pr in procs:
            assert pr.wait(timeout=600) == 0, pr.args
    finally:
        for pr in procs:
            pr.kill()
    out = {}
    for c in cases:
        with np.load(tmp / f"{c}.npz") as d:
            out.update({k: d[k] for k in d.files})
    return out


def _tree(ref, prefix):
    """The nested dict of tensors flattened under `prefix/` by the child."""
    out = {}
    for k, v in ref.items():
        if k.startswith(prefix + "/"):
            *path, leaf = k[len(prefix) + 1:].split("/")
            t = out
            for p in path:
                t = t.setdefault(p, {})
            t[leaf] = torch.from_numpy(np.array(v))
    return out


def _moe_cfg():
    return tconfigs.get("deepseek-moe-16b", smoke=True).replace(
        dtype=torch.float32)


def _ep(ref, x, cf, stats=None):
    return tmoe.moe_ffn_ep_shardmap(_tree(ref, "ep/p"),
                                    torch.from_numpy(ref["ep/" + x]),
                                    _moe_cfg(),
                                    MESH, capacity_factor=cf,
                                    data_axes=("data",), stats=stats)


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("x,cf", [("x", 1.25), ("x", 8.0), ("x_odd", 1.25)])
def test_ep_moe_matches_reference(ref, x, cf):
    """Per (data, model) device as the reference's shard_map (x_odd's 7
    positions do not split over 'model': each device of a row takes the
    row's whole stripe). At capacity 1.25 routes are dropped, on the
    senders (x) or the receivers (x_odd); at 8.0 none."""
    stats = {}
    y = _ep(ref, x, cf, stats)
    suffix = "" if x == "x" else "_odd"
    _close(y, ref[f"ep/y{suffix}_{cf}"], EP_RTOL)
    dropped = stats["dropped_send"] + stats["dropped_recv"]
    assert (dropped > 0) == (cf == 1.25), stats


def test_ep_moe_drops_the_reference_routes(ref):
    """The tokens whose output a capacity-1.25 drop changes (against the
    dropless run) are the same in both packages."""
    mine = (_ep(ref, "x", 1.25) - _ep(ref, "x", 8.0)).abs().amax(-1) > 1e-5
    want = np.abs(ref["ep/y_1.25"] - ref["ep/y_8.0"]).max(-1) > 1e-5
    assert mine.any()
    assert (mine.numpy() == want).all()


def test_ep_moe_dropless_equals_moe_ffn(ref):
    """With nothing dropped, the expert-parallel FFN is the sort
    dispatch's (the port's and the reference's dropless moe_ffn)."""
    cfg = _moe_cfg().replace(moe_dropless=True)
    y = tmoe.moe_ffn(_tree(ref, "ep/p"), torch.from_numpy(ref["ep/x"]), cfg)
    _close(y, ref["ep/y_dropless"], EP_RTOL)
    _close(_ep(ref, "x", 8.0), y.numpy(), EP_RTOL)


def test_dense_block_takes_ep_where_the_reference_does(monkeypatch):
    """moe_impl "ep" with MESH_FOR_EP set, and not under packed serving,
    runs the expert-parallel FFN; otherwise moe_ffn."""
    seen = []
    monkeypatch.setattr(tmoe, "moe_ffn_ep_shardmap",
                        lambda *a, **k: seen.append("ep") or a[1])
    monkeypatch.setattr(tmoe, "moe_ffn",
                        lambda *a, **k: seen.append("sort") or a[1])
    cfg = _moe_cfg().replace(n_layers=1)
    assert (cfg.moe_impl, cfg.batch_axes) == ("sort", None)
    params = tT.init_params(cfg, seed=0, device="cpu")
    x = torch.zeros((2, 4, cfg.d_model))
    run = lambda c: tT.dense_block(tT.layer_params(params, 0), x, c,
                                   positions=torch.arange(4), layer_idx=0)
    run(cfg.replace(moe_impl="ep"))
    with tmoe.ep_mesh(MESH):
        run(cfg.replace(moe_impl="ep"))
        run(cfg.replace(moe_impl="ep", cim_mode="packed"))
        run(cfg)
    assert tmoe.MESH_FOR_EP is None
    assert seen == ["sort", "ep", "sort", "sort"]


def _train_cfg(case):
    if case == "train":
        return tconfigs.get("gemma2-9b", smoke=True).replace(
            dtype=torch.float32, n_layers=1)
    return tconfigs.get("deepseek-moe-16b", smoke=True).replace(
        dtype=torch.float32, n_layers=1, moe_impl="ep", batch_axes=("data",))


def _batches(ref, case):
    return [{"tokens": torch.from_numpy(ref[f"{case}/tokens{i + 1}"]).long()}
            for i in range(STEPS)]


def _ep_context(cfg):
    return tmoe.ep_mesh(MESH) if cfg.moe_impl == "ep" \
        else contextlib.nullcontext()


def _steps(ref, case, sync=None):
    """The port's STEPS steps from the child's params and batches:
    unsharded (sync None) or on MESH with the reference's grad_spec.
    Returns (a copy of the params' leaves, loss, gnorm) a step and the
    final optimizer state."""
    cfg = _train_cfg(case)
    params = _tree(ref, f"{case}/params")
    opt = tsteps.adamw_init_f32(params)
    kw = {}
    if sync is not None:
        kw = dict(grad_spec=tsh.zero_pspecs(
            params, tsh.param_pspecs(params), MESH, min_size=ZERO_MIN),
            data_axes=("data",), mesh=MESH, grad_sync=sync)
    step = tsteps.make_train_step(cfg, lr=LR, accum=2, **kw)
    out = []
    with _ep_context(cfg):
        for batch in _batches(ref, case):
            params, opt, loss, gnorm = step(params, opt, batch)
            out.append(([x.clone() for x in tree_leaves(params)],
                        float(loss), float(gnorm)))
    return out, opt


def _big(cfg, params, batches):
    """Per step k, per leaf: where every unsharded gradient of steps 0..k
    (the mean over the two microbatches, at the params that step starts
    from) is above GRAD_FLOOR of its global norm or exactly zero. `params` is
    the port's unsharded trajectory (the child's params, then each step's
    leaves)."""
    out, big = [], None
    with _ep_context(cfg):
        for p, batch in zip(params, batches):
            g = None
            for i in range(2):
                _, gi = tsteps.loss_and_grads(
                    p, tsteps._micro(batch, 2, i), cfg)
                gi = [x.detach().double() for x in tree_leaves(gi)]
                g = gi if g is None else [a + b for a, b in zip(g, gi)]
            norm = float(torch.sqrt(sum((x * x).sum() for x in g)))
            now = [(x.abs() > GRAD_FLOOR * norm) | (x == 0) for x in g]
            big = now if big is None else [a & b for a, b in zip(big, now)]
            out.append([m.numpy() for m in big])
    return out


def _check_params(got, want, big, step):
    """Leaves after step `step` (0-based) within PARAM_ATOL where `big`,
    else 2 lr a step (module docstring)."""
    n_big = 0
    for a, b, m in zip(got, want, big):
        a = a.detach().numpy()
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_allclose(a[m], b[m], rtol=0, atol=PARAM_ATOL)
        assert np.all(np.abs(a[~m] - b[~m]) <= 2 * LR * (step + 1))
        n_big += int(m.sum())
    assert n_big > 0.5 * sum(x.numel() for x in got)


def _check_run(got, ref, case, run, big):
    """The port's steps `got` against the child's run `case/run`: loss and
    gnorm within STEP_RTOL, params by `_check_params`."""
    for k, (leaves, loss, gnorm) in enumerate(got):
        at = f"{case}/{run}/{k + 1}"
        np.testing.assert_allclose(loss, ref[f"{at}/loss"], rtol=STEP_RTOL)
        np.testing.assert_allclose(gnorm, ref[f"{at}/gnorm"],
                                   rtol=STEP_RTOL)
        _check_params(leaves, tree_leaves(_tree(ref, f"{at}/params")),
                      big[k], k)


def _plain(ref, case):
    """The port's unsharded run of `case` and its masks (`_big`)."""
    got, _ = _steps(ref, case)
    params = _tree(ref, f"{case}/params")
    trail = [params] + [tree_unflatten(params, leaves)
                        for leaves, _, _ in got[:-1]]
    return got, _big(_train_cfg(case), trail, _batches(ref, case))


@pytest.fixture(scope="module")
def plain(ref):
    return _plain(ref, "train")


@pytest.mark.parametrize("sync", ["micro", "once"])
def test_sharded_train_step_matches_reference(ref, plain, sync):
    """Both steps' loss and gradient norm of the sharded step as the
    reference's; params as the reference's sharded step's and the port's
    unsharded step's, by the module docstring's rule."""
    got, _ = _steps(ref, "train", sync)
    base, big = plain
    _check_run(got, ref, "train", sync, big)
    for k, ((leaves, loss, gnorm), (b_leaves, b_loss, b_gnorm)) in \
            enumerate(zip(got, base)):
        np.testing.assert_allclose(loss, b_loss, rtol=STEP_RTOL)
        np.testing.assert_allclose(gnorm, b_gnorm, rtol=STEP_RTOL)
        _check_params(leaves, b_leaves, big[k], k)


def test_unsharded_train_step_matches_reference(ref, plain):
    got, big = plain
    _check_run(got, ref, "train", "plain", big)


def test_zero_moments_sit_where_the_spec_puts_them(ref):
    """With grad_spec the moments come back as Sharded leaves of
    opt_pspecs(grad_spec): block i on spec_devices[i], the slice of the
    whole moment that shard_slice names, and 'data' on every leaf the
    spec shards it on."""
    params = _tree(ref, "train/params")
    spec = tsh.zero_pspecs(params, tsh.param_pspecs(params), MESH,
                           min_size=ZERO_MIN)
    _, opt = _steps(ref, "train", "micro")
    n_data = 0
    for m, sp in zip(tree_leaves(opt["m"]), tree_leaves(spec)):
        assert isinstance(m, tsh.Sharded) and m.spec == sp
        whole = m.gather()
        for s, at, dev in zip(m.shards, tsh.spec_indices(MESH, sp),
                              tsh.spec_devices(MESH, sp)):
            assert s.device == dev
            assert torch.equal(s, tsh.shard_slice(whole, sp, MESH.shape, at))
        n_data += any("data" in tsh.spec_axes(a) for a in sp)
    assert n_data > 0


def test_moe_ep_sharded_train_step_matches_reference(ref):
    """smoke deepseek-moe-16b with moe_impl "ep": each data row's
    expert-parallel FFN runs on its row of MESH_FOR_EP; both steps as the
    reference's (masks from the port's unsharded run on MESH_FOR_EP)."""
    got, _ = _steps(ref, "moe_train", "micro")
    _check_run(got, ref, "moe_train", "micro", _plain(ref, "moe_train")[1])


def test_grad_sync_orders_agree():
    """"micro" and "once" differ only in the order of the f32 sums, and a
    meshed step with grad_spec but no data axes is the same step on one
    row (params by the module docstring's rule); the meshed step without
    grad_spec leaves the moments whole."""
    cfg = _train_cfg("train")
    tokens = torch.arange(4 * 9).reshape(4, 9) % cfg.vocab
    outs = []
    for kw in (dict(grad_sync="micro"), dict(grad_sync="once"),
               dict(grad_sync="micro", data_axes=None)):
        params = tT.init_params(cfg, seed=0, device="cpu")
        opt = tsteps.adamw_init_f32(params)
        gs = tsh.zero_pspecs(params, tsh.param_pspecs(params), MESH,
                             min_size=ZERO_MIN)
        kw.setdefault("data_axes", ("data",))
        outs.append(tsteps.make_train_step(
            cfg, lr=LR, accum=2, grad_spec=gs, mesh=MESH, **kw)(
            params, opt, {"tokens": tokens}))
    big = _big(cfg, [tT.init_params(cfg, seed=0, device="cpu")],
               [{"tokens": tokens}])[0]
    for p, _, loss, gnorm in outs[1:]:
        np.testing.assert_allclose(float(loss), float(outs[0][2]),
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(float(gnorm), float(outs[0][3]),
                                   rtol=STEP_RTOL)
        _check_params(tree_leaves(p), tree_leaves(outs[0][0]), big, 0)
    params = tT.init_params(cfg, seed=0, device="cpu")
    opt = tsteps.adamw_init_f32(params)
    _, opt2, _, _ = tsteps.make_train_step(
        cfg, lr=LR, data_axes=("data",), mesh=MESH)(
        params, opt, {"tokens": torch.zeros((2, 5), dtype=torch.long)})
    assert all(isinstance(m, torch.Tensor) for m in tree_leaves(opt2["m"]))


@pytest.mark.parametrize("spec", [(None, "model"), ("data", None),
                                  (("data", "model"), None), ()])
def test_shard_and_gather(spec):
    """shard_tensor cuts a tensor into its blocks in spec_indices order;
    on a mesh that repeats its device they are views and the gather
    copies nothing; blocks of separate storage gather by copy in index
    order; scatter_ writes a whole tensor back."""
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    sh = tsh.shard_tensor(x, spec, MESH)
    idx = tsh.spec_indices(MESH, spec)
    assert len(sh.shards) == len(idx) == len(tsh.spec_devices(MESH, spec))
    for s, at in zip(sh.shards, idx):
        assert s.data_ptr() == tsh.shard_slice(x, spec, MESH.shape,
                                               at).data_ptr()
    whole = sh.gather()
    assert whole.data_ptr() == x.data_ptr() and torch.equal(whole, x)
    copied = tsh.Sharded([s.clone() for s in sh.shards], spec, MESH, x.shape)
    g = copied.gather()
    assert g.data_ptr() != x.data_ptr() and torch.equal(g, x)
    tsh.scatter_(copied, x + 1)
    assert torch.equal(copied.gather(), x + 1)
