"""Port parity: the sharding rules, the serving mesh, the replica router
and the launch environment (`repro_torch.distributed.sharding`,
`launch/mesh.py`, `launch/distributed.py`, `launch/env.py`,
`distributed/fault.elastic_reshard`) against the reference's.

Every spec function runs in both packages on the same trees: each of the
ten archs' smoke params (the reference's shapes from `jax.eval_shape`,
the port's tensors from its own `init_params`, held to the same shapes),
decode caches and slot pools. Specs compare as tuples with every entry
normalized to a tuple of axis names (`spec_axes`): jax 0.9 turns the
reference's P(("data",)) into P("data"), which names the same axes.
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.distributed import sharding as jsh
from repro.launch import distributed as jdist
from repro.launch import mesh as jmesh
from repro.launch.scheduler import init_pool as j_init_pool
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.fault import elastic_reshard
from repro_torch.launch import distributed as tdist
from repro_torch.launch import env as tenv
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.scheduler import init_pool as t_init_pool
from repro_torch.models import transformer as tT

REPO = Path(__file__).resolve().parents[1]
MESH_SHAPE = {"data": 2, "model": 4}


def _norm(spec):
    return tuple(None if ax is None else tsh.spec_axes(ax) for ax in spec)


def _flat(tree, path=()):
    """(path, leaf) pairs of a tree of dicts / lists / tuples, dict keys
    sorted; a spec of either package is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, (JP,
                                                                 tsh.P)):
        return [x for i, t in enumerate(tree)
                for x in _flat(t, path + (i,))]
    return [(path, tree)]


def _assert_specs_equal(got, want, what):
    g, w = _flat(got), _flat(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        assert isinstance(a, tsh.P), (what, path, a)
        assert _norm(a) == _norm(b), (what, path, a, b)


def _shapes(tree):
    return [(p, tuple(getattr(x, "shape", ()))) for p, x in _flat(tree)]


@pytest.fixture(scope="module")
def arch_trees():
    """Per arch: (reference params shapes, port params, reference cache,
    port cache, reference pool, port pool) at smoke size."""
    out = {}
    for arch in jconfigs.ARCH_NAMES:
        jc = jconfigs.get(arch, smoke=True)
        tc = tconfigs.get(arch, smoke=True)
        jp = jax.eval_shape(lambda jc=jc: jT.init_params(
            jax.random.PRNGKey(0), jc))
        tp = tT.init_params(tc, seed=0, device="cpu")
        jcache = jax.eval_shape(lambda jc=jc: jT.init_cache(jc, 2, 16))
        tcache = tT.init_cache(tc, 2, 16, device="cpu")
        jpool = jpool_ = None
        if not (jc.enc_layers or jc.vis_patches):
            jpool_ = jax.eval_shape(lambda jc=jc: j_init_pool(jc, 3, 16))
            jpool = t_init_pool(tc, 3, 16, device="cpu")
        out[arch] = (jp, tp, jcache, tcache, jpool_, jpool)
    return out


def test_port_params_have_the_reference_layout(arch_trees):
    for arch, (jp, tp, *_rest) in arch_trees.items():
        assert _shapes(tp) == _shapes(jp), arch


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_param_pspecs_match(arch_trees, arch):
    jp, tp = arch_trees[arch][:2]
    want = jsh.param_pspecs(jp)
    got = tsh.param_pspecs(tp)
    _assert_specs_equal(got, want, arch)
    for (path, a), (_, b) in zip(_flat(got), _flat(want)):
        assert tsh.partition_kind(a) == jsh.partition_kind(b), path
    mesh = types.SimpleNamespace(shape=MESH_SHAPE,
                                 axis_names=("data", "model"))
    _assert_specs_equal(tsh.fit_pspecs(tp, got, MESH_SHAPE),
                        jsh.fit_pspecs(jp, want, mesh), arch)
    _assert_specs_equal(
        tsh.zero_pspecs(tp, got, MESH_SHAPE, data_axes=("data",),
                        min_size=1024),
        jsh.zero_pspecs(jp, want, mesh, data_axes=("data",),
                        min_size=1024), arch)
    _assert_specs_equal(tsh.opt_pspecs(got), jsh.opt_pspecs(want), arch)


@pytest.mark.parametrize("kv_mode", ["hd", "seq"])
def test_cache_and_pool_pspecs_match(arch_trees, kv_mode):
    for arch, (_, _, jcache, tcache, jpool, tpool) in arch_trees.items():
        assert _shapes(tcache) == _shapes(jcache), arch
        _assert_specs_equal(
            tsh.cache_pspecs(tcache, data_axes=("data",), kv_mode=kv_mode),
            jsh.cache_pspecs(jcache, data_axes=("data",), kv_mode=kv_mode),
            arch)
        if jpool is not None:
            _assert_specs_equal(tsh.pool_pspecs(tpool),
                                jsh.pool_pspecs(jpool), arch)


def test_batch_and_packed_pspecs_match():
    batch = {"tokens": np.zeros((4, 8)), "labels": np.zeros((4, 8)),
             "vis": np.zeros((4, 3, 5))}
    tb = {k: torch.zeros(v.shape) for k, v in batch.items()}
    _assert_specs_equal(tsh.batch_pspecs(tb), jsh.batch_pspecs(batch), "b")
    tree = {"a": np.zeros((2, 4, 3, 5)), "b": np.zeros((4, 7))}
    tt = {k: torch.zeros(v.shape) for k, v in tree.items()}
    for n, ax in ((4, 1), (1, 1), (4, 0)):
        _assert_specs_equal(tsh.packed_pspecs(tt, n, ax),
                            jsh.packed_pspecs(tree, n, ax), (n, ax))


@pytest.mark.parametrize("spec", [(None, "model"), ("model", None),
                                  (("data", "model"), None),
                                  ("data", "model"), ()])
def test_shard_shape_and_slice_match(spec):
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    ms = {"data": 2, "model": 4}
    assert tsh.shard_shape(x.shape, tsh.P(*spec), ms) == \
        jsh.shard_shape(x.shape, JP(*spec), ms)
    for d in range(2):
        for m in range(4):
            idx = {"data": d, "model": m}
            got = tsh.shard_slice(torch.from_numpy(x), tsh.P(*spec), ms, idx)
            want = np.asarray(jsh.shard_slice(jnp.asarray(x), JP(*spec), ms,
                                              idx))
            np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="not divisible"):
        tsh.shard_shape((6, 16), tsh.P("model"), ms)


def test_named_shardings_place_by_spec():
    devs = ["cpu"] * 4
    mesh = tmesh.Mesh.over(devs, {"data": 1, "model": 4})
    got = tsh.named_shardings(mesh, {"w": tsh.P(None, "model"),
                                     "n": tsh.P()})
    assert len(got["w"]) == 4 and len(got["n"]) == 1
    assert tsh.packed_shardings(mesh, 4) == got["w"]
    assert tsh.packed_shardings(mesh, 1) == (torch.device("cpu"),)


# ---------------------------------------------------------------- mesh

def test_mesh_shape_for_table(monkeypatch):
    """The reference's factoring table (tests/test_mesh_serving.py),
    over the port's device count."""
    for n, want in [(1, {"data": 1, "model": 1}),
                    (3, {"data": 3, "model": 1}),
                    (6, {"data": 3, "model": 2}),
                    (8, {"data": 1, "model": 8}),
                    (12, {"data": 3, "model": 4}),
                    (64, {"data": 4, "model": 16})]:
        assert tmesh.mesh_shape_for(n) == jmesh.mesh_shape_for(n) == want
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=n: n)
        assert tmesh.serving_mesh_shape() == want, n
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert tmesh.serving_mesh_shape(max_model=2) == {"data": 4, "model": 2}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.serving_mesh()


def test_mesh_class():
    m = tmesh.serving_mesh(device_type="cpu")
    assert m.shape == {"data": 1, "model": 1}
    assert m.axis_names == ("data", "model")
    assert tmesh.data_axes(m) == ("data",)
    m4 = tmesh.Mesh([["cpu"] * 4])
    assert m4.shape == {"data": 1, "model": 4}
    assert m4 == tmesh.Mesh.over(["cpu"] * 4, {"model": 4})
    assert hash(m4) == hash(tmesh.Mesh([["cpu"] * 4]))
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmesh.Mesh.over(["cpu"] * 3, {"model": 4})
    with pytest.raises(ValueError):
        tmesh.Mesh([["cpu"], ["cpu", "cpu"]])
    prod = tmesh.make_production_mesh(devices=["cpu"])
    assert prod.shape == {"data": 16, "model": 16}
    assert prod.n_distinct() == 1 and len(prod.flat()) == 256
    pods = tmesh.make_production_mesh(multi_pod=True, devices=["cpu"] * 3)
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.data_axes(pods) == ("pod", "data")
    assert pods.device_at({"pod": 1, "data": 2, "model": 3}) == \
        torch.device("cpu")
    with pytest.raises(ValueError, match="axes"):
        tmesh.check_serving_mesh(pods)
    tmesh.check_serving_mesh(tmesh.Mesh([["cpu"], ["cpu"]]))
    tmesh.check_serving_mesh(m4)


# ------------------------------------------------------ routing, merge

def _fake_reqs(n):
    return [types.SimpleNamespace(rid=i) for i in range(n)]


def test_route_requests_match_and_partition():
    reqs = _fake_reqs(11)
    for policy in ("round_robin", "hash"):
        for n in (1, 2, 3):
            rids = []
            for rep in range(n):
                got = [r.rid for r in tdist.route_requests(reqs, n, rep,
                                                           policy=policy)]
                want = [r.rid for r in jdist.route_requests(reqs, n, rep,
                                                            policy=policy)]
                assert got == want, (policy, n, rep)
                rids += got
            assert sorted(rids) == list(range(11)), (policy, n)
    assert [len(tdist.route_requests(_fake_reqs(12), 3, rep))
            for rep in range(3)] == [4, 4, 4]
    for rid in (0, 1, 7, 12345, 2 ** 31):
        assert tdist._rid_hash(rid) == jdist._rid_hash(rid)
    with pytest.raises(ValueError):
        tdist.route_requests(reqs, 2, 2)
    with pytest.raises(ValueError):
        tdist.route_requests(reqs, 2, 0, policy="lru")


def test_merge_summaries_match():
    s0 = {"requests": 4, "tokens": 30, "wall_s": 2.0, "tok_per_s": 15.0,
          "p50_ms": 1.0, "p99_ms": 5.0, "ttft_p50_ms": 10.0,
          "decode_traces": 1, "mvm_dispatches": 100, "energy_pj": 300.0,
          "utilization": 0.5, "tops_per_w": 2.0}
    s1 = {"requests": 6, "tokens": 10, "wall_s": 4.0, "tok_per_s": 2.5,
          "p50_ms": 3.0, "p99_ms": 4.0, "ttft_p50_ms": 20.0,
          "decode_traces": 1, "mvm_dispatches": 300, "energy_pj": 100.0,
          "utilization": 0.9, "tops_per_w": 4.0}
    got = tdist.merge_summaries([s0, s1])
    assert got == jdist.merge_summaries([s0, s1])
    assert got["requests"] == 10 and got["wall_s"] == 4.0
    with pytest.raises(ValueError):
        tdist.merge_summaries([])


def test_single_process_defaults():
    assert tdist.initialize() is False
    assert tdist.process_info() == (0, 1)
    assert tdist.gather_json("t", {"a": 1}) == [{"a": 1}]
    assert tdist.global_mesh_shape(device_type="cpu") == \
        dict(tdist.serving_mesh(device_type="cpu").shape)


# ------------------------------------------------------------------ env

def test_runtime_env_group_vars_roundtrip():
    e = tenv.runtime_env(num_processes=2, process_id=1,
                         coordinator="localhost:5000", base={})
    assert tenv.from_env(e) == ("localhost:5000", 2, 1)
    assert tenv.from_env(e) == jax_env_from(e)
    solo = tenv.runtime_env(base=e)
    assert tenv.from_env(solo) is None
    with pytest.raises(ValueError):
        tenv.runtime_env(num_processes=2, process_id=2, base={})


def jax_env_from(e):
    from repro.launch import env as jenv
    return jenv.from_env(e)


def test_from_env_partial_set_raises():
    assert tenv.from_env({}) is None
    with pytest.raises(RuntimeError):
        tenv.from_env({tenv.ENV_COORDINATOR: "localhost:1"})
    with pytest.raises(RuntimeError):
        tenv.from_env({tenv.ENV_COORDINATOR: "c",
                       tenv.ENV_NUM_PROCESSES: "2",
                       tenv.ENV_PROCESS_ID: "2"})


def test_launch_sets_rank_env_and_cli_refuses_host_devices(capsys):
    cmd = [sys.executable, "-c",
           "import os; print(os.environ.get('REPRO_PROCESS_ID'), "
           "os.environ.get('REPRO_NUM_PROCESSES'))"]
    grouped = tenv.launch(cmd, num_processes=2, timeout=60)
    assert [r.stdout.split() for r in grouped] == [["0", "2"], ["1", "2"]]
    solo = tenv.launch(cmd, num_processes=2, sequential=True, timeout=60)
    assert [r.stdout.split() for r in solo] == [["None", "None"]] * 2
    assert tenv.main(["--procs", "1", "--", *cmd]) == 0
    assert "[rank 0 stdout] None None" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tenv.main(["--host-devices", "2", "--", *cmd])


def test_env_module_imports_no_torch():
    code = ("import sys, repro_torch.launch.env\n"
            "assert 'torch' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------ elastic reshard

def test_elastic_reshard_roundtrip(tmp_path):
    """A checkpoint saved from one placement restores onto another mesh's
    placements (named_shardings), and elastic_reshard moves a live tree;
    a placement that would split a leaf raises."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    tree = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(3)}
    save_checkpoint(str(tmp_path), 1, tree)
    mesh = tmesh.Mesh([["cpu"] * 2])
    sh = tsh.named_shardings(mesh, {"w": tsh.P(None, "model"),
                                    "b": tsh.P()})
    restored, step = restore_checkpoint(str(tmp_path), tree, shardings=sh)
    assert step == 1
    for k in tree:
        assert torch.equal(restored[k], tree[k])
        assert restored[k].device == torch.device("cpu")
    moved = elastic_reshard(tree, "cpu")
    assert all(torch.equal(moved[k], tree[k]) for k in tree)
    with pytest.raises(ValueError, match="splits a leaf"):
        elastic_reshard(tree, {"w": (torch.device("cpu"),
                                     torch.device("meta")), "b": "cpu"})
