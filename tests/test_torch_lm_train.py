"""Port parity, LM training (`repro_torch/launch/steps.make_train_step`,
`adamw_init_f32`, `adamw_apply`; `launch/train.py`; `checkpoint/`;
`distributed/fault.py`): the JAX reference and the port on the CPU, from
the same numpy params, optimizer state and batches, at qwen2-72b's f32
SMOKE config.

Tolerances. Losses and gradient norms within STEP_RTOL = 1e-5 (f32 sums
taken in another order). Params after AdamW steps within PARAM_ATOL =
1e-6 where every step's reference gradient is well above rounding (above
1e-4 of its global norm, while the two packages' gradients agree to 1e-6
of it: `test_torch_lm_loss.py`): there Adam's m / sqrt(v) is fixed by
the gradients to well under 1%. Below it, the sign of a rounding-sized
gradient decides Adam's first step (lr either way) in each package: such
elements are held to 2 lr per step. The f32 moments of a bf16 tree within
f32 rounding, its bf16 params within one bf16 ulp.

Checkpoints: the reference's and the port's layout and leaf order are the
same, so each package restores the other's f32 train state leaf for leaf,
exactly; bf16 leaves are saved as f32 and come back bit for bit.
"""
import gc
import json
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch

from repro import configs as jconfigs
from repro.checkpoint import latest_step as jlatest
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.data import lm_tokens as jlm_tokens
from repro.launch import steps as jsteps
from repro.models import transformer as jT
from repro_torch import checkpoint as tck
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.distributed import FaultTolerantTrainer
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tT
from repro_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten

ARCH = "qwen2-72b"
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-6
LR = 1e-3
B, S = 4, 16
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: a smoke step is a loop of small eager ops, and the
    suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    jc = jconfigs.get(ARCH, smoke=True).replace(dtype=jnp.float32)
    tc = ttrain.train_config(ttrain.parse_args(["--arch", ARCH, "--smoke"]))
    return jc, tc


def _batches(jc, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, jc.vocab, (B, S + 1)) for _ in range(n)]


@pytest.fixture(scope="module")
def reference_steps():
    """The reference's jitted train step, three steps at accum 1 and at 2
    from the same params and batches: per step its loss, gnorm, params,
    optimizer state and the gradient at the params it starts from."""
    jc, _ = _configs()
    params = jT.init_params(jax.random.PRNGKey(5), jc)
    batches = _batches(jc, 3)
    grad = jax.jit(jax.grad(jT.lm_loss), static_argnums=2)
    out = {"params": jax.tree_util.tree_map(np.asarray, params),
           "batches": batches}
    for accum in (1, 2):
        step = jax.jit(jsteps.make_train_step(jc, lr=LR, accum=accum))
        p, o = params, jsteps.adamw_init_f32(params)
        trail = []
        for tok in batches:
            b = {"tokens": jnp.asarray(tok, jnp.int32)}
            g = grad(p, b, jc)
            p, o, loss, gnorm = step(p, o, b)
            trail.append({"loss": float(loss), "gnorm": float(gnorm),
                          "grad": jax.tree_util.tree_map(np.asarray, g),
                          "params": jax.tree_util.tree_map(np.asarray, p),
                          "opt": jax.tree_util.tree_map(np.asarray, o)})
        out[accum] = trail
    return out


def _check_params(got, trail, upto, lr):
    """Params after step `upto` against the reference's: PARAM_ATOL where
    every step's gradient so far is above 1e-4 of its norm or exactly zero
    (an embedding row no token of the batch reads: weight decay alone),
    else 2 lr per step (module docstring)."""
    want = tree_leaves(params_from_numpy(trail[upto]["params"]))
    big = None
    for st in trail[:upto + 1]:
        gl = [to_numpy(g) for g in tree_leaves(params_from_numpy(
            st["grad"]))]
        gnorm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                            for g in gl))
        now = [(np.abs(g) > 1e-4 * gnorm) | (g == 0) for g in gl]
        big = now if big is None else [a & b for a, b in zip(big, now)]
    n_big = 0
    for a, b, m in zip(tree_leaves(got), want, big):
        a, b = to_numpy(a), to_numpy(b)
        np.testing.assert_allclose(a[m], b[m], rtol=0, atol=PARAM_ATOL)
        assert np.all(np.abs(a[~m] - b[~m]) <= 2 * lr * (upto + 1))
        n_big += int(m.sum())
    assert n_big > 0.5 * sum(x.numel() for x in want)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(reference_steps, accum):
    """Three make_train_step steps (clip to norm 1, AdamW, f32 moments)
    on the reference's params and batches: loss, gnorm, the optimizer's
    t and every param after each step (module docstring's tolerances)."""
    _, tc = _configs()
    ref = reference_steps[accum]
    p = params_from_numpy(reference_steps["params"])
    o = tsteps.adamw_init_f32(p)
    step = tsteps.make_train_step(tc, lr=LR, accum=accum)
    for i, tok in enumerate(reference_steps["batches"]):
        p2, o2, loss, gnorm = step(p, o, {"tokens": to_torch(tok).long()})
        assert p2 is p and o2["m"] is o["m"]        # updated in place
        o = o2
        np.testing.assert_allclose(float(loss), ref[i]["loss"],
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(float(gnorm), ref[i]["gnorm"],
                                   rtol=STEP_RTOL)
        assert int(o["t"]) == int(ref[i]["opt"]["t"]) == i + 1
        _check_params(p, ref, i, LR)


def test_reference_state_carries_across(reference_steps):
    """The reference's params and AdamW state after its first step
    (`params_from_numpy`, `opt_state_from_numpy`) take the port's second
    step to the reference's second-step params."""
    _, tc = _configs()
    ref = reference_steps[1]
    p = params_from_numpy(ref[0]["params"])
    o = opt_state_from_numpy(ref[0]["opt"])
    assert o["t"].dtype == torch.int32 and int(o["t"]) == 1
    for a, b in zip(tree_leaves(o["m"]) + tree_leaves(o["v"]),
                    tree_leaves(p) + tree_leaves(p)):
        assert a.dtype == torch.float32 and a.shape == b.shape
    step = tsteps.make_train_step(tc, lr=LR)
    _, _, loss, _ = step(p, o, {"tokens": to_torch(
        reference_steps["batches"][1]).long()})
    np.testing.assert_allclose(float(loss), ref[1]["loss"], rtol=STEP_RTOL)
    _check_params(p, ref, 1, LR)


def test_adamw_on_bf16_tree_matches_reference():
    """adamw_init_f32 / adamw_apply on a bf16 tree: f32 moments against
    the reference's (f32 rounding), bf16 params updated in f32 and cast
    back (within one bf16 ulp), t an int32 count."""
    rng = np.random.default_rng(3)
    shapes = {"a": (8, 16), "b": {"c": (5,), "d": (3, 4, 2)}}
    mk = lambda sh: (rng.standard_normal(sh) * 0.5).astype(np.float32)
    p32, g32 = (jax.tree_util.tree_map(mk, shapes, is_leaf=lambda x:
                                       isinstance(x, tuple))
                for _ in range(2))
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p32)
    jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), g32)
    tp = tree_map(lambda a: to_torch(a).to(torch.bfloat16), p32)
    tg = tree_map(lambda a: to_torch(a).to(torch.bfloat16), g32)
    jo, to = jsteps.adamw_init_f32(jp), tsteps.adamw_init_f32(tp)
    assert all(t.dtype == torch.float32 for t in tree_leaves(to["m"]))
    for _ in range(2):
        jp, jo = jsteps.adamw_apply(jg, jo, jp, 1e-2)
        tp, to = tsteps.adamw_apply(tg, to, tp, 1e-2)
    assert int(to["t"]) == int(jo["t"]) == 2
    assert to["t"].dtype == torch.int32
    for a, b in zip(tree_leaves(to["m"]) + tree_leaves(to["v"]),
                    jax.tree_util.tree_leaves(jo["m"])
                    + jax.tree_util.tree_leaves(jo["v"])):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=2e-6,
                                   atol=1e-9)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert a.dtype == torch.bfloat16
        b = np.asarray(b.astype(jnp.float32))
        np.testing.assert_allclose(to_numpy(a.float()), b, rtol=2.0 ** -7,
                                   atol=0)


def test_sharded_step_options_raise():
    """The mesh options build a meshed step (`_mesh_train_step`); what
    cannot run raises: grad_spec or data_axes without a mesh, an unknown
    grad_sync, and a microbatch that does not stripe over the rows."""
    from repro_torch.launch.mesh import Mesh
    _, tc = _configs()
    mesh = Mesh([["cpu"]] * 2)
    for kw in ({"grad_spec": {}}, {"data_axes": ("data",)}):
        with pytest.raises(ValueError, match="mesh="):
            tsteps.make_train_step(tc, **kw)
    with pytest.raises(ValueError, match="grad_sync"):
        tsteps.make_train_step(tc, grad_sync="never")
    step = tsteps.make_train_step(tc, data_axes=("data",), mesh=mesh,
                                  grad_sync="once")
    params = tT.init_params(tc, seed=0, device="cpu")
    opt = tsteps.adamw_init_f32(params)
    with pytest.raises(ValueError, match="does not stripe"):
        step(params, opt, {"tokens": torch.zeros((3, 5), dtype=torch.long)})
    _, opt, loss, _ = step(params, opt,
                           {"tokens": torch.zeros((2, 5), dtype=torch.long)})
    assert np.isfinite(float(loss)) and int(opt["t"]) == 1


# ------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 4))},
            "t": torch.zeros((), dtype=torch.int32)}
    tck.save_checkpoint(str(tmp_path), 5, tree)
    assert tck.latest_step(str(tmp_path)) == 5
    d = tmp_path / "step_00000005"
    assert sorted(os.listdir(d)) == ["arr_0.npy", "arr_1.npy", "arr_2.npy",
                                     "manifest.json"]
    assert json.loads((d / "manifest.json").read_text())["n_leaves"] == 3
    restored, step = tck.restore_checkpoint(str(tmp_path), tree)
    assert step == 5
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomicity(tmp_path):
    """A step dir without manifest (simulated crash) is ignored."""
    tree = {"a": torch.arange(4.0)}
    tck.save_checkpoint(str(tmp_path), 1, tree)
    crashed = tmp_path / "step_00000002"
    os.makedirs(crashed)
    np.save(crashed / "arr_0.npy", np.zeros(4))
    assert tck.latest_step(str(tmp_path)) == 1
    restored, step = tck.restore_checkpoint(str(tmp_path), tree)
    assert step == 1 and torch.equal(restored["a"], tree["a"])
    assert tck.restore_checkpoint(str(tmp_path / "none"), tree) == (None,
                                                                     None)


def test_async_checkpointer_snapshots_a_copy(tmp_path):
    """The snapshot is taken at save(): an in-place update right after it
    (the next optimizer step) does not reach the written checkpoint."""
    ck = tck.AsyncCheckpointer(str(tmp_path))
    tree = {"w": torch.ones((64, 64))}
    ck.save(3, tree)
    tree["w"].add_(1.0)
    ck.wait()
    assert tck.latest_step(str(tmp_path)) == 3
    restored, _ = tck.restore_checkpoint(str(tmp_path), tree)
    assert torch.equal(restored["w"], torch.ones((64, 64)))


def test_bf16_checkpoint_roundtrip_is_exact(tmp_path):
    w = torch.randn((33, 7), generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    tree = ({"w": w}, {"m": {"w": w.float()}, "t": torch.tensor(
        4, dtype=torch.int32)})
    tck.save_checkpoint(str(tmp_path), 2, tree)
    assert np.load(tmp_path / "step_00000002" / "arr_0.npy").dtype \
        == np.float32
    restored, _ = tck.restore_checkpoint(str(tmp_path), tree)
    assert restored[0]["w"].dtype == torch.bfloat16
    assert torch.equal(restored[0]["w"], w)
    assert isinstance(restored, tuple) and int(restored[1]["t"]) == 4


def _smoke_state(jc):
    params = jT.init_params(jax.random.PRNGKey(1), jc)
    return params, jsteps.adamw_init_f32(params)


def test_checkpoints_cross_between_packages(tmp_path):
    """A reference save_checkpoint of a smoke train state (params, opt)
    restores in the port leaf for leaf, and a port save restores in the
    reference: the same files, the same leaf order."""
    jc, _ = _configs()
    jstate = _smoke_state(jc)
    jstate = (jstate[0], dict(jstate[1], t=jnp.asarray(7, jnp.int32)))
    tstate = (params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                       jstate[0])),
              opt_state_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          jstate[1])))
    like = tree_map(torch.zeros_like, tstate)
    jsave(str(tmp_path / "j"), 3, jstate)
    got, step = tck.restore_checkpoint(str(tmp_path / "j"), like)
    assert step == 3
    want = jax.tree_util.tree_leaves(jstate)
    assert len(tree_leaves(got)) == len(want)
    for a, b in zip(tree_leaves(got), want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    tck.save_checkpoint(str(tmp_path / "t"), 4, tstate)
    assert jlatest(str(tmp_path / "t")) == 4
    back, _ = jrestore(str(tmp_path / "t"), jax.tree_util.tree_map(
        jnp.zeros_like, jstate))
    for a, b in zip(jax.tree_util.tree_leaves(back), want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------- fault tolerance

def test_fault_injection_and_resume(tmp_path):
    """Training dies at an injected fault; a fresh trainer resumes from the
    latest checkpoint and reaches the state of an uninterrupted run."""
    def step_fn(state, batch):
        return tree_map(lambda x: x + batch, state)

    def data():
        while True:
            yield torch.ones(())

    ref = {"x": torch.zeros(())}
    for _ in range(10):
        ref = step_fn(ref, torch.ones(()))
    # no straggler watchdog here: microsecond steps would trip it at
    # random and checkpoint early (its own test is below)
    tr = FaultTolerantTrainer(step_fn, str(tmp_path), ckpt_every=2,
                              straggler_factor=float("inf"),
                              fault_injector=lambda s: s == 7)
    with pytest.raises(RuntimeError, match="injected fault at step 7"):
        tr.run({"x": torch.zeros(())}, data(), 10)
    assert tck.latest_step(str(tmp_path)) == 6
    assert (7, "fault") in tr.events and (6, "ckpt") in tr.events
    tr2 = FaultTolerantTrainer(step_fn, str(tmp_path), ckpt_every=2,
                               straggler_factor=float("inf"))
    state, start = tr2.resume({"x": torch.zeros(())})
    assert start == 6 and tr2.events == [(6, "resumed")]
    state, end = tr2.run(state, data(), 10, start_step=start)
    assert end == 10 and torch.equal(state["x"], ref["x"])
    assert tck.latest_step(str(tmp_path)) == 10


def test_straggler_watchdog_checkpoints_early(tmp_path, monkeypatch):
    """Steps slower than straggler_factor x the EMA are counted; the
    budget's worth forces a pre-emptive checkpoint at the next step."""
    from repro_torch.distributed import fault
    clock = iter([0.0, 1.0, 1.0, 2.0] + [t for i in range(3)
                                          for t in (10.0 * i + 2,
                                                    10.0 * i + 12)])
    monkeypatch.setattr(fault, "now", lambda: next(clock))
    tr = FaultTolerantTrainer(lambda s, b: s, str(tmp_path), ckpt_every=100,
                              straggler_budget=3)
    tr.run({"x": torch.zeros(())}, iter([0] * 5), 5)
    assert [e for e in tr.events if e[1] != "ckpt"] == [
        (2, "straggler"), (3, "straggler"), (4, "straggler"),
        (4, "preemptive_ckpt")]
    assert tck.latest_step(str(tmp_path)) == 5


# ------------------------------------------------------------------ driver

def test_train_loop_matches_reference_driver(tmp_path):
    """The reference's driver (`repro.launch.train.main`, qwen2-72b smoke,
    4 steps of batch 2, checkpoints every 2) against the port's loop fed
    the reference's params (PRNGKey(0)) and batches (lm_tokens at
    PRNGKey(1000 + i)): every loss within STEP_RTOL; the reference's
    step-4 checkpoint restores in the port to the port's own state: within
    PARAM_ATOL but for at most 0.1% of the elements (a rounding-sized
    gradient's sign), and those within 2 lr per step."""
    from repro.launch.train import main as jmain
    jc, tc = _configs()
    args = ["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2"]
    want = jmain(args + ["--ckpt-dir", str(tmp_path / "j")])
    params = jT.init_params(jax.random.PRNGKey(0), jc)
    batches = iter([{"tokens": to_torch(np.asarray(jlm_tokens(
        jax.random.PRNGKey(1000 + i), 2, 17, jc.vocab))).long()}
        for i in range(4)])
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    res = ttrain.train_loop(tc, p, tsteps.adamw_init_f32(p), batches,
                            steps=4, lr=3e-4, ckpt_dir=str(tmp_path / "t"),
                            ckpt_every=2, log=lambda s: None)
    np.testing.assert_allclose(res.losses, want, rtol=STEP_RTOL)
    assert len(res.step_s) == 4 and res.start == 0
    assert tck.latest_step(str(tmp_path / "t")) == 4
    like = (res.params, res.opt)
    restored, step = tck.restore_checkpoint(str(tmp_path / "j"), like)
    assert step == 4
    n_off = 0
    for a, b in zip(tree_leaves(restored), tree_leaves(like)):
        d = np.abs(to_numpy(a).astype(np.float64) - to_numpy(b))
        assert np.all(d <= 2 * 3e-4 * 4)
        n_off += int((d > PARAM_ATOL).sum())
    assert n_off <= 1e-3 * sum(t.numel() for t in tree_leaves(like))


def test_train_driver_smoke_and_resume(tmp_path, monkeypatch):
    """The port's CLI as `tests/test_system.py` drives the reference's:
    internvl2-1b smoke (its vision prefix in every batch), 8 steps with a
    checkpoint every 4, then resumed to 10. The resumed run's data stream
    restarts at batch 0 (the reference's quirk: `data_iter()` is made
    after `resume`)."""
    seen = []
    orig = ttrain.data_iter

    def recording(*a, **kw):
        for b in orig(*a, **kw):
            seen.append(b)
            yield b
    monkeypatch.setattr(ttrain, "data_iter", recording)
    args = ["--arch", "internvl2-1b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "4"]
    losses = ttrain.main(args + ["--steps", "8"])
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert tck.latest_step(str(tmp_path)) == 8
    vlm = jconfigs.get("internvl2-1b", smoke=True)
    assert seen[0]["vis_embeds"].shape == (2, vlm.vis_patches, vlm.d_model)
    first = seen[0]["tokens"].clone()
    seen.clear()
    losses2 = ttrain.main(args + ["--steps", "10"])
    assert len(losses2) == 2 and np.isfinite(losses2).all()
    assert torch.equal(seen[0]["tokens"], first)       # batch 0 again


def test_train_driver_raises_without_cuda_or_on_a_mesh(tmp_path):
    """Without CUDA the train CLI raises. --production-mesh trains on the
    16 x 16 mesh over the CPU: every leaf a Sharded in its spec's blocks,
    the losses those of the unmeshed run, and a resume cuts the restored
    leaves again."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main(["--smoke", "--ckpt-dir", str(tmp_path)])
    args = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "8", "--ckpt-every", "2"]
    plain = ttrain.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    res = ttrain.run(ttrain.parse_args(args + [
        "--production-mesh", "--ckpt-dir", str(tmp_path / "b")]))
    np.testing.assert_allclose(res.losses, plain, rtol=1e-6)
    from repro_torch.distributed.sharding import Sharded, spec_devices
    leaves = tree_leaves((res.params, res.opt))
    assert all(isinstance(x, Sharded) for x in leaves)
    wq = res.params["layers"]["wq"]
    assert len(wq.shards) == 16 and wq.spec == (None, None, "model")
    assert all(s.device == d for s, d in zip(
        wq.shards, spec_devices(wq.mesh, wq.spec)))
    more = ttrain.run(ttrain.parse_args(args[:-4] + [
        "--steps", "3", "--ckpt-every", "2", "--production-mesh",
        "--ckpt-dir", str(tmp_path / "b")]))
    assert more.start == 2 and len(more.losses) == 1
    assert isinstance(more.params["layers"]["wq"], Sharded)


def test_train_config_and_data():
    """--smoke trains float32, else the config's bf16; --layers cuts the
    depth; --cim noisy sets the mode; batch i's tokens come from a
    generator seeded 1000 + i, whatever the stream's start."""
    a = ttrain.parse_args(["--arch", "deepseek-moe-16b", "--layers", "2",
                           "--cim", "noisy"])
    cfg = ttrain.train_config(a)
    assert (cfg.dtype, cfg.n_layers, cfg.cim_mode, cfg.d_model) == (
        torch.bfloat16, 2, "noisy", 2048)
    assert ttrain.train_config(ttrain.parse_args(["--smoke"])).dtype \
        == torch.float32
    seamless = jconfigs.get("seamless-m4t-medium", smoke=True)
    tc = ttrain.train_config(ttrain.parse_args(
        ["--arch", "seamless-m4t-medium", "--smoke"]))
    it = ttrain.data_iter(tc, 2, 8, CPU)
    b0, b1 = next(it), next(it)
    assert b0["tokens"].shape == (2, 9) and b0["src_embeds"].shape == (
        2, 8, seamless.d_model)
    assert torch.equal(next(ttrain.data_iter(tc, 2, 8, CPU, start=1))[
        "tokens"], b1["tokens"])
    assert int(b0["tokens"].max()) < tc.vocab


def test_tree_unflatten_keeps_no_reference_to_its_leaves():
    """With the cyclic collector off, the leaves a tree_unflatten result
    held are freed as soon as the result is dropped: a reference cycle
    kept a train step's gradients alive until the collector ran, and
    steps at full width ran out of device memory."""
    gc.disable()
    try:
        leaves = [torch.ones(3) for _ in range(4)]
        refs = [weakref.ref(t) for t in leaves]
        out = tree_unflatten(({"b": 0, "a": 0}, [0, 0]), leaves)
        assert out[0]["a"] is leaves[0] and out[1][1] is leaves[3]
        del leaves, out
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
