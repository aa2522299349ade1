"""The JAX reference's meshed runs, in a child process with eight CPU host
devices (`tests/test_torch_mesh_train.py` runs it once per module, one
process per case, the three at once).

  JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_mesh_child.py \
      OUT.npz [ep] [train] [moe_train]

(no case named: all three).

XLA_FLAGS=--xla_force_host_platform_device_count=8 is set before JAX
starts, so the parent's one-device view (tests/conftest.py) stays as it
is. Meshes are `jax.sharding.Mesh` over a reshaped device array: on jax
0.9 `jax.make_mesh` makes Explicit axes, and the train step's
`with_sharding_constraint` refuses those.

Writes one .npz of numpy arrays, keys "<case>/<name>" (trees flattened
with "/"):
  * ep/...: smoke deepseek-moe-16b's layer-0 MoE params, x (4, 8, d) and
    x_odd (4, 7, d) drawn with numpy, and `moe_ffn_ep_shardmap` on a
    (2, 2) ('data', 'model') mesh at capacity 1.25 and 8.0 (x_odd: its
    sequence does not split over 'model'), beside `moe_ffn` dropless;
  * train/...: smoke gemma2-9b's f32 params (1 layer, seed 0), two (4,
    17) batches, and two steps of `make_train_step(lr, accum=2)`, one a
    batch, unsharded and with grad_spec=zero_pspecs(..., min_size=1024),
    data_axes=("data",) on the (2, 2) mesh under each grad_sync: each
    step's loss, gnorm and params (`<run>/<step>/...`, step 1 and 2);
  * moe_train/...: the two sharded steps of smoke deepseek-moe-16b (1
    layer) with moe_impl "ep" (MESH_FOR_EP = the mesh, batch_axes
    ("data",)), grad_sync "micro".
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs  # noqa: E402
from repro.distributed.sharding import param_pspecs, zero_pspecs  # noqa
from repro.launch import steps  # noqa: E402
from repro.models import moe  # noqa: E402
from repro.models import transformer as T  # noqa: E402

LR = 1e-3
ZERO_MIN = 1024


def flat(tree, prefix):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def init_params(key, cfg):
    """The reference's init_params, one compilation in place of one per
    leaf shape; as numpy arrays (placed by each computation that takes
    them, as the reference's eager init's are)."""
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(T.init_params, static_argnums=1)(key, cfg))


def mesh22():
    return jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))


def ep_case(out):
    cfg = configs.get("deepseek-moe-16b", smoke=True).replace(
        dtype=jnp.float32, n_layers=1)
    params = init_params(jax.random.PRNGKey(0), cfg)
    p = {k: v[0] for k, v in params["layers"].items()
         if k in ("router", "ew_g", "ew_i", "ew_o", "sw_g", "sw_i", "sw_o")}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    x_odd = rng.standard_normal((4, 7, cfg.d_model)).astype(np.float32)
    mesh = mesh22()
    out.update(flat(p, "ep/p"))
    out["ep/x"], out["ep/x_odd"] = x, x_odd

    def ep(xx, cf):
        return np.asarray(jax.jit(lambda p_, x_: moe.moe_ffn_ep_shardmap(
            p_, x_, cfg, mesh, capacity_factor=cf,
            data_axes=("data",)))(p, jnp.asarray(xx)))

    for cf in (1.25, 8.0):
        out[f"ep/y_{cf}"] = ep(x, cf)
    out["ep/y_odd_1.25"] = ep(x_odd, 1.25)
    out["ep/y_dropless"] = np.asarray(jax.jit(lambda p_, x_: moe.moe_ffn(
        p_, x_, cfg.replace(moe_dropless=True)))(p, jnp.asarray(x)))


def train_runs(out, case, cfg, params, batches, syncs, mesh, plain=True):
    """Two steps unsharded (plain), then two sharded steps per
    grad_sync."""
    out.update(flat(params, f"{case}/params"))
    for i, batch in enumerate(batches):
        out[f"{case}/tokens{i + 1}"] = np.asarray(batch["tokens"])
    spec = zero_pspecs(params, param_pspecs(params), mesh,
                       min_size=ZERO_MIN)
    runs = [("plain", steps.make_train_step(cfg, lr=LR, accum=2))] \
        if plain else []
    runs += [(sync, steps.make_train_step(
        cfg, lr=LR, accum=2, grad_spec=spec, data_axes=("data",), mesh=mesh,
        grad_sync=sync)) for sync in syncs]
    for name, fn in runs:
        step = jax.jit(fn)
        p, o = params, steps.adamw_init_f32(params)
        for i, batch in enumerate(batches):
            with mesh:
                p, o, loss, gnorm = step(p, o, batch)
            # unplaced again, as the first step's inputs: one compilation
            p, o = jax.tree_util.tree_map(np.asarray, (p, o))
            at = f"{case}/{name}/{i + 1}"
            out[f"{at}/loss"] = np.asarray(loss)
            out[f"{at}/gnorm"] = np.asarray(gnorm)
            out.update(flat(p, f"{at}/params"))


def batches(cfg, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (4, 17)),
                                   jnp.int32)} for _ in range(2)]


def train_case(out):
    cfg = configs.get("gemma2-9b", smoke=True).replace(dtype=jnp.float32,
                                                       n_layers=1)
    params = init_params(jax.random.PRNGKey(0), cfg)
    train_runs(out, "train", cfg, params, batches(cfg, 9), ("micro", "once"),
               mesh22())


def moe_train_case(out):
    mesh = mesh22()
    cfg = configs.get("deepseek-moe-16b", smoke=True).replace(
        dtype=jnp.float32, n_layers=1, moe_impl="ep", batch_axes=("data",))
    params = init_params(jax.random.PRNGKey(1), cfg)
    moe.MESH_FOR_EP = mesh
    try:
        train_runs(out, "moe_train", cfg, params, batches(cfg, 10),
                   ("micro",), mesh, plain=False)
    finally:
        moe.MESH_FOR_EP = None


CASES = {"ep": ep_case, "train": train_case, "moe_train": moe_train_case}


def main(path, cases):
    out = {}
    for name in cases or CASES:
        CASES[name](out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
