"""Production-mesh dry run (port of `repro/launch/dryrun.py`): run every
(arch x shape) cell's step on the 16 x 16 production mesh with `meta`
tensors in place of params, caches and inputs (shapes and dtypes only,
nothing allocated) and record what the step counts for the roofline.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--smoke]

Records land in experiments/dryrun/<arch>__<shape>__<mesh>.json with the
reference's keys, so `tools/make_experiments.py` renders them; the `hlo_*`
names there mean "counted" here (the port has no HLO):

  * each cell runs the port's step: `steps.make_train_step` with the
    cell's grad_spec (ZeRO-1 when accum > 1), data_axes, mesh and
    grad_sync; `make_prefill_step`; `make_decode_step` — on
    `launch/mesh.make_production_mesh(devices=[meta])`, the 16 x 16 grid
    of one repeated meta device. The reference's decisions stay: fsdp
    "auto" when a shard of the params exceeds 6 GB, accum = global_batch
    // 16 for train, two reduced layer counts (`_layer_pair`) and linear
    extrapolation to the full depth. As the reference counts its
    microbatch loop's body once and multiplies by accum, a train cell runs
    one microbatch (global_batch // accum sequences, accum 1); its FLOPs,
    all made in the microbatch loop, are multiplied by accum, and so is
    the share of its exchanges made there (`sharding.microbatch`), while
    the step's own exchanges count once;
  * FLOPs: `torch.utils.flop_counter.FlopCounterMode` over the step, over
    the mesh's devices (the reference's per-device share). In a train
    step every counted operation runs in the rows' forward and backward
    (the clip, AdamW and the exchanges do no matmul), so the counter runs
    around each `steps.loss_and_grads` call there (tests hold this to a
    count over the whole step);
  * bytes: each argument read once and each output written once per
    step, per device: `distributed/sharding.shard_shape` of each leaf under its spec
    (params, ZeRO moments, batch, cache, logits); the memory record's
    argument and output bytes are the same sums at the full depth.
    `temp_bytes` and `peak_bytes` are null: the port cannot reckon them
    without allocating;
  * collective bytes per device: the port's explicit exchanges, tallied
    where they are made (`distributed/sharding.collective_tally`: the
    meshed train step's replicas, reduce-scatter, row sums and write-back,
    the expert-parallel all-to-all). The prefill and decode steps run
    where their params lie and exchange nothing.

A path that needs a value (`.item()`, a data-dependent shape) cannot run
on meta tensors: the cell raises, naming itself; nothing falls back to
allocating. The module sets no environment variable.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from ..distributed import sharding as S
from ..models import moe
from ..models import transformer as T
from ..obs.clock import now
from . import steps
from .mesh import data_axes, make_production_mesh
from .roofline import model_flops

# NVIDIA H100 SXM5 80GB data-sheet figures at 700 W, per card
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
NVLINK_BW = 450e9          # NVLink bytes/s per direction

META = torch.device("meta")


def _reduced_cfg(cfg, n_layers):
    kw = {"n_layers": n_layers}
    if cfg.enc_layers > 0:
        kw["enc_layers"] = n_layers
    return cfg.replace(**kw)


def _layer_pair(cfg):
    """(a, b) reduced layer counts honoring the arch's periodic structure."""
    if cfg.moe_every > 1:
        return 2 * cfg.moe_every, 4 * cfg.moe_every
    if cfg.hybrid_attn_every > 0:
        return cfg.hybrid_attn_every, 2 * cfg.hybrid_attn_every
    if cfg.alt_local_global:
        return 2, 4
    return 2, 4


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _spec_leaves(tree):
    """The specs of a spec tree, in `_leaves` order of its tensors."""
    if isinstance(tree, S.P):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _spec_leaves(v)


def _shard_bytes(tree, spec_tree, mesh, dtype=None) -> int:
    """Bytes one device holds of `tree` sharded by `spec_tree` (each leaf
    in `dtype` when given)."""
    sizes = mesh.shape
    return sum(S.nbytes(S.shard_shape(t.shape, sp, sizes), dtype or t.dtype)
               for t, sp in zip(_leaves(tree), _spec_leaves(spec_tree)))


def _tensor_specs(tree, spec_tree):
    """Drop the specs of non-tensor leaves (a cache's int fill)."""
    if isinstance(tree, dict):
        return {k: _tensor_specs(v, spec_tree[k]) for k, v in tree.items()
                if isinstance(v, (dict, list, tuple, torch.Tensor))}
    if isinstance(tree, (list, tuple)):
        return [_tensor_specs(v, s) for v, s in zip(tree, spec_tree)]
    return spec_tree


@contextlib.contextmanager
def _counted_rows(counts):
    """FlopCounterMode around each `steps.loss_and_grads` call of a train
    step, summed into counts["flops"] (module docstring)."""
    inner = steps.loss_and_grads

    def counted(*a, **kw):
        with FlopCounterMode(display=False) as fc:
            out = inner(*a, **kw)
        counts["flops"] += fc.get_total_flops()
        return out
    steps.loss_and_grads = counted
    try:
        yield counts
    finally:
        steps.loss_and_grads = inner


class _Cell:
    """One cell's meta arguments and their specs on `mesh`: params (the
    fsdp spec when on), for train the ZeRO-1 spec of the f32 moments and
    the batch of `rows` sequences, else the cache and the batch."""

    def __init__(self, cfg, shape, mesh, daxes, *, fsdp, kv_mode, rows):
        self.params = T.init_params(cfg, device=META)
        self.pspec = S.fit_pspecs(self.params, S.param_pspecs(self.params),
                                  mesh)
        if fsdp and shape.kind == "train":
            self.pspec = S.zero_pspecs(self.params, self.pspec, mesh, daxes)
        batch = configs.input_specs(cfg, shape, dtype=cfg.dtype)
        self.batch = {k: v[:rows] for k, v in batch.items()}
        bspec = S.fit_pspecs(self.batch, S.batch_pspecs(self.batch, daxes),
                             mesh)
        p_bytes = _shard_bytes(self.params, self.pspec, mesh)
        b_bytes = _shard_bytes(self.batch, bspec, mesh)
        if shape.kind == "train":
            self.zspec = S.zero_pspecs(self.params, self.pspec, mesh, daxes)
            o_bytes = 2 * _shard_bytes(self.params, self.zspec, mesh,
                                       torch.float32) + 4
            self.args = p_bytes + o_bytes + b_bytes
            self.outs = p_bytes + o_bytes + 8       # + loss and gnorm
            return
        self.cache = configs.cache_specs(cfg, shape, dtype=cfg.dtype)
        cspec = _tensor_specs(self.cache, S.fit_pspecs(
            self.cache, S.cache_pspecs(self.cache, daxes, kv_mode=kv_mode),
            mesh))
        c_bytes = _shard_bytes(self.cache, cspec, mesh)
        n_data = math.prod(mesh.shape[a] for a in daxes)
        self.args = p_bytes + b_bytes + c_bytes
        self.outs = c_bytes + S.nbytes((rows, cfg.vocab), cfg.dtype) \
            // n_data                                # + the logits


def _run_cell(cfg, shape, mesh, daxes, *, fsdp=False, accum=1,
              kv_mode="hd", grad_sync="micro"):
    """Run one step of cfg / shape on meta tensors; returns the per-device
    counts {"flops", "bytes", "coll"}: the FLOPs of one microbatch (train)
    or one step, the bytes and the exchanges of a step of accum
    microbatches."""
    cell = _Cell(cfg, shape, mesh, daxes, fsdp=fsdp, kv_mode=kv_mode,
                 rows=shape.global_batch // accum)
    counts = {"flops": 0}
    with S.collective_tally() as coll:
        if shape.kind == "train":
            step = steps.make_train_step(
                cfg, accum=1, grad_spec=cell.zspec if accum > 1 else None,
                data_axes=daxes, mesh=mesh, grad_sync=grad_sync)
            with _counted_rows(counts):
                step(cell.params, steps.adamw_init_f32(cell.params),
                     cell.batch)
        else:
            step = (steps.make_prefill_step(cfg) if shape.kind == "prefill"
                    else steps.make_decode_step(cfg))
            with FlopCounterMode(display=False) as fc:
                step(cell.params, cell.cache, cell.batch)
            counts["flops"] = fc.get_total_flops()
    coll = {k: v + (accum - 1) * coll.micro[k]
            for k, v in coll.total.items()}
    return {"flops": counts["flops"] / len(mesh.flat()),
            "bytes": float(cell.args + cell.outs), "coll": coll}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               smoke: bool = False, fsdp: str = "auto", overrides=None,
               kv_mode: str = "hd", grad_sync: str = "micro"):
    """Run one cell at the two reduced depths of `_layer_pair` and
    extrapolate its counts linearly to the full depth. Returns (record,
    None): the
    reference returns its compiled executable second, the port has none.
    A failure raises naming the cell."""
    cell = f"{arch} x {shape_name} ({'2x16x16' if multi_pod else '16x16'})"
    try:
        return _lower_cell(arch, shape_name, multi_pod=multi_pod,
                           smoke=smoke, fsdp=fsdp, overrides=overrides,
                           kv_mode=kv_mode, grad_sync=grad_sync), None
    except Exception as e:
        raise RuntimeError(f"dry run of {cell} failed: {type(e).__name__}: "
                           f"{e}") from e


def _lower_cell(arch, shape_name, *, multi_pod, smoke, fsdp, overrides,
                kv_mode, grad_sync):
    t0 = now()
    cfg = configs.get(arch, smoke=smoke)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = configs.SHAPES[shape_name]
    if smoke:
        shape = dataclasses.replace(shape, seq_len=min(shape.seq_len, 256),
                                    global_batch=min(shape.global_batch, 16))
    mesh = make_production_mesh(multi_pod=multi_pod, devices=[META])
    daxes = data_axes(mesh)
    n_data = math.prod(mesh.shape[a] for a in daxes)
    if shape.global_batch % n_data == 0:
        cfg = cfg.replace(batch_axes=tuple(daxes))
    n_dev = len(mesh.flat())
    n_params = sum(t.numel() for t in _leaves(
        T.init_params(cfg, device=META)))
    per_shard_gb = n_params * 2 / mesh.shape["model"] / 2 ** 30
    use_fsdp = (fsdp == "on") or (fsdp == "auto" and per_shard_gb > 6.0)
    # microbatching: keep per-microbatch global batch at <=16 sequences
    accum = 1
    if shape.kind == "train" and shape.global_batch > 16:
        accum = shape.global_batch // 16
    # the full-depth memory record: a step's arguments (a train cell's
    # whole batch) and outputs per device; temp and peak not reckoned
    full = _Cell(cfg, shape, mesh, daxes, fsdp=use_fsdp, kv_mode=kv_mode,
                 rows=shape.global_batch)
    mem = {"argument_bytes": int(full.args), "output_bytes": int(full.outs),
           "temp_bytes": None, "peak_bytes": None}
    del full
    ep = moe.ep_mesh(mesh) if cfg.moe_impl == "ep" \
        else contextlib.nullcontext()
    kw = dict(fsdp=use_fsdp, accum=accum, kv_mode=kv_mode,
              grad_sync=grad_sync)
    a, b = _layer_pair(cfg)
    a, b = min(a, cfg.n_layers), min(b, cfg.n_layers)
    base = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "n_devices": int(n_dev), "smoke": smoke, "kind": shape.kind,
            "fsdp": bool(use_fsdp and shape.kind == "train"),
            "accum": accum}
    with ep:
        if multi_pod:
            # the multi-pod pass proves the pod axis shards; the roofline
            # table is single-pod only
            _run_cell(_reduced_cfg(cfg, a), shape, mesh, daxes, **kw)
            return {**base, "compile_s": round(now() - t0, 1),
                    "memory": mem, "roofline": {
                        "dominant": "n/a (multi-pod compile-proof only)"}}
        costs = {n_l: _run_cell(_reduced_cfg(cfg, n_l), shape, mesh, daxes,
                                **kw) for n_l in sorted({a, b})}
    L = cfg.n_layers

    def extrap(va, vb):
        if a == b:
            return va * (L / a)
        return va + (L - a) * (vb - va) / (b - a)

    flops = extrap(costs[a]["flops"], costs[b]["flops"]) * accum
    bytes_acc = extrap(costs[a]["bytes"], costs[b]["bytes"])
    coll = {k: int(extrap(costs[a]["coll"][k], costs[b]["coll"][k]))
            for k in costs[a]["coll"]}
    mflops = model_flops(cfg, shape)
    per_dev_coll = sum(v for k, v in coll.items() if k != "count")
    roof = {"compute_s": flops / PEAK_FLOPS,
            "memory_s": bytes_acc / HBM_BW,
            "collective_s": per_dev_coll / NVLINK_BW}
    dom = max(roof, key=roof.get)
    t_bound = max(roof.values())
    roof["dominant"] = dom
    roof["ideal_compute_s"] = mflops / n_dev / PEAK_FLOPS
    roof["roofline_fraction"] = (roof["ideal_compute_s"] / t_bound
                                 if t_bound else None)
    return {**base,
            "compile_s": round(now() - t0, 1),
            "layer_pair": [a, b],
            "hlo_flops_per_dev": flops, "hlo_bytes_per_dev": bytes_acc,
            "model_flops_total": mflops,
            "model_over_hlo": (mflops / n_dev / flops) if flops else None,
            "collective_bytes_per_dev": coll,
            "memory": mem,
            "roofline": roof}


def run_and_save(arch, shape_name, multi_pod, smoke, outdir,
                 skip_existing=False):
    meshname = "2x16x16" if multi_pod else "16x16"
    tag = f"{arch}__{shape_name}__{meshname}" + ("__smoke" if smoke else "")
    path = os.path.join(outdir, tag + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        if prev.get("status") == "ok":
            print(f"[skip] {tag}", flush=True)
            return prev
    try:
        rec, _ = lower_cell(arch, shape_name, multi_pod=multi_pod,
                            smoke=smoke)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record failures as data
        rec = {"arch": arch, "shape": shape_name, "mesh": meshname,
               "smoke": smoke, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[{rec['status']}] {tag}"
          + (f" dominant={rec['roofline']['dominant']}"
             f" compile={rec.get('compile_s')}s"
             if rec["status"] == "ok" else f" {rec.get('error')}"),
          flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = configs.cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape, None)]
    for arch, shape_name, _ in cells:
        for mp in meshes:
            run_and_save(arch, shape_name, mp, args.smoke, args.out,
                         skip_existing=args.skip_existing)


if __name__ == "__main__":
    main()
