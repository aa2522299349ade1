"""Port parity: the shape cells (`configs`), the analytic FLOPs
(`launch/roofline.py`) and the production-mesh dry run
(`launch/dryrun.py`).

`SHAPES`, `cells` and every `input_specs` / `cache_specs` leaf equal the
reference's (shape and dtype; the port's static cache fill is a Python
int where the reference's is a 0-d int32, `models.transformer.init_cache`);
`model_flops` equals the reference's on all 10 archs x 4 shapes to
relative 1e-12. The dry run is held to its contract at smoke size: the
record keeps the reference's keys, nothing but meta tensors is made, the
counted FLOPs of the dense cells lie within [0.8, 1.25] of the model's,
the train step's rows carry all its counted FLOPs, the ZeRO exchange
bytes are the shards', and `tools/make_experiments.py`, unmodified,
renders the records.
"""
import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as tc
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun, roofline, steps

REPO = Path(__file__).resolve().parents[1]


def _jax_dtype(dt):
    return str(dt)


def _torch_dtype(dt):
    return str(dt).removeprefix("torch.")


def test_shapes_and_cells_match_reference():
    from repro import configs as jc
    assert list(tc.SHAPES) == list(jc.SHAPES)
    for name, s in jc.SHAPES.items():
        t = tc.SHAPES[name]
        assert (t.name, t.seq_len, t.global_batch, t.kind) == \
            (s.name, s.seq_len, s.global_batch, s.kind)
    assert tc.LONG_CONTEXT_OK == jc.LONG_CONTEXT_OK
    assert tc.ARCH_NAMES == jc.ARCH_NAMES
    assert tc.cells(include_skipped=True) == jc.cells(include_skipped=True)
    assert tc.cells() == jc.cells()
    assert len(tc.cells(include_skipped=True)) == 40


@pytest.mark.parametrize("arch", tc.ARCH_NAMES)
def test_input_and_cache_specs_match_reference(arch):
    from repro import configs as jc
    for shape in tc.SHAPES:
        cfg_t, cfg_j = tc.get(arch), jc.get(arch)
        got = tc.input_specs(cfg_t, tc.SHAPES[shape])
        want = jc.input_specs(cfg_j, jc.SHAPES[shape])
        assert set(got) == set(want), shape
        for k, v in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(v.shape), (shape, k)
            assert _torch_dtype(got[k].dtype) == _jax_dtype(v.dtype)
        if tc.SHAPES[shape].kind != "decode":
            continue
        got = tc.cache_specs(cfg_t, tc.SHAPES[shape])
        want = jc.cache_specs(cfg_j, jc.SHAPES[shape])
        assert set(got) == set(want), shape
        for k, v in want.items():
            if k == "len":
                assert got[k] == 0 and v.shape == ()
                continue
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(v.shape), (shape, k)
            assert _torch_dtype(got[k].dtype) == _jax_dtype(v.dtype)


@pytest.mark.parametrize("arch", tc.ARCH_NAMES)
def test_model_flops_match_reference(arch):
    from repro import configs as jc
    from repro.launch import roofline as jr
    for shape in tc.SHAPES:
        got = roofline.model_flops(tc.get(arch), tc.SHAPES[shape])
        want = jr.model_flops(jc.get(arch), jc.SHAPES[shape])
        assert abs(got - want) <= 1e-12 * abs(want), (shape, got, want)


def _reference_record_keys():
    """The keys of the reference's dry-run record, its memory record and
    its roofline terms, read from its source (importing it would set
    XLA_FLAGS for this process)."""
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "lower_cell")
    keys = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and isinstance(node.targets[0], ast.Name):
            keys[node.targets[0].id] = node.value
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Subscript) and isinstance(
                node.targets[0].value, ast.Name) \
                and node.targets[0].value.id == "roof":
            keys.setdefault("roof_extra", []).append(
                node.targets[0].slice.value)
    rec = keys["rec"]
    top = {k.value for k in rec.keys}
    mem = next({k.value for k in v.keys} for k, v in zip(rec.keys,
                                                         rec.values)
               if k.value == "memory")
    roof = {k.value for k in keys["roof"].keys} | set(keys["roof_extra"])
    return top, mem, roof


class _NoAllocation(TorchDispatchMode):
    """Records every operation that returns a tensor off the meta device,
    save 0-d CPU tensors: host scalars, as gemma's embedding scale is
    (`models.transformer._embed`), which a kernel reads as an argument."""

    def __init__(self):
        super().__init__()
        self.off_meta = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.device.type != "meta" \
                    and not (t.device.type == "cpu" and t.dim() == 0):
                self.off_meta.append(str(func))
        return out


@pytest.mark.parametrize("arch,shape", [
    ("gemma2-9b", "train_4k"), ("gemma2-9b", "prefill_32k"),
    ("gemma2-9b", "decode_32k"), ("rwkv6-7b", "long_500k")])
def test_smoke_lower_cell_keeps_the_record_and_allocates_nothing(arch,
                                                                 shape):
    top, mem, roof = _reference_record_keys()
    with _NoAllocation() as watch:
        rec, compiled = dryrun.lower_cell(arch, shape, multi_pod=False,
                                          smoke=True)
    assert compiled is None
    assert not watch.off_meta, watch.off_meta[:5]
    assert set(rec) == top
    assert set(rec["memory"]) == mem
    assert set(rec["roofline"]) == roof
    assert rec["memory"]["temp_bytes"] is None
    assert rec["memory"]["peak_bytes"] is None
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["hlo_flops_per_dev"] > 0 and rec["hlo_bytes_per_dev"] > 0
    if arch == "gemma2-9b":        # a dense arch
        assert 0.8 <= rec["model_over_hlo"] <= 1.25, rec["model_over_hlo"]
    json.dumps(rec)


def test_train_rows_carry_every_counted_flop():
    """A train step's counted FLOPs all lie in its rows' forward and
    backward: the count around `steps.loss_and_grads` equals the count
    over the whole step (smoke gemma2-9b on a 2 x 2 meta mesh, two
    microbatches, ZeRO)."""
    from repro_torch.launch.mesh import Mesh, data_axes
    cfg = tc.get("gemma2-9b", smoke=True)
    shape = tc.ShapeSpec("t", 32, 8, "train")
    mesh = Mesh.over([dryrun.META] * 4, {"data": 2, "model": 2})
    cell = dryrun._Cell(cfg, shape, mesh, data_axes(mesh), fsdp=False,
                        kv_mode="hd", rows=8)
    step = steps.make_train_step(cfg, accum=2, grad_spec=cell.zspec,
                                 data_axes=data_axes(mesh), mesh=mesh)
    counts = {"flops": 0}
    with dryrun._counted_rows(counts):
        step(cell.params, steps.adamw_init_f32(cell.params), cell.batch)
    cell = dryrun._Cell(cfg, shape, mesh, data_axes(mesh), fsdp=False,
                        kv_mode="hd", rows=8)
    with FlopCounterMode(display=False) as fc:
        step(cell.params, steps.adamw_init_f32(cell.params), cell.batch)
    assert counts["flops"] == fc.get_total_flops() > 0


def test_zero_exchange_bytes_are_the_shards():
    """The meshed train step's tally: per microbatch one reduce-scatter of
    every leaf's f32 shard; once per step the replicas, the norm's row
    sums and the write-back of the updated params."""
    from repro_torch.launch.mesh import data_axes, make_production_mesh
    cfg = tc.get("gemma2-9b", smoke=True)
    shape = tc.ShapeSpec("t", 32, 64, "train")
    mesh = make_production_mesh(devices=[dryrun.META])
    daxes = data_axes(mesh)
    out = dryrun._run_cell(cfg, shape, mesh, daxes, accum=4)
    cell = dryrun._Cell(cfg, shape, mesh, daxes, fsdp=False, kv_mode="hd",
                        rows=16)
    leaves = list(dryrun._leaves(cell.params))
    shard = dryrun._shard_bytes(cell.params, cell.zspec, mesh,
                                torch.float32)
    whole = sum(S.nbytes(p.shape, p.dtype) for p in leaves)
    coll = out["coll"]
    assert coll["reduce-scatter"] == 4 * shard
    assert coll["all-gather"] == 2 * whole
    assert coll["all-reduce"] == 4 * 4 + 4 * len(leaves)
    assert coll["all-to-all"] == 0


def test_multi_pod_cell_and_failures_name_the_cell(monkeypatch):
    rec, _ = dryrun.lower_cell("gemma2-9b", "decode_32k", multi_pod=True,
                               smoke=True)
    assert rec["mesh"] == "2x16x16" and rec["n_devices"] == 512
    assert rec["roofline"]["dominant"].startswith("n/a")

    def needs_a_value(cfg):
        def step(params, cache, batch):
            return int(batch["tokens"].sum()), cache
        return step
    monkeypatch.setattr(steps, "make_decode_step", needs_a_value)
    with pytest.raises(RuntimeError, match="gemma2-9b x decode_32k"):
        dryrun.lower_cell("gemma2-9b", "decode_32k", multi_pod=False,
                          smoke=True)


def test_cli_records_render_with_make_experiments(tmp_path):
    """run_and_save through the CLI writes the reference's file names;
    tools/make_experiments.py, unmodified, renders the directory."""
    out = tmp_path / "experiments" / "dryrun"
    dryrun.main(["--arch", "rwkv6-7b", "--shape", "long_500k",
                 "--out", str(out)])
    dryrun.main(["--arch", "gemma2-9b", "--shape", "decode_32k", "--smoke",
                 "--out", str(out)])
    rec = json.loads((out / "rwkv6-7b__long_500k__16x16.json").read_text())
    assert rec["status"] == "ok" and not rec["smoke"]
    assert (out / "gemma2-9b__decode_32k__16x16__smoke.json").exists()
    assert math.isclose(rec["model_flops_total"], roofline.model_flops(
        tc.get("rwkv6-7b"), tc.SHAPES["long_500k"]))
    proc = subprocess.run([sys.executable,
                           str(REPO / "tools" / "make_experiments.py")],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "| rwkv6-7b | long_500k | 16x16 | ok |" in proc.stdout
    assert np.isfinite(rec["roofline"]["memory_s"])
    assert not os.environ.get("XLA_FLAGS", "").count("512")
