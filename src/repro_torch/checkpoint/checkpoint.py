"""Atomic, async checkpointing (PyTorch port of
`repro/checkpoint/checkpoint.py`): numpy files and a JSON index.

Layout:  <dir>/step_<N>/arr_<i>.npy  +  <dir>/step_<N>/manifest.json,
N as %08d. Each step is written into `step_<N>.tmp` and renamed into
place, the manifest last: a step directory without a manifest is
incomplete and ignored by restore (crash consistency).

Leaves go in `train/optimizer.tree_leaves` order — dicts by sorted key,
tuples and lists in order — which is the order of `jax.tree_util`'s
flatten, so the two packages restore each other's checkpoints leaf for
leaf. NumPy has no bfloat16: a bf16 leaf is saved as f32 (exact) and
restored to the dtype of the `like` tree. `restore_checkpoint` places
the restored leaves on `device`, or by the reference's `shardings=`
(`distributed/fault.elastic_reshard`'s placements: a checkpoint saved
under one mesh restores onto another). A `distributed/sharding.Sharded`
leaf is saved whole (gathered) and, as a placement, cuts the restored
leaf into its blocks again.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..train.optimizer import tree_leaves, tree_map, tree_unflatten


def _structure(tree) -> str:
    """The tree's shape as text, for the manifest (not read back)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_structure(t) for t in tree) + ")"
    return "*"


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array that owns its memory (bf16 as f32); a
    `Sharded` leaf gathered first."""
    from ..distributed.sharding import Sharded
    if isinstance(leaf, Sharded):
        leaf = leaf.gather()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Blocking save of `tree` (tensors, numpy arrays or numbers) as step
    `step`; returns the step's directory."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = tree_leaves(tree)
    index = {"step": step, "n_leaves": len(leaves),
             "treedef": _structure(tree)}
    for i, leaf in enumerate(leaves):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), _to_numpy(leaf))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(index, f)
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)          # atomic commit
    return d


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest step with a manifest, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, like: Any, step: Optional[int] = None,
                       device=None, shardings: Any = None):
    """(tree, step) restored into the structure of `like` — each leaf as a
    tensor of the matching `like` leaf's dtype, on `device` or, when None,
    on that leaf's device, then placed by `shardings` when given
    (`distributed/fault.elastic_reshard`) — from `step` or the latest
    complete one; (None, None) when there is none."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    from ..distributed.sharding import Sharded
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    out = []
    for i, leaf in enumerate(tree_leaves(like)):
        arr = torch.from_numpy(np.load(os.path.join(d, f"arr_{i}.npy")))
        if isinstance(leaf, (torch.Tensor, Sharded)):
            arr = arr.to(device=device if device is not None
                         else leaf.device, dtype=leaf.dtype)
        elif device is not None:
            arr = arr.to(device)
        out.append(arr)
    tree = tree_unflatten(like, out)
    if shardings is not None:
        from ..distributed.fault import elastic_reshard
        tree = elastic_reshard(tree, shardings)
    return tree, step


class AsyncCheckpointer:
    """Overlap checkpoint writes with training: snapshot on the caller's
    thread, write on a background thread; wait() joins it, before exit or
    the next save (at most one in flight), and raises what the write
    raised. The snapshot is a real copy: `.cpu()` of a CPU tensor shares
    its storage, and the next step's in-place update would race the
    writer."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any):
        self.wait()
        host_tree = tree_map(_to_numpy, tree)

        def write():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree)
            except Exception as e:          # re-raised by wait()
                self._error = e
        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
