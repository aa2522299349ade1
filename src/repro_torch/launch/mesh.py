"""Serving meshes of the port (PyTorch port of `repro/launch/mesh.py`).

A `Mesh` is a (data, model) grid of torch.devices with the axis names
("data", "model"). The port is single-controller, as the reference's
serving is: one process holds one engine per 'model' shard on its local
devices and launches each shard's kernel where its chips lie
(`models/nn.sharded_packed_loop`); no collective runs on the serving
path. A mesh's device list may repeat a device: M shards on one card
(or on the CPU) run the same executor, which is how the tests and
`chip_smoke.py` drive it. The CLI builds meshes over distinct local
devices only.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

AXES = ("data", "model")


def _device(d) -> torch.device:
    """torch.device(d), a bare 'cuda' pinned to its index (tensors report
    theirs, and placement compares devices)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (D, M) grid of torch.devices over the axes ("data", "model").
    `shape` is {axis: size}, as the reference's `mesh.shape`."""

    def __init__(self, devices: Sequence[Sequence], axis_names=AXES):
        if tuple(axis_names) != AXES:
            raise ValueError(f"a serving mesh has the axes {AXES}, got "
                             f"{tuple(axis_names)}")
        rows = [tuple(_device(d) for d in row) for row in devices]
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh needs a non-empty rectangular grid of "
                             "devices")
        self.devices = tuple(rows)
        self.axis_names = AXES

    @classmethod
    def over(cls, devices: Sequence, shape: Dict[str, int]) -> "Mesh":
        """The mesh of shape {'data': D, 'model': M} over `devices` (D * M
        of them, row-major)."""
        d, m = int(shape.get("data", 1)), int(shape.get("model", 1))
        devices = list(devices)
        if len(devices) != d * m:
            raise ValueError(f"a {d}x{m} mesh needs {d * m} devices, got "
                             f"{len(devices)}")
        return cls([devices[i * m:(i + 1) * m] for i in range(d)])

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self):
        return hash(self.devices)

    def __repr__(self):
        grid = [[str(d) for d in r] for r in self.devices]
        return f"Mesh({self.shape}, {grid})"


def check_serving_mesh(mesh) -> None:
    """Raise for a mesh whose 'data' width is above 1: the data axis
    within a process (the striped slot pool, batch striping) is not
    ported yet (ROADMAP A17). Replicas across processes are
    (`launch/distributed`)."""
    if mesh.shape.get("data", 1) > 1:
        raise NotImplementedError(
            f"a serving mesh with a 'data' width above 1 ({mesh.shape}) is "
            "not ported yet (ROADMAP A17); serve data-parallel replicas as "
            "processes (launch/env, launch/distributed)")


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16 x 16 (x 2 pods) production mesh serves its dry
    run, which the port does not have yet."""
    raise NotImplementedError(
        "the production mesh serves the dry run, not ported yet "
        "(ROADMAP A14)")


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def mesh_shape_for(n: int, max_model: int = 16) -> dict:
    """{'data': D, 'model': M} factoring of a device count: the model axis
    takes the LARGEST POWER OF TWO that divides n, capped at `max_model`;
    every other factor, odd ones included, lands on the data axis. So 8
    devices factor as {'data': 1, 'model': 8}, 12 as {'data': 3,
    'model': 4}, 6 as {'data': 3, 'model': 2}, and an odd count as
    {'data': n, 'model': 1}: pure data parallelism. One device gives
    {'data': 1, 'model': 1}."""
    m = 1
    while m * 2 <= min(n, max_model) and n % (m * 2) == 0:
        m *= 2
    return {"data": n // m, "model": m}


def local_devices(device_type: str = "cuda") -> list:
    """This process's devices of `device_type`: every visible CUDA device
    (raises without one), or the one CPU."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def serving_mesh_shape(max_model: int = 16,
                       device_type: str = "cuda") -> dict:
    """`mesh_shape_for` over this process's device count (CUDA devices,
    or 1 for the CPU)."""
    return mesh_shape_for(len(local_devices(device_type)), max_model)


def serving_mesh(max_model: int = 16, device_type: str = "cuda",
                 shape: Optional[Dict[str, int]] = None) -> Mesh:
    """The serving Mesh over this process's distinct local devices, shaped
    by `serving_mesh_shape` (or `shape`, which must use every device)."""
    devs = local_devices(device_type)
    return Mesh.over(devs, shape or mesh_shape_for(len(devs), max_model))


def model_mesh(max_model: int = 16, device_type: str = "cuda") -> Mesh:
    """The 'model'-only serving mesh (1 x M) over this process's first M
    local devices, M = `mesh_shape_for`'s 'model' width of their count:
    the rest stay idle, since a 'data' width above 1 within a process is
    not ported yet (ROADMAP A17)."""
    devs = local_devices(device_type)
    m = mesh_shape_for(len(devs), max_model)["model"]
    return Mesh.over(devs[:m], {"data": 1, "model": m})
