"""Meshes of the port (PyTorch port of `repro/launch/mesh.py`).

A `Mesh` is a grid of torch.devices over the axes ("data", "model"), or
("pod", "data", "model") for the multi-pod production mesh. The port is
single-controller, as the reference's serving is: one process holds one
engine per 'model' shard on its local devices and launches each shard's
kernel where its chips lie (`models/nn.sharded_packed_loop`); each
'data' row holds its own copy of the chips and serves its stripe of the
batch or of the slot pool (`models/nn.row_params`,
`launch/scheduler.init_pool`). A mesh's device list may repeat a device:
M shards or D rows on one card (or on the CPU) run the same executor,
which is how the tests and `chip_smoke.py` drive it, and placing onto a
repeated device copies nothing. The CLI builds serving meshes over
distinct local devices only; `make_production_mesh` repeats its devices
to fill the reference's 16 x 16 grid.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import torch

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def _device(d) -> torch.device:
    """torch.device(d), a bare 'cuda' pinned to its index (tensors report
    theirs, and placement compares devices)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _grid(devices, depth: int):
    """The nested device grid as tuples of torch.devices, `depth` deep;
    raises unless it is a non-empty rectangular grid."""
    if depth == 1:
        row = tuple(_device(d) for d in devices)
        if not row:
            raise ValueError("a mesh needs a non-empty rectangular grid of "
                             "devices")
        return row
    rows = tuple(_grid(r, depth - 1) for r in devices)
    if not rows or len({_dims(r) for r in rows}) != 1:
        raise ValueError("a mesh needs a non-empty rectangular grid of "
                         "devices")
    return rows


def _dims(grid) -> tuple:
    return (len(grid),) + (_dims(grid[0]) if isinstance(grid[0], tuple)
                           else ())


class Mesh:
    """A grid of torch.devices over the axes ("data", "model") (a (D, M)
    grid: `devices[d][m]`) or ("pod", "data", "model") (`devices[p][d][m]`).
    `shape` is {axis: size}, as the reference's `mesh.shape`."""

    def __init__(self, devices: Sequence, axis_names=AXES):
        names = tuple(axis_names)
        if names not in (AXES, POD_AXES):
            raise ValueError(f"a mesh has the axes {AXES} or {POD_AXES}, "
                             f"got {names}")
        self.devices = _grid(devices, len(names))
        self.axis_names = names

    @classmethod
    def over(cls, devices: Sequence, shape: Dict[str, int]) -> "Mesh":
        """The mesh of shape {'data': D, 'model': M} (and 'pod': P when
        given) over `devices` (P * D * M of them, row-major)."""
        names = POD_AXES if "pod" in shape else AXES
        sizes = [int(shape.get(a, 1)) for a in names]
        devices = list(devices)
        n = 1
        for k in sizes:
            n *= k
        if len(devices) != n:
            raise ValueError(f"a {'x'.join(map(str, sizes))} mesh needs {n} "
                             f"devices, got {len(devices)}")
        for k in reversed(sizes[1:]):
            devices = [devices[i:i + k] for i in range(0, len(devices), k)]
        return cls(devices, names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, _dims(self.devices)))

    def device_at(self, index: Dict[str, int]) -> torch.device:
        """The device at {axis: position}; absent axes take position 0."""
        g = self.devices
        for a in self.axis_names:
            g = g[index.get(a, 0)]
        return g

    def flat(self) -> tuple:
        """Every device, row-major over the axes."""
        sizes = self.shape
        return tuple(self.device_at(dict(zip(self.axis_names, pos)))
                     for pos in itertools.product(
                         *(range(sizes[a]) for a in self.axis_names)))

    def n_distinct(self) -> int:
        """How many distinct devices the mesh spans."""
        return len(set(self.flat()))

    def rows(self, data_axes=("pod", "data")) -> tuple:
        """The data rows: one (1, M) Mesh per position over the mesh's
        `data_axes` (row-major), holding that row's 'model' devices."""
        axes = [a for a in data_axes if a in self.axis_names]
        sizes = self.shape
        out = []
        for pos in itertools.product(*(range(sizes[a]) for a in axes)):
            at = dict(zip(axes, pos))
            out.append(Mesh([[self.device_at(dict(at, model=m))
                              for m in range(sizes["model"])]]))
        return tuple(out)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.devices == other.devices \
            and self.axis_names == other.axis_names

    def __hash__(self):
        return hash((self.axis_names, self.devices))

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.flat()]})"


def check_serving_mesh(mesh) -> None:
    """Raise for a mesh that serving cannot take, as the reference cannot:
    a serving mesh has the axes ('data', 'model'). A 'data' width above 1
    serves data rows, each with its own copy of the chips."""
    if tuple(mesh.axis_names) != AXES:
        raise ValueError(f"a serving mesh has the axes {AXES}, got "
                         f"{tuple(mesh.axis_names)}")


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's production mesh: 16 x 16 ('data', 'model'), or
    2 x 16 x 16 ('pod', 'data', 'model'). It spans `devices` (default:
    this process's CUDA devices), repeated in order when there are fewer
    than the grid has."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}
    devs = list(devices) if devices is not None else local_devices("cuda")
    if not devs:
        raise ValueError("make_production_mesh needs at least one device")
    n = 1
    for k in shape.values():
        n *= k
    return Mesh.over([devs[i % len(devs)] for i in range(n)], shape)


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
