"""Named-axis sharding rules (DP / TP / EP) for every architecture (PyTorch
port of `repro/distributed/sharding.py`), as spec arithmetic on plain
tuples.

Megatron-style tensor parallelism expressed as rules over parameter path
names:

  * column-parallel in-projections (wq/wk/wv, w_g/w_i, in_proj, rwkv
    mixes): output dim on 'model'
  * row-parallel out-projections (wo, w_o, out_proj, cv): input dim on
    'model'
  * embeddings / unembeddings: vocab on 'model'
  * MoE expert stacks (ew_*): expert dim on 'model' (expert parallelism)
  * norms / small vectors: replicated
  * batch dims of activations: ('pod', 'data'); decode KV caches shard
    the head_dim on 'model' (or the sequence, kv_mode 'seq')

Stacked layer params (a leading L dim) get a leading None. A spec is a
`P`, the port's own PartitionSpec: a tuple of entries, each None, one
axis name or a tuple of them. Trees are nested dicts, lists and tuples
(the port's params, caches and pools); every other value is a leaf, with
its `shape` (a leaf without one is a scalar).

Placement is single-controller (`launch/mesh.Mesh`, a grid of
torch.devices). `named_shardings` maps each spec to the devices that hold
its blocks, in row-major order over the axes the spec uses
(`spec_devices`, with `spec_indices` the matching mesh positions), and
`packed_shardings` is that map for a packed shard stack: shard s of a
packed stack goes whole to the device at 'model' position s
(`models/nn.place_packed_stack`). Where the reference's `device_put` cuts
an array into blocks, `shard_tensor` cuts a tensor into a `Sharded`:
block i is `shard_slice(x, spec, mesh.shape, spec_indices(mesh,
spec)[i])` on `spec_devices(mesh, spec)[i]`, a view when that device is
x's own (so a mesh that repeats a device copies nothing). `Sharded.gather`
puts the blocks back together in index order.

`collective_tally` counts the bytes of the port's explicit exchanges
while it is open (`launch/dryrun.py` reads it): each exchange site calls
`tally(kind, nbytes)` with the bytes one device receives in it, under the
reference's collective names — the meshed train step's replica copies and
ZeRO reduce-scatter (`launch/steps._mesh_train_step`), its ordered row
sums of the loss and the gradient norm, the expert-parallel all-to-all
(`models/moe.moe_ffn_ep_shardmap`), `gather` / `scatter_` of a `Sharded`
tensor and the row-parallel chips' ordered fold
(`models/nn.sharded_packed_loop`). What is tallied inside `microbatch()`
(a train step's microbatch loop) is also kept apart, so a count of one
microbatch extends to accum of them. Closed, a tally is one test of a
global.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Any, Dict, Optional, Tuple

import torch

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


class Tally:
    """Bytes per device of each collective kind and the exchanges'
    "count": `total` over the block, `micro` the share made inside
    `microbatch()`."""

    def __init__(self):
        self.total = dict.fromkeys(COLLECTIVES + ("count",), 0)
        self.micro = dict.fromkeys(COLLECTIVES + ("count",), 0)
        self.in_micro = False


_TALLY: Optional[Tally] = None


@contextlib.contextmanager
def collective_tally():
    """Yield a `Tally` of the exchanges made while the block runs."""
    global _TALLY
    old, _TALLY = _TALLY, Tally()
    try:
        yield _TALLY
    finally:
        _TALLY = old


@contextlib.contextmanager
def microbatch():
    """Mark the exchanges of one microbatch of a train step's loop."""
    if _TALLY is None:
        yield
        return
    old, _TALLY.in_micro = _TALLY.in_micro, True
    try:
        yield
    finally:
        _TALLY.in_micro = old


def tally(kind: str, nbytes: int, count: int = 1) -> None:
    """Count an exchange of `nbytes` bytes per device of `kind` (one of
    COLLECTIVES) in the open `collective_tally`, if any."""
    if _TALLY is None:
        return
    for d in (_TALLY.total, _TALLY.micro) if _TALLY.in_micro \
            else (_TALLY.total,):
        d[kind] += int(nbytes)
        d["count"] += count


def nbytes(shape, dtype) -> int:
    """Bytes of a tensor of `shape` and `dtype`."""
    return math.prod(shape) * dtype.itemsize


class P:
    """A PartitionSpec: one entry per tensor dim (trailing dims may be
    left out), each None, an axis name or a tuple of axis names. Compares
    equal to another P or a tuple with the same entries."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self.parts == other.parts
        if isinstance(other, tuple):
            return self.parts == other
        return NotImplemented

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"P{self.parts!r}"


# (the last path key) -> spec for the UNSTACKED param
_RULES = [
    # dense attention + MLP
    ("wq", P(None, "model")), ("wk", P(None, "model")),
    ("wv", P(None, "model")), ("wo", P("model", None)),
    ("bq", P("model")), ("bk", P("model")), ("bv", P("model")),
    ("xwq", P(None, "model")), ("xwk", P(None, "model")),
    ("xwv", P(None, "model")), ("xwo", P("model", None)),
    ("w_g", P(None, "model")), ("w_i", P(None, "model")),
    ("w_o", P("model", None)),
    # MoE
    ("router", P(None, None)),
    ("ew_g", P("model", None, None)), ("ew_i", P("model", None, None)),
    ("ew_o", P("model", None, None)),
    ("sw_g", P(None, "model")), ("sw_i", P(None, "model")),
    ("sw_o", P("model", None)),
    # rwkv6
    ("wr", P(None, "model")), ("wg", P(None, "model")),
    ("ck", P(None, "model")), ("cv", P("model", None)),
    ("cr", P(None, "model")),
    ("u", P("model", None)),
    # mamba2
    ("in_proj", P(None, "model")), ("out_proj", P("model", None)),
    ("a_log", P("model")), ("dt_bias", P("model")), ("dd", P("model")),
    # embeddings
    ("embed", P("model", None)), ("unembed", P(None, "model")),
    ("vis_proj", P(None, None)),
]

_STACKED_KEYS = ("layers", "dense_layers", "enc_layers")


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _map(fn, tree, *rest, path=()):
    """fn(path, leaf, *matching leaves of rest) over a tree of dicts,
    lists and tuples (a P is a leaf); the path holds the dict keys and
    sequence indices from the root."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest), path=path + (k,))
                for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map(fn, t, *(r[i] for r in rest),
                               path=path + (i,))
                          for i, t in enumerate(tree))
    return fn(path, tree, *rest)


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a `launch/mesh.Mesh` or of a mesh-shape dict."""
    return dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)


def _spec_for(path, leaf) -> P:
    keys = [str(k) for k in path]
    last = keys[-1] if keys else ""
    stacked = any(k in _STACKED_KEYS for k in keys[:-1])
    spec = P()
    for suffix, s in _RULES:
        if last == suffix:
            spec = s
            break
    if stacked:
        spec = P(None, *spec)
    ndim = len(_shape(leaf))
    parts = tuple(spec) + (None,) * (ndim - len(spec))
    return P(*parts[:ndim])


def param_pspecs(params_tree) -> Any:
    """The spec tree matching a tree of params."""
    return _map(_spec_for, params_tree)


def batch_pspecs(batch_tree, data_axes=("pod", "data")) -> Any:
    """Shard every batch leaf's leading dim over the data axes."""
    def spec(path, leaf):
        ndim = len(_shape(leaf))
        return P(data_axes, *([None] * (ndim - 1)))
    return _map(spec, batch_tree)


def cache_pspecs(cache_tree, data_axes=("pod", "data"),
                 kv_mode: str = "hd") -> Any:
    """Decode-state sharding: batch over the data axes; KV tensors shard
    either the head_dim ('hd') or the sequence dim ('seq')."""
    def spec(path, leaf):
        last = str(path[-1]) if path else ""
        ndim = len(_shape(leaf))
        if ndim >= 4:
            # (L, B, S, nkv, hd) KV / (L, B, H, n, p) ssm states
            parts = [None] * ndim
            parts[1] = data_axes
            if kv_mode == "seq" and ndim == 5 and last in ("k", "v", "ak",
                                                           "av"):
                parts[2] = "model"
            else:
                parts[-1] = "model"
            return P(*parts)
        if ndim >= 2 and last in ("x_tm", "x_cm"):
            return P(None, data_axes, None)
        return P()
    return _map(spec, cache_tree)


def pool_pspecs(pool_tree, data_axes=("data",)) -> Any:
    """The continuous-batching slot pool's specs (`launch/scheduler`): the
    SLOT dim — axis 1 of every cache / state leaf, axis 0 of the per-slot
    `len` / `active` / `tok` vectors — over the data axes; nothing else
    is partitioned."""
    def spec(path, leaf):
        last = str(path[-1]) if path else ""
        ndim = len(_shape(leaf))
        if last in ("len", "active", "tok"):
            return P(data_axes)
        if ndim >= 2:
            return P(None, data_axes, *([None] * (ndim - 2)))
        return P()
    return _map(spec, pool_tree)


def opt_pspecs(params_specs) -> Dict:
    """AdamW state shards like its params; the step counter replicated."""
    return {"m": params_specs, "v": params_specs, "t": P()}


def zero_pspecs(shape_tree, spec_tree, mesh, data_axes=("pod", "data"),
                min_size: int = 1 << 20):
    """ZeRO-style extra sharding: the data axes on the first unsharded,
    divisible dim of every leaf of at least `min_size` elements, preferring
    non-leading dims (dim 0 of a stacked param is the layer axis). `mesh`
    is a Mesh or a mesh-shape dict. Idempotent."""
    sizes = _axis_sizes(mesh)
    axes = tuple(a for a in data_axes if a in sizes)
    if not axes:
        return spec_tree
    n = math.prod(sizes[a] for a in axes)

    def fix(path, leaf, spec):
        shape = _shape(leaf)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if math.prod(shape) < min_size:
            return P(*parts)
        used = {a for ax in parts for a in spec_axes(ax)}
        if any(a in used for a in axes):
            return P(*parts)              # already data-sharded
        order = list(range(1, len(shape))) + [0] if len(shape) >= 2 else [0]
        for i in order:
            if parts[i] is None and shape[i] % n == 0:
                parts[i] = axes if len(axes) > 1 else axes[0]
                break
        return P(*parts)

    return _map(fix, shape_tree, spec_tree)


def spec_axes(ax) -> tuple:
    """One spec entry as a tuple of mesh axis names: None / '' -> (),
    'model' -> ('model',), ('pod', 'data') -> itself."""
    return ax if isinstance(ax, tuple) else ((ax,) if ax else ())


def partition_kind(spec) -> str:
    """'col' when the output (last) dim is on 'model' (column-parallel),
    'row' when an inner / input dim is (row-parallel), 'none' when
    replicated: whether per-shard chip outputs concatenate or sum
    (`models/nn.ShardedPackedLayer`)."""
    parts = tuple(spec)
    for d, ax in enumerate(parts):
        if "model" in spec_axes(ax):
            return "col" if d == len(parts) - 1 else "row"
    return "none"


def shard_shape(shape, spec, mesh_shape: Dict[str, int]):
    """The local (per-shard) shape of a tensor sharded by `spec` on a mesh
    of {axis: size}; raises when a dim is not divisible."""
    shape = tuple(shape)
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, parts):
        axes = spec_axes(ax)
        n = math.prod(mesh_shape.get(a, 1) for a in axes)
        if dim % n:
            raise ValueError(f"dim {dim} not divisible by mesh axes {axes} "
                             f"(product {n})")
        out.append(dim // n)
    return tuple(out)


def shard_slice(x, spec, mesh_shape: Dict[str, int], index: Dict[str, int]):
    """The local block of tensor `x` held by the shard at `index`
    ({axis: position}) on a mesh of {axis: size}: a view (`torch.narrow`
    along each sharded dim). Axes absent from `index` take position 0;
    raises like `shard_shape` when a dim is not divisible."""
    local = shard_shape(x.shape, spec, mesh_shape)
    parts = tuple(spec) + (None,) * (x.ndim - len(spec))
    out = x
    for d, (ax, loc) in enumerate(zip(parts, local)):
        pos = 0
        for a in spec_axes(ax):             # row-major over the axes tuple
            pos = pos * mesh_shape.get(a, 1) + index.get(a, 0)
        if loc != x.shape[d]:
            out = out.narrow(d, pos * loc, loc)
    return out


def spec_indices(mesh, spec) -> tuple:
    """The mesh positions ({axis: position} over the axes `spec` uses) of
    the blocks of a tensor sharded by `spec`, in row-major order over
    those axes, in the order the spec names them (one block, {}, when it
    uses none)."""
    sizes = _axis_sizes(mesh)
    axes = [a for ax in spec for a in spec_axes(ax)]
    return tuple(dict(zip(axes, pos)) for pos in itertools.product(
        *(range(sizes[a]) for a in axes)))


def spec_devices(mesh, spec) -> tuple:
    """The devices holding the blocks of a tensor sharded by `spec` on
    `mesh`, in `spec_indices` order (one device, the mesh's first, when it
    uses none)."""
    return tuple(mesh.device_at(at) for at in spec_indices(mesh, spec))


class Sharded:
    """A tensor of `shape` cut into the blocks of `spec` on `mesh`:
    `shards[i]` is the block at `spec_indices(mesh, spec)[i]`, on
    `spec_devices(mesh, spec)[i]`. `gather` puts it back together;
    `place(x)` cuts another tensor of the same shape the same way (a
    checkpoint restored onto the mesh: `distributed/fault.elastic_reshard`).
    """

    __slots__ = ("shards", "spec", "mesh", "shape")

    def __init__(self, shards, spec, mesh, shape):
        self.shards = tuple(shards)
        self.spec = P(*spec)
        self.mesh = mesh
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        return self.shards[0].device

    def place(self, x) -> "Sharded":
        return shard_tensor(x, self.spec, self.mesh)

    def gather(self, device=None):
        return gather(self, device)

    def __repr__(self):
        return (f"Sharded({self.shape}, {self.spec}, "
                f"{len(self.shards)} shards)")


def shard_tensor(x, spec, mesh) -> Sharded:
    """`x` cut into the blocks of `spec` on `mesh`, each moved to its
    device (a view of x, no copy, where that device is x's own). Raises
    like `shard_shape` when a dim does not divide."""
    sizes = _axis_sizes(mesh)
    shards = [shard_slice(x, spec, sizes, at).to(dev)
              for at, dev in zip(spec_indices(mesh, spec),
                                 spec_devices(mesh, spec))]
    return Sharded(shards, spec, mesh, x.shape)


def _aliased_whole(sh: Sharded, device):
    """The whole tensor as one view, when every block is a view of it on
    `device` (the blocks of a tensor cut on a mesh that repeats its
    device): block 0 starts where the whole does, with its strides. None
    otherwise."""
    first = sh.shards[0]
    if any(s.device != device or s.untyped_storage().data_ptr()
           != first.untyped_storage().data_ptr() for s in sh.shards):
        return None
    try:
        whole = first.as_strided(sh.shape, first.stride(),
                                 first.storage_offset())
    except RuntimeError:            # would run past the storage
        return None
    sizes = _axis_sizes(sh.mesh)
    for s, at in zip(sh.shards, spec_indices(sh.mesh, sh.spec)):
        v = shard_slice(whole, sh.spec, sizes, at)
        if v.data_ptr() != s.data_ptr() or v.stride() != s.stride():
            return None
    return whole


def gather(sh: Sharded, device=None):
    """The whole tensor of a `Sharded` on `device` (default: block 0's):
    each block copied into its place in index order, or, where the blocks
    are views of one tensor on that device, that tensor (no copy)."""
    dev = torch.device(device) if device is not None else sh.device
    if len(sh.shards) > 1:
        tally("all-gather", nbytes(sh.shape, sh.dtype))
    whole = _aliased_whole(sh, dev)
    if whole is not None:
        return whole
    out = torch.empty(sh.shape, dtype=sh.dtype, device=dev)
    sizes = _axis_sizes(sh.mesh)
    for s, at in zip(sh.shards, spec_indices(sh.mesh, sh.spec)):
        shard_slice(out, sh.spec, sizes, at).copy_(s)
    return out


def scatter_(sh: Sharded, x) -> Sharded:
    """Write the whole tensor `x` back into the blocks of `sh` (each block
    of x copied into its shard, skipped where the shard is that block
    already: a gather that copied nothing). Returns sh."""
    sizes = _axis_sizes(sh.mesh)
    if len(sh.shards) > 1:
        tally("collective-permute", nbytes(sh.shards[0].shape, sh.dtype))
    for s, at in zip(sh.shards, spec_indices(sh.mesh, sh.spec)):
        v = shard_slice(x, sh.spec, sizes, at)
        if v.device != s.device or v.data_ptr() != s.data_ptr():
            s.copy_(v)
    return sh


def place(tree, spec_tree, mesh):
    """Every tensor leaf of `tree` cut by its spec on `mesh`
    (`shard_tensor`); non-tensor leaves are kept."""
    return _map(lambda path, x, spec: shard_tensor(x, spec, mesh)
                if isinstance(x, torch.Tensor) else x, tree, spec_tree)


def gather_tree(tree, device=None):
    """Every `Sharded` leaf of `tree` gathered (`gather`)."""
    return _map(lambda path, x: gather(x, device)
                if isinstance(x, Sharded) else x, tree)


def named_shardings(mesh, spec_tree):
    """Each spec of the tree bound to `mesh`: the tuple of devices holding
    its blocks (`spec_devices`)."""
    return _map(lambda path, s: spec_devices(mesh, s), spec_tree)


def packed_pspecs(shards_tree, n_shards: int, shard_axis: int = 0):
    """The spec tree of a packed shard stack: axis `shard_axis` of every
    leaf on 'model', every other dim replicated; a single-engine stack
    (n_shards == 1) replicates fully. MoE routed-expert stacks reuse it
    with the expert dim as the shard axis (expert parallelism)."""
    def spec(path, leaf):
        parts = [None] * len(_shape(leaf))
        if n_shards > 1:
            parts[shard_axis] = "model"
        return P(*parts)
    return _map(spec, shards_tree)


def packed_shardings(mesh, n_shards: int) -> tuple:
    """Shard s of a packed stack -> the device that holds its chips: the
    mesh's 'model' position s (`named_shardings` of the shard axis'
    spec); a single-engine stack stays on the mesh's first device."""
    return spec_devices(mesh, P("model") if n_shards > 1 else P())


def fit_pspecs(shape_tree, spec_tree, mesh):
    """Any spec axis whose tensor dim is not divisible by the mesh axes'
    product downgraded to replicated (e.g. a smoke config's 2 heads on a
    16-way model axis). `mesh` is a Mesh or a mesh-shape dict."""
    sizes = _axis_sizes(mesh)

    def fix(path, leaf, spec):
        shape = _shape(leaf)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for dim, ax in zip(shape, parts):
            if ax is None:
                out.append(None)
                continue
            n = math.prod(sizes[a] for a in spec_axes(ax))
            out.append(ax if dim % n == 0 else None)
        return P(*out)

    return _map(fix, shape_tree, spec_tree)
