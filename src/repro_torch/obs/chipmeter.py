"""Per-compiled-chip dispatch meters: the serving-time form of the paper's
Fig. 4 energy accounting (port of `repro/obs/chipmeter.py`).

A compiled chip is weight-stationary, so its serving energy is fixed by
static plan geometry times the MVM rows the host pushed through it: each
serving step runs every packed projection once per layer, one MVM per
input row. The meter reads each `PackedPlan`'s geometry (n_rows, n_cols)
at construction and counts dispatched rows on the host, at the step
boundaries where the engine has already waited for the device.

The per-MVM operating point is `core/energy.mvm_cost`. For every chip
entry, exactly (one float product of integer counts):

    energy_pj == mvm_cost(rows, cols, in_bits, out_bits).energy_pj
                 * mvm_dispatches

The port's deploy keeps a per-layer LIST under
params["layers"]["<name>_cim"] (the reference stacks layers on a leading
axis of one pytree): of PackedCIMLayers, of ShardedPackedLayers under
tensor parallelism (one chip per shard), and for routed experts of
per-expert lists; an entry's `n_stack` is the number of chips in it, the
reference's product of the stack's leading dims: layers x tensor-parallel
shards, or layers x experts, and its `partition` the shards' ('col',
'row', or 'none' for a replicated stack). An expert entry thus meters
all E expert chips per token, not only the top-k a token reaches — the
reference's modeled energy, which the port reproduces. zamba2's shared
attention block is a bare PackedCIMLayer per projection under
params["shared_attn"] (entries "shared_attn/<name>", n_stack 1), metered
once per token as the reference meters it, though the block runs once per
group of layers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.energy import MVMCost, mvm_cost


@dataclasses.dataclass(frozen=True)
class ChipEntry:
    """Static geometry + operating point of one compiled projection stack.

    `n_stack` is the number of physical chips the entry stands for (one
    per layer): one serving token does `n_stack` MVMs through this entry.
    `rows`/`cols` are the per-chip logical matrix dims, which is what
    `mvm_cost` prices.
    """
    name: str                   # e.g. "layers/wq"
    direction: str              # "fwd" | "bwd"
    rows: int
    cols: int
    n_stack: int
    partition: str              # 'col' | 'row' | 'none' (TP split kind)
    in_bits: int
    out_bits: int

    @property
    def cost(self) -> MVMCost:
        return mvm_cost(self.rows, self.cols, self.in_bits, self.out_bits)


def _iter_cim_entries(tree, prefix=""):
    """Yield (path, value) for every '<name>_cim' entry in a params tree."""
    if not isinstance(tree, dict):
        return
    for k in sorted(tree, key=str):
        v = tree[k]
        if isinstance(k, str) and k.endswith("_cim"):
            yield prefix + k[: -len("_cim")], v
        elif isinstance(v, dict):
            yield from _iter_cim_entries(v, prefix + str(k) + "/")


def _chips(obj) -> list:
    """The PackedCIMLayers of a (nested) list of them or of
    ShardedPackedLayers, or of a bare one of either."""
    if isinstance(obj, list):
        return [c for x in obj for c in _chips(x)]
    if hasattr(obj, "shards"):
        return list(obj.shards)
    return [obj]


def _partition(obj) -> str:
    """The TP split kind of a stack: its ShardedPackedLayers' ('none' for
    bare PackedCIMLayers)."""
    while isinstance(obj, list):
        obj = obj[0]
    return getattr(obj, "partition", "none")


def _entry_from_packed(name: str, obj, in_bits: int, out_bits: int,
                       direction: str = "fwd") -> ChipEntry:
    """A ChipEntry from a per-layer list of PackedCIMLayers (one chip per
    layer, all on one plan) or of ShardedPackedLayers (one per layer and
    shard), a per-layer list of per-expert lists (one per layer and
    expert) or a bare PackedCIMLayer or ShardedPackedLayer."""
    chips = _chips(obj)
    plan = chips[0].packed
    return ChipEntry(name=name, direction=direction,
                     rows=int(plan.n_rows), cols=int(plan.n_cols),
                     n_stack=len(chips), partition=_partition(obj),
                     in_bits=int(in_bits), out_bits=int(out_bits))


class ChipMeter:
    """Dispatch counters over a fixed set of ChipEntries.

    `count_rows(n)` is the serving hot-path call: one engine step that
    pushed `n` input rows (tokens for decode/prefill, batch rows for
    Gibbs) through every chip of a direction. It adds `n * n_stack`
    MVMs to each entry — integer adds only.
    """

    def __init__(self, entries: List[ChipEntry]):
        keys = [(e.name, e.direction) for e in entries]
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate chip entries: {keys}")
        self.entries: Dict[Tuple[str, str], ChipEntry] = dict(zip(keys,
                                                                  entries))
        self._mvms: Dict[Tuple[str, str], int] = {k: 0 for k in keys}

    # ------------------------------------------------------- constructors

    @classmethod
    def from_params(cls, params, in_bits: int,
                    out_bits: int) -> "ChipMeter":
        """Meter every '<name>_cim' packed stack in a deployed params tree
        (an empty meter when nothing is packed: float serving has no chips
        to meter)."""
        entries = [_entry_from_packed(name, obj, in_bits, out_bits)
                   for name, obj in _iter_cim_entries(params)]
        return cls(entries)

    @classmethod
    def from_chip(cls, chip, name: str = "chip") -> "ChipMeter":
        """Meter a bare CompiledChip, per direction: fwd entries from
        `chip.layers`, bwd entries from `chip.bwd_layers` (the RBM's
        bidirectional serving surface)."""
        entries = []
        for lname, pcl in sorted(chip.layers.items()):
            entries.append(_entry_from_packed(
                f"{name}/{lname}", pcl, chip.cfg.in_bits,
                chip.cfg.out_bits, direction="fwd"))
        for lname, pcl in sorted(chip.bwd_layers.items()):
            entries.append(_entry_from_packed(
                f"{name}/{lname}", pcl, chip.cfg.in_bits,
                chip.cfg.out_bits, direction="bwd"))
        return cls(entries)

    # ---------------------------------------------------------- counting

    def count_rows(self, n: int, direction: str = "fwd") -> None:
        """Record one serving step that dispatched `n` input rows through
        every chip of `direction`."""
        if n <= 0:
            return
        for key, e in self.entries.items():
            if e.direction == direction:
                self._mvms[key] += n * e.n_stack

    def count_chip(self, name: str, n_mvms: int,
                   direction: str = "fwd") -> None:
        """Targeted count: `n_mvms` MVMs on one named chip entry."""
        key = (name, direction)
        if key not in self.entries:
            raise KeyError(f"no chip entry {key}; have "
                           f"{sorted(self.entries)}")
        self._mvms[key] += int(n_mvms)

    # ----------------------------------------------------------- queries

    def mvm_dispatches(self, name: Optional[str] = None,
                       direction: Optional[str] = None) -> int:
        return sum(n for (nm, d), n in self._mvms.items()
                   if (name is None or nm == name)
                   and (direction is None or d == direction))

    def energy_pj(self, name: Optional[str] = None,
                  direction: Optional[str] = None) -> float:
        """Cumulative modeled energy: sum over matching entries of
        cost.energy_pj * dispatches — each term one exact float product."""
        return sum(self.entries[k].cost.energy_pj * n
                   for k, n in self._mvms.items()
                   if (name is None or k[0] == name)
                   and (direction is None or k[1] == direction))

    def per_token_pj(self, direction: str = "fwd") -> float:
        """Modeled energy of pushing ONE row through every chip of a
        direction — the per-token serving cost of the whole stack."""
        return sum(e.cost.energy_pj * e.n_stack
                   for e in self.entries.values()
                   if e.direction == direction)

    def tops_per_w(self, name: Optional[str] = None,
                   direction: Optional[str] = None) -> float:
        """Dispatch-weighted TOPS/W over matching entries (ops/pJ)."""
        e_pj = self.energy_pj(name, direction)
        if e_pj == 0.0:
            return 0.0
        ops = sum(self.entries[k].cost.ops * n
                  for k, n in self._mvms.items()
                  if (name is None or k[0] == name)
                  and (direction is None or k[1] == direction))
        return ops / e_pj

    # ------------------------------------------------------------ export

    def report(self) -> dict:
        chips = []
        for key in sorted(self.entries):
            e, n = self.entries[key], self._mvms[key]
            c = e.cost
            chips.append({
                "chip": e.name, "direction": e.direction,
                "rows": e.rows, "cols": e.cols, "n_stack": e.n_stack,
                "partition": e.partition,
                "in_bits": e.in_bits, "out_bits": e.out_bits,
                "pj_per_mvm": c.energy_pj,
                "latency_model_ns": c.latency_ns,
                "tops_per_w": c.tops_per_w,
                "mvm_dispatches": n,
                "energy_pj": c.energy_pj * n,
            })
        return {
            "chips": chips,
            "total_mvm_dispatches": self.mvm_dispatches(),
            "total_energy_pj": self.energy_pj(),
            "per_token_pj": self.per_token_pj(),
            "tops_per_w": self.tops_per_w(),
        }

    def export(self, registry) -> None:
        """Publish meter state into a MetricsRegistry (report boundary)."""
        g_pj = registry.gauge("chip_pj_per_mvm",
                              "modeled energy of one MVM on this chip")
        g_tw = registry.gauge("chip_tops_per_w",
                              "modeled ops/pJ at this operating point")
        c_mvm = registry.counter("chip_mvm_dispatches",
                                 "host-side MVM dispatch count")
        # cumulative energy exports as a GAUGE set to the exact product
        # pj_per_mvm * dispatches: a counter would accumulate float
        # increments and drift off the exact identity above
        g_e = registry.gauge("chip_energy_pj",
                             "cumulative modeled energy (pJ) = "
                             "pj_per_mvm * mvm_dispatches")
        for key in sorted(self.entries):
            e, n = self.entries[key], self._mvms[key]
            lab = {"chip": e.name, "direction": e.direction}
            cost = e.cost
            g_pj.set(cost.energy_pj, **lab)
            g_tw.set(cost.tops_per_w, **lab)
            c_mvm.inc(n - c_mvm.value(**lab), **lab)
            g_e.set(cost.energy_pj * n, **lab)
