"""Multi-process scale-out: data-parallel replicas of whole compiled chips
(PyTorch port of `repro/launch/distributed.py`).

Serving heavy traffic means replicating whole compiled chip stacks, not
building one bigger chip. This module is that replication layer:

  * `initialize` joins the process group named by the REPRO_* vars that
    `launch/env.runtime_env` sets: `torch.distributed.init_process_group`
    with the gloo backend over a TCPStore at `REPRO_COORDINATOR` (rank 0
    hosts it). Gloo is enough: replicas exchange only JSON, through the
    store.
  * `serving_mesh` is this process's (data, model) Mesh over its OWN
    local devices (`launch/mesh.mesh_shape_for` applied to the local
    count). The fleet's logical mesh is (process_count * local_data) x
    model (`global_mesh_shape`), but nothing spans processes: each rank
    holds its own engine and chips, and no collective runs on the serving
    path.
  * `route_requests` is the admission router: every rank builds the same
    seeded request stream and serves the deterministic subset the policy
    assigns it — round-robin by rid (the default) or a multiplicative rid
    hash (stateless sticky routing).
  * `merge_summaries` and `gather_json` implement the rank-0 reporting
    contract: every rank publishes its summary and rank-tagged metrics
    through the group's store; rank 0 merges them and writes the one set
    of output files. Per-rank invariants (one decode capture) are
    asserted per rank before the gather.

Outside a group `initialize` returns False and everything degrades to the
one-replica case, so the entry points call these helpers
unconditionally.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from . import env as _env
from .mesh import Mesh, local_devices, mesh_shape_for

_STORE = None          # the group's TCPStore once `initialize` has joined


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = 300.0) -> bool:
    """Join the process group if this rank belongs to one. Explicit args
    win; otherwise the REPRO_* env vars (launch/env) decide. Returns True
    iff a multi-process group is active afterwards."""
    global _STORE
    if num_processes is None:
        spec = _env.from_env()
        if spec is None:
            return _STORE is not None
        coordinator, num_processes, process_id = spec
    if num_processes <= 1:
        return False
    if _STORE is not None:
        return True
    import atexit
    import datetime

    import torch.distributed as dist
    host, port = coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    atexit.register(dist.destroy_process_group)
    _STORE = store
    return True


def process_info() -> Tuple[int, int]:
    """(rank, process_count): (0, 1) outside any group."""
    if _STORE is None:
        return 0, 1
    import torch.distributed as dist
    return dist.get_rank(), dist.get_world_size()


def serving_mesh(max_model: int = 16, device_type: str = "cuda") -> Mesh:
    """This process's replica Mesh: ('data', 'model') over its LOCAL
    devices, factored by `launch/mesh.mesh_shape_for`. The cross-process
    data axis is process replication (`global_mesh_shape`)."""
    devs = local_devices(device_type)
    return Mesh.over(devs, mesh_shape_for(len(devs), max_model))


def global_mesh_shape(max_model: int = 16,
                      device_type: str = "cuda") -> Dict[str, int]:
    """The logical DxM shape of the whole serving fleet:
    {'data': process_count * local_data, 'model': local_model}."""
    local = mesh_shape_for(len(local_devices(device_type)), max_model)
    _, n_proc = process_info()
    return {"data": n_proc * local["data"], "model": local["model"]}


# ----------------------------------------------------------- routing

def _rid_hash(rid: int) -> int:
    # Knuth multiplicative hash: stateless, stable across runs and ranks
    return (int(rid) * 2654435761) & 0xFFFFFFFF


def route_requests(requests: Sequence, n_replicas: int, replica: int,
                   policy: str = "round_robin") -> list:
    """The deterministic subset of `requests` this replica serves. Every
    rank evaluates it over the SAME full stream, so the subsets partition
    the stream exactly. Requests keep their arrival times: the open-loop
    schedule is a property of the stream, not of the router."""
    if n_replicas < 1 or not 0 <= replica < n_replicas:
        raise ValueError(f"replica {replica} outside [0, {n_replicas})")
    if n_replicas == 1:
        return list(requests)
    if policy == "round_robin":
        return [r for r in requests if r.rid % n_replicas == replica]
    if policy == "hash":
        return [r for r in requests
                if _rid_hash(r.rid) % n_replicas == replica]
    raise ValueError(f"unknown routing policy {policy!r} "
                     "(round_robin | hash)")


# ------------------------------------------------- rank-0 aggregation

def merge_summaries(summaries: Sequence[dict]) -> dict:
    """One fleet summary from per-rank engine summaries
    (`launch/scheduler.ContinuousBatchingEngine.run`'s stats).

    Requests, tokens, energy and dispatches sum; wall is the slowest rank
    (replicas run concurrently); tok_per_s = total tokens / that wall;
    pj_per_token = total energy / total tokens. Quantiles do not merge
    exactly: p50 and TTFT are token-weighted means and p99 the worst
    rank's. decode_traces is the max across ranks, so the == 1 contract
    reads the same on the merged dict; the per-rank breakdown rides
    along."""
    if not summaries:
        raise ValueError("merge_summaries needs at least one summary")
    tokens = sum(s["tokens"] for s in summaries)
    energy = sum(s.get("energy_pj", 0.0) for s in summaries)
    mvms = sum(s.get("mvm_dispatches", 0) for s in summaries)
    wall = max(s["wall_s"] for s in summaries)

    def _wmean(key):
        num = sum(s[key] * s["tokens"] for s in summaries)
        return num / tokens if tokens else 0.0

    util = (sum(s.get("utilization", 0.0) * s.get("mvm_dispatches", 0)
                for s in summaries) / mvms) if mvms else 0.0
    tops = (sum(s.get("tops_per_w", 0.0) * s.get("energy_pj", 0.0)
                for s in summaries) / energy) if energy else 0.0
    return {
        "ranks": len(summaries),
        "requests": sum(s["requests"] for s in summaries),
        "tokens": tokens,
        "wall_s": wall,
        "tok_per_s": tokens / wall if wall else 0.0,
        "p50_ms": _wmean("p50_ms"),
        "p99_ms": max(s["p99_ms"] for s in summaries),
        "ttft_p50_ms": _wmean("ttft_p50_ms"),
        "decode_traces": max(s["decode_traces"] for s in summaries),
        "mvm_dispatches": mvms,
        "energy_pj": energy,
        "pj_per_token": energy / tokens if tokens else 0.0,
        "tops_per_w": tops,
        "utilization": util,
        "per_rank": [{k: s[k] for k in
                      ("requests", "tokens", "wall_s", "tok_per_s",
                       "p50_ms", "p99_ms", "ttft_p50_ms",
                       "decode_traces") if k in s}
                     for s in summaries],
    }


def gather_json(tag: str, payload: dict, timeout_s: float = 300.0
                ) -> Optional[List[dict]]:
    """All ranks -> rank 0 gather of one JSON document per rank through
    the group's store. Every rank calls it with its payload; rank 0
    returns the rank-ordered list, every other rank None (only rank 0
    writes output files). `tag` namespaces the keys: use one per gather
    point."""
    import datetime
    rank, n_proc = process_info()
    if n_proc == 1:
        return [payload] if rank == 0 else None
    _STORE.set(f"repro/{tag}/{rank}", json.dumps(payload))
    if rank != 0:
        return None
    _STORE.set_timeout(datetime.timedelta(seconds=timeout_s))
    return [json.loads(_STORE.get(f"repro/{tag}/{r}"))
            for r in range(n_proc)]
