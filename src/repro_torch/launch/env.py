"""Runtime-config surface for single- and multi-process launches (PyTorch
port of `repro/launch/env.py`).

The multi-process contract is three env vars, read back by
`launch/distributed.initialize` before the process touches a device:

    REPRO_COORDINATOR    host:port of rank 0's store (the group's rendezvous)
    REPRO_NUM_PROCESSES  process (replica-group) count
    REPRO_PROCESS_ID     this process's rank in [0, NUM_PROCESSES)

`launch` spawns N ranks of an arbitrary command with those vars set
(concurrently by default — the group's rendezvous waits for every rank —
or sequentially for solo replicas that skip group init), and the module
doubles as a CLI launcher:

    PYTHONPATH=src python -m repro_torch.launch.env --procs 2 \
        -- python -m repro_torch.launch.serve --smoke --cim --traffic ...

Everything after `--` is the per-rank command. The reference also forces
XLA host-platform devices per rank (`xla_flags`, `--host-devices`); a
PyTorch process has no such setting — its devices are the cards it sees,
and a mesh may repeat a device (`launch/mesh.Mesh`) — so there is no
counterpart, and `--host-devices` raises rather than being ignored.
This module never imports torch: the parent stays device-free, so the
children own their devices.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"

DEFAULT_COORD_PORT = 46223


def runtime_env(*, num_processes: int = 1, process_id: int = 0,
                coordinator: Optional[str] = None,
                base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """One rank's full process environment (a copy: the parent's is never
    changed). Sets the three REPRO_* vars only for a real multi-process
    group and strips them otherwise, so a solo rank inheriting a
    launcher's environment cannot re-join a group by accident."""
    env = dict(base if base is not None else os.environ)
    if num_processes > 1:
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} outside "
                             f"[0, {num_processes})")
        env[ENV_COORDINATOR] = coordinator or \
            f"localhost:{DEFAULT_COORD_PORT}"
        env[ENV_NUM_PROCESSES] = str(num_processes)
        env[ENV_PROCESS_ID] = str(process_id)
    else:
        for k in (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID):
            env.pop(k, None)
    return env


def from_env(environ: Optional[Dict[str, str]] = None
             ) -> Optional[Tuple[str, int, int]]:
    """(coordinator, num_processes, process_id) from the REPRO_* vars, or
    None when this process was not launched as part of a group. A partial
    set raises: a half-configured rank would otherwise serve solo while
    its peers wait for it."""
    env = os.environ if environ is None else environ
    vals = [env.get(k) for k in (ENV_COORDINATOR, ENV_NUM_PROCESSES,
                                 ENV_PROCESS_ID)]
    if all(v is None for v in vals):
        return None
    if any(v is None for v in vals):
        raise RuntimeError(
            f"partial multi-process environment: need all of "
            f"{ENV_COORDINATOR}/{ENV_NUM_PROCESSES}/{ENV_PROCESS_ID}, "
            f"got {vals}")
    coord, n, pid = vals
    n, pid = int(n), int(pid)
    if n < 1 or not 0 <= pid < n:
        raise RuntimeError(f"bad multi-process environment: "
                           f"num_processes={n} process_id={pid}")
    return coord, n, pid


def free_port() -> int:
    """An OS-assigned free TCP port for a localhost coordinator (a fixed
    port collides when runs follow each other and the last socket lingers
    in TIME_WAIT)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cmd: Sequence[str], *, num_processes: int,
           coordinator: Optional[str] = None, sequential: bool = False,
           timeout: Optional[float] = None,
           extra_env: Optional[Dict[str, str]] = None
           ) -> List[subprocess.CompletedProcess]:
    """Run `cmd` as an N-rank group, one subprocess per rank, each with
    `runtime_env(...)`. Concurrent by default (the group's rendezvous
    waits for every rank); `sequential=True` runs rank after rank WITHOUT
    the coordination vars: N independent solo replicas. Captures each
    rank's stdout / stderr and returns a CompletedProcess per rank in rank
    order (check .returncode yourself: a failed rank must not kill the
    parent before its peers are collected). On a timeout every rank is
    killed and waited for before TimeoutExpired is raised."""
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    solo = sequential or num_processes == 1
    if not solo and coordinator is None:
        coordinator = f"localhost:{free_port()}"
    envs = [runtime_env(num_processes=1 if solo else num_processes,
                        process_id=0 if solo else r, coordinator=coordinator)
            for r in range(num_processes)]
    if extra_env:
        for e in envs:
            e.update(extra_env)
    if solo:
        return [subprocess.run(list(cmd), env=e, capture_output=True,
                               text=True, timeout=timeout) for e in envs]
    procs = [subprocess.Popen(list(cmd), env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for e in envs]
    done = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            raise
        done.append(subprocess.CompletedProcess(list(cmd), p.returncode,
                                                out, err))
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="launch N ranks of a command as one process group "
                    "(everything after -- is the rank command)")
    ap.add_argument("--procs", type=int, default=2,
                    help="rank count (the replica-group size)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="the reference's XLA host-device forcing; no "
                         "PyTorch counterpart (raises when set)")
    ap.add_argument("--port", type=int, default=0,
                    help="coordinator port on localhost (0 = a free one)")
    ap.add_argument("--sequential", action="store_true",
                    help="run ranks one after another as solo replicas "
                         "(no group init) instead of concurrently")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="per-group timeout in seconds (0 = none)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- then the per-rank command")
    args = ap.parse_args(argv)
    if args.host_devices:
        ap.error("--host-devices forces XLA host devices, which a PyTorch "
                 "process has no counterpart of (a mesh may repeat a "
                 "device instead: launch/mesh.Mesh)")
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no rank command given (append: -- python -m ...)")
    coord = f"localhost:{args.port}" if args.port else None
    results = launch(cmd, num_processes=args.procs, coordinator=coord,
                     sequential=args.sequential,
                     timeout=args.timeout or None)
    status = 0
    for rank, r in enumerate(results):
        for stream, text in (("stdout", r.stdout), ("stderr", r.stderr)):
            for line in (text or "").splitlines():
                print(f"[rank {rank} {stream}] {line}")
        if r.returncode != 0:
            print(f"[rank {rank}] exited {r.returncode}", file=sys.stderr)
            status = r.returncode
    return status


if __name__ == "__main__":
    raise SystemExit(main())
