"""Port of the reference's 2-process replication parity test
(tests/test_distributed.py::test_two_process_replica_parity): the serve
CLI launched as a 2-rank group through `launch/env.launch` (gloo over a
localhost store) against the same command run solo, on the CPU.

Each rank deploys the same chips from the shared seeds, builds the same
seeded request stream, serves the requests `distributed.route_requests`
assigns it and writes them (`--results-out`); rank 0 gathers the ranks'
summaries and metrics through the group's store and writes the merged
files. The contract: the ranks' request ids partition the stream as the
router says, and every request's greedy tokens and logits equal the solo
run's bit for bit (the reference holds the logits' md5 equal). A replica
batches a request with other neighbours than the solo run does, but no
row's arithmetic depends on its neighbours: the pool's decode step always
runs every slot (one captured shape), a prompt prefills alone in its
slot in chunks of the same length, and the sums that could reorder with
the batch (RMSNorm, attention's dot products, the MoE router) run in
float64 and round once (ROADMAP C2/C3).
"""
import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch import env as tenv
from repro_torch.launch.distributed import route_requests

REPO = Path(__file__).resolve().parents[1]
N_REQ = 6


def _cmd(out_dir: Path, tag: str):
    return [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
            "--cim", "--device", "cpu", "--traffic", "--requests",
            str(N_REQ), "--slots", "2", "--chunk", "16", "--prompt-len",
            "48", "--gen", "6", "--rate", "100",
            "--results-out", str(out_dir / f"{tag}_{{rank}}.npz"),
            "--summary-out", str(out_dir / f"{tag}_summary.json"),
            "--metrics-out", str(out_dir / f"{tag}_metrics.json"),
            "--trace-out", str(out_dir / f"{tag}_trace.json")]


def _run(cmd, n):
    env = {"PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    results = tenv.launch(cmd, num_processes=n, timeout=600, extra_env=env)
    for rank, r in enumerate(results):
        assert r.returncode == 0, (rank, (r.stderr or "")[-4000:])
    return results


def _load(path):
    z = np.load(path)
    return int(z["rank"]), int(z["n_ranks"]), {
        int(rid): (z[f"tokens_{rid}"], z[f"logits_{rid}"])
        for rid in z["rids"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("replicas")
    solo = _run(_cmd(out, "solo"), 1)
    ranks = _run(_cmd(out, "group"), 2)
    return out, solo, ranks


def test_two_process_replica_parity(runs):
    out, _, _ = runs
    _, n_solo, ref = _load(out / "solo_0.npz")
    assert n_solo == 1 and sorted(ref) == list(range(N_REQ))
    served = []
    fake = [types.SimpleNamespace(rid=i) for i in range(N_REQ)]
    for rank in range(2):
        r, n, got = _load(out / f"group_{rank}.npz")
        assert (r, n) == (rank, 2)
        assert sorted(got) == [q.rid for q in route_requests(fake, 2, rank)]
        for rid, (toks, logits) in got.items():
            assert toks.tolist() == ref[rid][0].tolist(), rid
            np.testing.assert_array_equal(logits, ref[rid][1],
                                          err_msg=str(rid))
        served += list(got)
    assert sorted(served) == list(range(N_REQ))   # exactly once each


def test_rank0_writes_the_merged_summary(runs):
    out, _, ranks = runs
    s = json.loads((out / "group_summary.json").read_text())
    assert s["ranks"] == 2 and s["requests"] == N_REQ
    assert s["decode_traces"] == 1
    assert sorted(r for rids in s["rids_per_rank"] for r in rids) == \
        list(range(N_REQ))
    assert s["mesh_shape"] == {"data": 2, "model": 1}
    m = json.loads((out / "group_metrics.json").read_text())
    ranks_seen = {e["labels"].get("rank") for e in m["counters"]}
    assert ranks_seen == {"0", "1"}
    assert "fleet[2 replicas]" in ranks[0].stdout
    assert "fleet[" not in ranks[1].stdout
    solo = json.loads((out / "solo_summary.json").read_text())
    assert solo["requests"] == N_REQ and "ranks" not in solo


@pytest.mark.parametrize("tag,ranks", [("solo", 0), ("group", 2)])
def test_exports_pass_check_obs(runs, tag, ranks):
    """tools/check_obs.py, run as it is, on the solo run's exports and on
    rank 0's merged 2-rank metrics (--expect-ranks 2): the metrics schema,
    the one-decode-compilation contract per rank, exact chip-energy
    reconciliation per series, and the trace schema."""
    import subprocess
    out, _, _ = runs
    cmd = [sys.executable, str(REPO / "tools" / "check_obs.py"),
           "--metrics", str(out / f"{tag}_metrics.json"),
           "--trace", str(out / f"{tag}_trace.json")]
    if ranks:
        cmd += ["--expect-ranks", str(ranks)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "chip series reconcile exactly" in proc.stdout
    assert "decode trace contract holds" in proc.stdout
