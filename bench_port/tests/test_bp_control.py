"""The control, on the card: the plain reference put in the program's
place and computed in TF32 (the step below the configuration's float32
with TF32 off) must come out not correct on every seed, where the
program's own tokens pass. Each configuration at its published widths
with one layer, a short window at the cell's load, three seeds.

    PYTHONPATH=src python -m pytest -q -m cuda bench_port/tests
"""
import copy
import time

import pytest

import bp_smoke  # noqa: F401  (import paths)
from harness import spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["granite20b.chat", "dsmoe16b.chat"])
def test_control_fails_where_the_program_passes(card, workload):
    from harness.serve import run_cell
    cell = spec.cell(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"]["n_layers"] = 1
    for seed in (2147483901, 2147483902, 2147483903):
        line, checks = run_cell(cell, seed, 12.0, trace=False, device=card,
                                t_start=time.perf_counter(), control=True)
        limit = checks["logit_gap"]["limit"]
        assert line["info"]["program_logit_gap"] <= limit, (seed, line)
        assert checks["logit_gap"]["value"] > limit, (seed, checks)
        assert line["correct"] is False, (seed, checks)
