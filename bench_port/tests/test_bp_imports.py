"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's);
the reference imports nothing of the program; run.py refuses to run
without a card and prints no result."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

import bp_smoke

BENCH = bp_smoke.BENCH
RUN = [sys.executable, str(BENCH / "run.py"), "--workload",
       "granite20b.chat", "--seed", "2147483650", "--seconds", "1",
       "--trace", "0"]


def test_forbidden_names_compare_whole(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "jaxlib.x", object())
    assert run.loaded_forbidden() == ["jaxlib", "repro"]


def test_a_smoke_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import bp_smoke; "
            "bp_smoke.run_smoke('dsmoe16b.chat'); "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'repro'}))"
            % str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert set(_imports(path)) <= {"__future__", "contextlib", "math",
                                       "typing", "torch"}, path


def test_no_result_without_a_card():
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal")
    out = subprocess.run(RUN, capture_output=True, text=True, timeout=120,
                         cwd=BENCH.parent)
    assert out.returncode != 0 and out.stdout == ""


def test_configuration_files_match_the_program():
    """Each file states the program's registered arch at its published
    widths; only the depth is cut."""
    from harness import spec
    from repro_torch import configs
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for conf in bench["configs"]:
        m = spec.load_json(BENCH.parent / conf["file"])["model"]
        reg = configs.get(m["arch"])
        for k in ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
                  "n_experts", "top_k", "n_shared_experts", "d_expert"):
            assert getattr(reg, k) == m[k], (conf["name"], k)
        assert reg.head_dim == m["head_dim"]
        assert m["n_layers"] < reg.n_layers
