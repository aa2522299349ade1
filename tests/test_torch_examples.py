"""The four examples as PyTorch scripts (`repro_torch/examples/`): each runs
on the CPU and prints the reference's lines (`examples/*.py`).

The reference's lines are read from its scripts' print calls: literal text
exactly, each formatted value as any text (the numbers come from other
random streams). Every line a port script prints must be one of them, and
every one of them must be printed. The RBM's L2 error must fall under both
corruptions.
"""
import ast
import contextlib
import importlib
import io
import re
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "lm_cim_serving", "image_recovery_rbm",
            "train_cnn_noisy")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the scripts' small eager ops run faster alone
    than split over threads shared with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pattern(node) -> str:
    """A regex for one print argument: literal text escaped, each
    formatted value any text."""
    if isinstance(node, ast.Constant):
        return re.escape(str(node.value))
    if isinstance(node, ast.JoinedStr):
        return "".join(_pattern(v) for v in node.values)
    if isinstance(node, ast.FormattedValue):
        return ".+?"
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _pattern(node.left) + _pattern(node.right)
    raise ValueError(f"unexpected print argument {ast.dump(node)}")


def _reference_lines(name):
    tree = ast.parse((REPO / "examples" / f"{name}.py").read_text())
    return [re.compile(" ".join(_pattern(a) for a in node.args))
            for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "id", "")
            == "print"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_the_reference_lines(name):
    module = importlib.import_module(f"repro_torch.examples.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main(["--device", "cpu"])
    lines = out.getvalue().splitlines()
    patterns = _reference_lines(name)
    assert lines and patterns
    for line in lines:
        assert any(p.fullmatch(line) for p in patterns), line
    for p in patterns:
        assert any(p.fullmatch(line) for line in lines), p.pattern
    if name == "image_recovery_rbm":
        errs = [re.search(r"L2 error ([0-9.]+) -> ([0-9.]+)", line)
                for line in lines]
        errs = [(float(m[1]), float(m[2])) for m in errs if m]
        assert len(errs) == 2
        assert all(after < before for before, after in errs), errs
