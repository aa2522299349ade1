"""The PyTorch port stands alone: no module of `src/repro_torch/` and not
`chip_smoke.py` imports JAX or the JAX package, and the package imports
in a process with neither `triton` nor `nvcc` on hand (kernels are built
at first use, inside the function that launches them)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_module_imports_no_jax(path):
    bad = sorted({r for r in _imported_roots(path)
                  if r in ("jax", "jaxlib", "repro")})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_imports_without_triton_or_nvcc():
    """Every module of the package imports with `triton` unimportable and
    no nvcc on PATH, and no kernel library is built by importing."""
    mods = sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (REPO / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"      # import triton -> ImportError
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.kernels import build\n"
        "from repro_torch.kernels.cim_mvm import kernel\n"
        "from repro_torch.kernels.noisy_matmul import kernel as nk\n"
        "assert not build._cdll and not kernel._lib and nk._lib is None\n"
        "assert sorted(build.LAUNCHES) == sorted(build.SOURCES)\n"
        "assert not any(build.LAUNCHES.values())\n"
        "assert not any(m.startswith(('jax', 'repro.')) or m == 'repro'"
        " for m in sys.modules), 'JAX loaded'\n")
    env = dict(os.environ, PATH="/usr/bin:/bin",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


REFERENCE_INITS = ("core", "distributed", "kernels/cim_mvm",
                   "kernels/noisy_matmul")


def _reference_exports(pkg):
    """The names the reference package's __init__ imports (its exports)."""
    tree = ast.parse((REPO / "src" / "repro" / pkg / "__init__.py")
                     .read_text())
    return sorted(a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) for a in node.names)


@pytest.mark.parametrize("pkg", REFERENCE_INITS)
def test_port_exports_every_reference_name(pkg):
    """Every name the reference's core, distributed, kernels.cim_mvm and
    kernels.noisy_matmul export resolves from the port's package."""
    import importlib
    mod = importlib.import_module("repro_torch." + pkg.replace("/", "."))
    names = _reference_exports(pkg)
    assert names
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, f"repro_torch.{pkg} lacks {missing}"


def test_every_reference_module_has_a_counterpart():
    """Path for path, save `obs/jitwatch.py`, whose counterpart is
    `obs/capturewatch.py`."""
    ref = REPO / "src" / "repro"
    missing = [str(p.relative_to(ref)) for p in sorted(ref.rglob("*.py"))
               if not (REPO / "src" / "repro_torch" / p.relative_to(ref))
               .exists()]
    assert missing == ["obs/jitwatch.py"]
    assert (REPO / "src" / "repro_torch" / "obs" / "capturewatch.py").exists()


def test_dequantize_matches_reference():
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.core.quant import dequantize as jdeq, quantize_to_int as jq
    from repro_torch.core import dequantize, quantize_to_int
    from repro_torch.core.verify import DEFAULT_VMEM_BUDGET
    from repro_torch.kernels.cim_mvm.kernel import SMEM_LIMIT
    x = np.random.default_rng(0).normal(0, 1.5, (6, 37)).astype(np.float32)
    for bits, signed in ((4, True), (8, True), (3, False)):
        xi_j, s_j = jq(jnp.asarray(x), 2.0, bits, signed=signed)
        xi_t, s_t = quantize_to_int(torch.from_numpy(x), 2.0, bits,
                                    signed=signed)
        np.testing.assert_array_equal(xi_t.numpy(), np.asarray(xi_j))
        got = dequantize(xi_t, s_t)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jdeq(xi_j, s_j)))
    assert DEFAULT_VMEM_BUDGET == SMEM_LIMIT
