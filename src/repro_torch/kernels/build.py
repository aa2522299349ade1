"""Build and load every CUDA kernel of the port.

Each kernel is one CUDA C++ source with a plain C interface, compiled by
nvcc for Hopper (sm_90a) into its own shared library under
`build/kernels/` at first use — every source's nvcc started together — and
loaded with ctypes (no PyTorch headers: a build takes seconds). A library
is named by a hash of its source, the shared headers and the flags, so an
edited source is rebuilt and an unchanged one is reused; ptxas's report
of each build is kept beside its library (`ptxas_log`).

`LAUNCHES` counts each kernel's launches: a wrapper adds one where it
launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
_REPO = _PKG.parents[2]
SOURCES = {
    "cim_mvm_packed": "cim_mvm/csrc/cim_mvm_packed.cu",
    "cim_mvm_scheduled": "cim_mvm/csrc/cim_mvm_scheduled.cu",
    "cim_mvm_transposed": "cim_mvm/csrc/cim_mvm_transposed.cu",
    "cim_mvm": "cim_mvm/csrc/cim_mvm.cu",
    "noisy_matmul": "noisy_matmul/csrc/noisy_matmul.cu",
    "gqa_attention": "attention/csrc/gqa_attention.cu",
}
HEADERS = ("csrc/hash_prng.cuh", "cim_mvm/csrc/cim_epilogue.cuh",
           "cim_mvm/csrc/bulk_copy.cuh", "cim_mvm/csrc/cim_split.cuh",
           "cim_mvm/csrc/cim_dmma.cuh", "cim_mvm/csrc/cim_walk.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(_PKG / "csrc"))
LAUNCHES = {name: 0 for name in SOURCES}   # kernel launches, per kernel
_cdll: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit")
    return path


def build() -> Dict[str, Path]:
    """Compile every source that has no library yet, all nvcc runs started
    together; returns kernel name -> library path."""
    common = b"".join((_PKG / h).read_bytes() for h in HEADERS) \
        + " ".join(NVCC_FLAGS[:-1]).encode()
    out_dir = _REPO / "build" / "kernels"
    libs, procs = {}, {}
    for name, rel in SOURCES.items():
        src = _PKG / rel
        tag = hashlib.sha1(src.read_bytes() + common).hexdigest()[:12]
        libs[name] = lib = out_dir / f"{name}-{tag}.so"
        if lib.exists():
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {SOURCES[name]}:\n{err}")
        else:
            ptxas_log(libs[name]).write_text(err)
            os.replace(tmp, libs[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def ptxas_log(lib: Path) -> Path:
    """Where the build keeps `lib`'s `-Xptxas -v` report (registers,
    spills and shared memory of every kernel it holds)."""
    return lib.with_suffix(".ptxas.txt")


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building every kernel at first
    use."""
    if not _cdll:
        _cdll.update({n: ctypes.CDLL(str(p)) for n, p in build().items()})
    return _cdll[name]
