"""Noise-injection training matmul: the CUDA kernel (`kernel.py`, `csrc/`),
its entry point (`ops.py`) and a statistical reference (`ref.py`)."""
from .ops import noisy_matmul  # noqa: F401
from .ref import noisy_matmul_ref  # noqa: F401
