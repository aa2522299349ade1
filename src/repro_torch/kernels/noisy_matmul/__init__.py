"""Noise-injection training matmul: the CUDA kernel (`kernel.py`, `csrc/`),
its entry point (`ops.py`) and a statistical reference (`ref.py`)."""
