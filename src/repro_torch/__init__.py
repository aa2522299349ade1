"""PyTorch + CUDA port of the NeuRRAM reproduction (`repro`, JAX + Pallas).

Mirrors `src/repro/` path for path; `repro_torch/core/cim.py` answers to
`repro/core/cim.py`, and so on. The package imports torch and numpy only.
Hand-written Hopper kernels live under `kernels/` and are built with nvcc
at first use on a CUDA device.
"""
