"""Noise-resilient training and chip-in-the-loop fine-tuning (PyTorch
port of `repro/train`)."""
from .optimizer import adamw_init, adamw_update, sgdm_init, sgdm_update, \
    cosine_lr, clip_grads  # noqa: F401
