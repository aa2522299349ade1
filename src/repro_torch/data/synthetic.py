"""Synthetic data (PyTorch port of `repro/data/synthetic.py`: LM tokens
and the RBM's binary patterns with their corruptions).

Every draw comes from an explicit `torch.Generator`, on its device; the
reference's jax.random streams are not replayed, so the parity tests hand
both packages the same numpy data instead.
"""
from __future__ import annotations

import torch


def lm_tokens(generator: torch.Generator, batch: int, seq: int, vocab: int):
    """Uniform random token ids (int64, on the generator's device)."""
    return torch.randint(0, vocab, (batch, seq), generator=generator,
                         device=generator.device)


def binary_patterns(generator: torch.Generator, n: int, d: int = 784,
                    rank: int = 12, labels_dim: int = 10,
                    proto_seed: int = 13):
    """Structured binary patterns for the RBM: low-rank Bernoulli logits,
    with a one-hot 'label' block appended (paper: 784 pixels + 10 labels).
    The rank-space prototype comes from its own generator seeded
    `proto_seed`, so sets drawn from different generators share the task.
    Returns (n, d + labels_dim) float32."""
    dev = generator.device
    proto = torch.Generator(dev).manual_seed(proto_seed)
    u = torch.randn((n, rank), generator=generator, device=dev)
    v = torch.randn((rank, d), generator=proto, device=dev) * 2.0
    pix = torch.bernoulli(torch.sigmoid(u @ v), generator=generator)
    lab = torch.nn.functional.one_hot(
        torch.randint(0, labels_dim, (n,), generator=generator, device=dev),
        labels_dim).to(torch.float32)
    return torch.cat([pix, lab], dim=-1)


def corrupt_flip(generator: torch.Generator, v, frac: float = 0.2,
                 pixels: int = 784):
    """Flip a random `frac` of the pixel block to complementary intensity.
    Returns (corrupted v, mask of trusted entries)."""
    flip = (torch.rand(v.shape, generator=generator, device=v.device) < frac) \
        & (torch.arange(v.shape[-1], device=v.device) < pixels)
    return torch.where(flip, 1.0 - v, v), ~flip


def corrupt_occlude(v, frac: float = 1 / 3, pixels: int = 784):
    """Zero the bottom `frac` of the pixel block (occlusion). Returns
    (corrupted v, mask of trusted entries)."""
    cut = int(pixels * (1 - frac))
    idx = torch.arange(v.shape[-1], device=v.device)
    occluded = (idx >= cut) & (idx < pixels)
    return torch.where(occluded, torch.zeros((), device=v.device), v), \
        ~occluded
