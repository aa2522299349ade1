"""Synthetic data (PyTorch port of `repro/data/synthetic.py`, LM tokens)."""
from __future__ import annotations

import torch


def lm_tokens(generator: torch.Generator, batch: int, seq: int, vocab: int):
    """Uniform random token ids (int64, on the generator's device)."""
    return torch.randint(0, vocab, (batch, seq), generator=generator,
                         device=generator.device)
