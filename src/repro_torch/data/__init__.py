"""Synthetic data of the port."""
from .synthetic import (binary_patterns, corrupt_flip,  # noqa: F401
                        corrupt_occlude, lm_tokens)
