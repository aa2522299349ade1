"""Synthetic data of the port."""
from .synthetic import lm_tokens  # noqa: F401
