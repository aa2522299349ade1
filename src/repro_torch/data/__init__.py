"""Synthetic data of the port."""
from .synthetic import (binary_patterns, cluster_images,  # noqa: F401
                        compose_images, compose_mfcc, corrupt_flip,
                        corrupt_occlude, keyword_mfcc, lm_tokens, Traffic,
                        traffic_requests)
