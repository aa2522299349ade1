"""Synthetic data of the port."""
from .synthetic import (binary_patterns, cluster_images,  # noqa: F401
                        compose_images, corrupt_flip, corrupt_occlude,
                        lm_tokens, Traffic, traffic_requests)
