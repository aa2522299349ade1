"""Fault tolerance of the port (the single-process half of
`repro/distributed`; sharding and elastic resharding wait for ROADMAP
A13)."""
from .fault import FaultTolerantTrainer  # noqa: F401
