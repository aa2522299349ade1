"""Sharding rules, fault tolerance and elastic resharding of the port
(port of `repro/distributed`)."""
from .fault import FaultTolerantTrainer, elastic_reshard  # noqa: F401
