"""Sharding rules, fault tolerance and elastic resharding of the port
(port of `repro/distributed`)."""
from .fault import FaultTolerantTrainer, elastic_reshard  # noqa: F401
from .sharding import (batch_pspecs, cache_pspecs, named_shardings,  # noqa: F401
                       param_pspecs)
