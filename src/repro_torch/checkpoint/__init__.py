"""Atomic, async checkpointing of the port (port of `repro/checkpoint`)."""
from .checkpoint import (AsyncCheckpointer, latest_step,  # noqa: F401
                         restore_checkpoint, save_checkpoint)
