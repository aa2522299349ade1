"""Architecture registry of the port (port of `repro/configs`; the archs
ported so far)."""
from __future__ import annotations

from . import gemma2_9b
from ..models.transformer import ArchConfig

_MODULES = {
    "gemma2-9b": gemma2_9b,
}

ARCH_NAMES = list(_MODULES)


def get(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {ARCH_NAMES})")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG
