"""Architecture registry of the port (port of `repro/configs`; the archs
ported so far)."""
from __future__ import annotations

from . import (deepseek_moe_16b, gemma2_9b, llama4_maverick, rwkv6_7b,
               zamba2_7b)
from ..models.transformer import ArchConfig

_MODULES = {
    "gemma2-9b": gemma2_9b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "rwkv6-7b": rwkv6_7b,
    "zamba2-7b": zamba2_7b,
}

ARCH_NAMES = list(_MODULES)


def get(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {ARCH_NAMES})")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG
