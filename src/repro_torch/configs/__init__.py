"""Architecture registry of the port (port of `repro/configs`): the
reference's ten archs under its names. Its shape cells and input specs
serve the reference's dry run, which is not ported."""
from __future__ import annotations

from . import (codeqwen15_7b, deepseek_moe_16b, gemma2_9b, granite_20b,
               internvl2_1b, llama4_maverick, qwen2_72b, rwkv6_7b,
               seamless_m4t_medium, zamba2_7b)
from ..models.transformer import ArchConfig

_MODULES = {
    "qwen2-72b": qwen2_72b,
    "codeqwen1.5-7b": codeqwen15_7b,
    "granite-20b": granite_20b,
    "gemma2-9b": gemma2_9b,
    "rwkv6-7b": rwkv6_7b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "seamless-m4t-medium": seamless_m4t_medium,
    "internvl2-1b": internvl2_1b,
    "zamba2-7b": zamba2_7b,
}

ARCH_NAMES = list(_MODULES)


def get(name: str, smoke: bool = False) -> ArchConfig:
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG
