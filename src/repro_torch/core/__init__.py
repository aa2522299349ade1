"""repro_torch.core — NeuRRAM behavioral model and chip compiler (port of
`repro/core`). The chip compiler's entry points and `CIMEngine` are
exported here, as the reference exports them; the rest lives in the
submodules (`core.cim`, `core.mapping`, ...). The exports load on first
use: the kernels import `core.quant`, and `core.cim` imports the
kernels."""
from __future__ import annotations

import importlib

_EXPORTS = {
    "types": ("CIMConfig", "CoreSpec", "DeviceConfig", "EnergyConfig",
              "NonIdealityConfig"),
    "cim": ("CIMEngine", "CIMLayer", "CompiledChip", "PackedCIMLayer",
            "calibrate_chip", "compile_chip", "pack_chip", "packed_forward",
            "plan_chip", "program_chip", "schedule_chip"),
    "mapping": ("MatrixReq", "PackedPlan", "Plan", "Tile", "multicore_mvm",
                "multicore_mvm_packed"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name: str):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_WHERE[name]}", __name__), name)
