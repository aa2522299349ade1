"""repro_torch.core — NeuRRAM behavioral model and chip compiler (port of
`repro/core`). Every name the reference's package exports is exported
here from the port's module of the same name. The exports load on first
use: the kernels import `core.quant`, and `core.cim` imports the
kernels."""
from __future__ import annotations

import importlib

_EXPORTS = {
    "types": ("CIMConfig", "CoreSpec", "DeviceConfig", "EnergyConfig",
              "NonIdealityConfig"),
    "cim": ("CIMEngine", "CIMLayer", "CompiledChip", "PackedCIMLayer",
            "calibrate_chip", "calibrate_tile_v_decr", "compile_chip",
            "effective_weight", "forward", "pack_chip", "pack_cim_layer",
            "packed_forward", "plan_chip", "program", "program_chip",
            "schedule_chip"),
    "conductance": ("Conductances", "conductances_to_weights",
                    "program_conductances", "weights_to_conductances"),
    "quant": ("dequantize", "pact_quantize", "quantize_to_int"),
    "noise": ("apply_relaxation", "relaxation_sigma", "weight_noise"),
    "writeverify": ("iterative_program", "write_verify"),
    "calibration": ("calibrate_layer", "calibrate_v_decr",
                    "tile_partial_sums"),
    "mapping": ("MatrixReq", "PackedPlan", "Plan", "Tile", "TileSchedule",
                "interleave_assignment", "ir_drop_max_cols", "multicore_mvm",
                "multicore_mvm_packed", "pack_tiles", "pack_tiles_transposed",
                "plan_layers", "schedule_tiles", "transpose_tiles"),
    "energy": ("MVMCost", "PRIOR_ART_EDP", "mvm_cost", "neurram_edp"),
    # DEFAULT_VMEM_BUDGET: the reference's TPU budget has no meaning on
    # the card; the name maps to the Hopper shared-memory limit (verify.py)
    "verify": ("ChipVerifyError", "DEFAULT_VMEM_BUDGET", "check_directions",
               "check_packed", "check_plan", "check_schedule", "verify_chip",
               "verify_deployed"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name: str):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_WHERE[name]}", __name__), name)
