"""cim_roofline.prefill: the least time of the prefill chunks' CIM
products (every chip-mapped launch of every layer at M = the chunk's
rows, `harness/flops.cim_bound`) over the device time of the CIM kernels
in those chunks of the profiled window, in %."""
from harness import flops, trace


def read(run):
    w = run.window
    if w is None:
        return None
    p = flops.peaks(run.device_kind)
    bound = cim = 0.0
    for label, _, _, ops in trace.by_range(w):
        if not label.startswith("bp.prefill:") or not ops:
            continue
        rows = int(label.split(":")[1])
        bound += flops.layer_bound_ms(run.model, rows, p["hbm_bytes_per_s"],
                                      p["fp64_flops"]) * 1e3
        cim += sum(e - s for name, s, e in ops if trace.is_cim(name))
    return 100.0 * bound / cim if cim > 0 else None
