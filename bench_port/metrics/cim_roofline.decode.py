"""cim_roofline.decode: the least time of the decode steps' CIM products
(every chip-mapped launch of every layer at M = the pool's slots,
`harness/flops.cim_bound`) over the device time of the CIM kernels in
those steps of the profiled window, in %."""
from harness import flops, trace


def read(run):
    w = run.window
    if w is None:
        return None
    steps = [ops for label, _, _, ops in trace.by_range(w)
             if label == "bp.decode" and ops]
    cim = sum(e - s for ops in steps for name, s, e in ops
              if trace.is_cim(name))
    if not steps or cim <= 0:
        return None
    p = flops.peaks(run.device_kind)
    bound = flops.layer_bound_ms(run.model, run.slots, p["hbm_bytes_per_s"],
                                 p["fp64_flops"]) * len(steps)
    return 100.0 * bound * 1e3 / cim
