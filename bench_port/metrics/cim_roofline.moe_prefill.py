"""cim_roofline.moe_prefill: the least time of the MoE prefill chunks' CIM
products over the device time of the CIM kernels in those chunks of the
profiled window, in %.

The least time (`harness/flops.cim_bound`) of each chunk's launches: the
attention and shared-expert projections at the chunk's rows, and each
routed expert's three at the rows routed to it in that layer (the
program's routed-rows counter, the args of its moe.experts spans; an
expert with no rows costs nothing). The chunks are the bp.prefill ranges
whose serve.prefill span aligns with them (`harness/spans.chunks`)."""
from harness import flops, spans, trace


def read(run):
    w = run.window
    if w is None:
        return None
    p = flops.peaks(run.device_kind)
    hbm, fp64 = p["hbm_bytes_per_s"], p["fp64_flops"]
    bound_ms = cim_us = 0.0
    for rows, layers, ops in spans.chunks(w, spans.program_spans()):
        for name, r, c, n in flops.projections(run.model):
            if name.startswith("ew_"):
                bound_ms += sum(flops.cim_bound(r, c, k, hbm, fp64)[0]
                                for routed in layers for k in routed if k)
            else:
                bound_ms += flops.cim_bound(r, c, rows, hbm, fp64)[0] \
                    * n * len(layers)
        cim_us += sum(e - s for name, s, e in ops if trace.is_cim(name))
    return 100.0 * bound_ms * 1e3 / cim_us if cim_us > 0 else None
