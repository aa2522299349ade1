"""glue_device_ms.decode: device ms, per decode step in the profiled
window, of every kernel the port's CUDA library did not build (norms,
RoPE, attention, the MoE router, dispatch and combine, quantize and
rescale, the unembed)."""
from harness import trace


def read(run):
    w = run.window
    if w is None:
        return None
    steps = [ops for label, _, _, ops in trace.by_range(w)
             if label == "bp.decode" and ops]
    if not steps:
        return None
    glue = sum(e - s for ops in steps for name, s, e in ops
               if trace.is_kernel(name) and not trace.is_cim(name))
    return glue / 1e3 / len(steps)
