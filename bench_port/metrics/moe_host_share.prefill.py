"""moe_host_share.prefill: the % of the prefill chunks' host time spent in
the MoE FFN: over the program's serve.prefill spans in the profiled
window, the summed moe.router, moe.dispatch, moe.experts, moe.combine
and moe.shared spans inside them over the spans less their
serve.prefill.wait child (the engine's wait for the chunk's end event),
`harness/spans.moe_host_share`. A share, not milliseconds: the profiler
slows the chunk's launches, and the share reads the same with it and
without it."""
from harness import spans


def read(run):
    return spans.moe_host_share(spans.program_spans())
