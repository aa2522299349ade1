"""mfu.prefill: model FLOPs of every prompt token over the engine's summed
prefill-chunk time (its serve_prefill_chunk_s histogram: CUDA events)
times the card's FP64 peak, in %."""
from harness import flops


def read(run):
    if run.prefill_s <= 0:
        return None
    work = sum(flops.flops_positions(run.model, 0, len(r.prompt))
               for r in run.requests)
    peak = flops.peaks(run.device_kind)["fp64_flops"]
    return 100.0 * work / (run.prefill_s * peak)
