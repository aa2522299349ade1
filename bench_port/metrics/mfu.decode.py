"""mfu.decode: model FLOPs of the tokens the decode steps emitted (each
request's tokens after its first, at their positions) over the engine's
summed decode-step time (its serve_decode_step_s histogram: CUDA events)
times the card's FP64 peak, in %."""
from harness import flops


def read(run):
    if run.decode_s <= 0:
        return None
    work = sum(flops.flops_positions(run.model, len(r.prompt),
                                     len(r.prompt) + len(r.tokens) - 1)
               for r in run.requests if len(r.tokens) > 1)
    peak = flops.peaks(run.device_kind)["fp64_flops"]
    return 100.0 * work / (run.decode_s * peak)
