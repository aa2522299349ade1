"""Where a cell's device-idle time goes, by the program's host spans, and
what the spans cost: one run of a cell, outside the measured benchmark.

    python3 bench_port/trace_report.py --workload dsmoe16b.chat \
        --seed 7 --seconds 51 --trace 1

--trace 1: the run as `run.py --trace 1` makes it (the profiled window
inside the served traffic), then one JSON line: the cell's per-layer
metrics; `harness/spans.report` (the fitted offset between the
program's spans and the profiler's ranges, the device-idle time inside
the bp.prefill / bp.decode ranges by the innermost program span open,
the longest idle gaps by the span open at their start); and the mean
CUDA-event seconds of the engine's chunks and steps inside the window
(the `device_s` of its serve.prefill / serve.decode spans) against those
outside it (the engine's histograms less the window's).

--trace 0 --handed 1: the untraced run with a trace buffer handed to
every engine (the program's spans on, no profiler), printing the
end-to-end metrics, the mean chunk and step seconds, and the host-span
readings of the whole run with no profiler attached (`host_ms` of its
chunks and steps, `moe_host_ms` and `moe_host_share` of its chunks): the
host milliseconds the profiled window inflates; with --handed 0 the same
line of a plain run. The pair is the spans' own cost.

Nothing here is compared for `correct`: the sample check is left out.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

T_START = time.perf_counter()

import run as bench_run  # noqa: E402


def _means(run) -> dict:
    return {"prefill_chunk_s": run.prefill_s / max(run.prefill_chunks, 1),
            "decode_step_s": run.decode_s / max(run.decode_steps, 1),
            "prefill_chunks": run.prefill_chunks,
            "decode_steps": run.decode_steps}


def _inside_outside(run, spans_all) -> dict:
    """Mean device seconds of the engine's calls inside the profiled
    window (their spans' device_s) and outside it (the rest)."""
    out = {}
    for call, total, n in (("serve.prefill", run.prefill_s,
                            run.prefill_chunks),
                           ("serve.decode", run.decode_s, run.decode_steps)):
        inn = [s.args["device_s"] for s in spans_all
               if s.name == call and "device_s" in s.args]
        rest = n - len(inn)
        out[call] = {
            "inside_n": len(inn),
            "inside_mean_s": sum(inn) / len(inn) if inn else None,
            "outside_n": rest,
            "outside_mean_s": (total - sum(inn)) / rest if rest else None}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--handed", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench_run._env()
    import torch
    from harness import serve, spans, spec
    from repro_torch.launch import scheduler
    from repro_torch.obs import TraceBuffer

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    # `serve_cell` makes its engine itself: a handed buffer goes in through
    # the engine class it looks up, for this run only
    handed, base = [], scheduler.ContinuousBatchingEngine

    class Handed(base):
        def __init__(self, *a, **kw):
            handed.append(TraceBuffer())
            super().__init__(*a, trace=handed[-1], **kw)

    if args.handed:
        scheduler.ContinuousBatchingEngine = Handed
    try:
        run, _, _, peak = serve.serve_cell(
            cell.config["model"], cell.traffic, args.seed, args.seconds,
            trace=bool(args.trace), device=torch.device("cuda", 0),
            t_start=T_START)
    finally:
        scheduler.ContinuousBatchingEngine = base
    line = {"workload": args.workload, "seed": args.seed,
            "trace": args.trace, "handed": args.handed,
            "device": run.device_kind, "memory_peak_bytes": int(peak),
            "means": _means(run),
            "end_to_end": spec.metric_values(cell.end_to_end, run)}
    if handed:
        run_spans = spans.of_buffer(handed[-1])
        line["unprofiled"] = {
            "host_ms.prefill": spans.host_ms(run_spans, "serve.prefill"),
            "host_ms.decode": spans.host_ms(run_spans, "serve.decode"),
            "moe_host_ms.prefill": spans.moe_host_ms(run_spans),
            "moe_host_share.prefill": spans.moe_host_share(run_spans)}
    if args.trace:
        found = spans.program_spans()
        line["per_layer"] = spec.metric_values(cell.per_layer, run)
        line["spans"] = len(found)
        line["report"] = spans.report(run.window, found) \
            if run.window is not None else {}
        line["inside_outside"] = _inside_outside(run, found)
        line["profiler_stall_s"] = run.profiler_stall_s
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
