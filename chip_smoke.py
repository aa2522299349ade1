#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA
H100: the quickest proof that the port starts, builds and serves on the
card.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits nonzero without
the final result line:

  device   the card (nvidia-smi name and power limit); no CUDA is a failure
  build    nvcc build of every kernel of the main path, from this checkout
  kernel   each kernel against its plain PyTorch version at the full-width
           gemma2-9b layer shapes (M = 4 decode rows, M = 256 prefill rows),
           every activation mode, with times and bounds
  smoke    the smoke-size model served on the card against the same model
           served by the plain versions on the CPU
  serve    the main path: full-width gemma2-9b (4 of 42 layers, random
           weights from a seed) deployed on a 6144-core chip, batch 4,
           prompt 64, 32 generated tokens; kernel launches counted; prefill
           and two decode steps rerun through the plain versions on the
           same chip; a profiled window of decode steps
  kernels  one line per the contract below, then the result line

Tolerances: the kernel and its plain version must agree bit for bit in
every activation mode — the tile dot is exact in FP64 and every later
operation is the same IEEE operation in the same order — so the served
logits of the kernel run and of the plain rerun must be equal too. The
card-vs-CPU smoke comparison differs in the float ops around the kernel
(attention, norms, matmuls on two devices): logits within SMOKE_ATOL and
greedy tokens equal unless the top two logits lie within 2 * SMOKE_ATOL.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP64_FLOPS_PER_S = 67e12         # H100 SXM FP64 peak (tensor cores; 34 on CUDA cores)
SMOKE_ATOL = 1e-4                # smoke logits are O(1); f32 roundings
LAYER = {"wq": (3584, 4096), "wk": (3584, 2048), "wo": (4096, 3584),
         "w_g": (3584, 14336), "w_o": (14336, 3584)}
# projections of one gemma2-9b layer per LAYER shape (wv = wk, w_i = w_g)
PER_LAYER = {"wq": 1, "wk": 2, "wo": 1, "w_g": 2, "w_o": 1}
ACTIVATIONS = ("none", "relu", "tanh", "sigmoid", "identity")
SERVE = dict(n_layers=4, batch=4, prompt_len=64, gen=32, cim_cores=6144)

failures = []


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase(name):
    """Run a phase; a failure is printed and recorded, never swallowed."""
    def wrap(fn):
        def run(*a, **kw):
            try:
                out = fn(*a, **kw)
                emit({"phase": name, "ok": True, **(out or {})})
                return out
            except Exception as e:          # reported, and fails the run
                traceback.print_exc()
                failures.append(name)
                emit({"phase": name, "ok": False,
                      "error": f"{type(e).__name__}: {e}"})
                return None
        return run
    return wrap


def median_ms(torch, fn, reps, flush=None):
    """Median CUDA-event time of `fn`, each run after an L2 flush (the
    serving path finds every layer's conductances cold)."""
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


@phase("device")
def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "name": torch.cuda.get_device_name(0)}


@phase("build")
def build_phase(K, stopwatch):
    with stopwatch() as sw:
        lib = K.build()
        K.load()
    return {"seconds": sw.s, "library": str(lib.relative_to(ROOT))}


def packed_args(p, den=None):
    return (p.gd_tiles, p.inv_norm_tiles,
            p.denorm_tiles if den is None else den, p.v_decr_tiles,
            p.row_index, p.col_start)


def plan_bytes(p, m):
    """Bytes the function must move: every input read once, the output
    written once."""
    t = [p.gd_tiles, p.inv_norm_tiles, p.denorm_tiles, p.v_decr_tiles,
         p.row_index, p.col_start]
    n_out = m * p.n_col_blocks * p.bn
    return (sum(a.numel() * a.element_size() for a in t)
            + m * p.n_rows * 4 + n_out * 4)


@phase("kernel")
def kernel_phase(torch, K, cim, CIMConfig, CoreSpec, dev, stats):
    gen = torch.Generator(dev).manual_seed(11)
    weights = {n: torch.randn(r, c, generator=gen, device=dev) / r ** 0.5
               for n, (r, c) in LAYER.items()}
    chip = cim.compile_chip(weights, CIMConfig(), CoreSpec(n_cores=6144),
                            "ideal", in_alpha=3.0, generator=gen)
    del weights
    flush = torch.empty(64 * 1024 * 1024, device=dev)   # 256 MB > L2
    rows = []
    for name, (r, c) in LAYER.items():
        p = chip.layers[name].packed
        if p.n_passes != 1:
            raise AssertionError(f"{name}: {p.n_passes} passes, the kernel "
                                 "runs single-pass plans")
        mask = (p.inv_norm_tiles > 0).to(torch.float32)
        kw = dict(n_row_blocks=p.n_row_blocks, n_ranks=p.n_ranks,
                  v_read=0.5)
        for m in (4, 256):
            x = torch.randint(-7, 8, (m, r), generator=gen,
                              device=dev).to(torch.float32)
            hits = K.boundary_counts(x, p.gd_tiles, p.inv_norm_tiles,
                                     p.v_decr_tiles, p.row_index,
                                     p.col_start, **kw)
            for act in ACTIVATIONS:
                for den in (mask, p.denorm_tiles):
                    a = K.cim_mvm_packed(x, *packed_args(p, den),
                                         activation=act, **kw)
                    b = K.cim_mvm_packed(x, *packed_args(p, den),
                                         activation=act, impl="plain", **kw)
                    torch.cuda.synchronize()
                    if not bool(torch.isfinite(a).all()):
                        raise AssertionError(f"{name} M={m} {act}: "
                                             "non-finite output")
                    d = (a - b).abs()
                    stats["max_abs_err"] = max(stats["max_abs_err"],
                                               float(d.max()))
                    if bool((d != 0).any()):
                        raise AssertionError(
                            f"{name} M={m} {act}: {int((d != 0).sum())} "
                            f"outputs differ from the plain version (max "
                            f"{float(d.max())}; {int((hits > 0).sum())} "
                            "outputs lie near a .5 boundary)")
            run_k = lambda: K.cim_mvm_packed(x, *packed_args(p),
                                             activation="none", **kw)
            run_p = lambda: K.cim_mvm_packed(x, *packed_args(p),
                                             activation="none",
                                             impl="plain", **kw)
            run_k()
            ms = median_ms(torch, run_k, 20, flush)
            plain_ms = median_ms(torch, run_p, 5, flush)
            nbytes = plan_bytes(p, m)
            flops = 2.0 * m * p.n_tiles * p.bk * p.bn
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / FP64_FLOPS_PER_S * 1e3
            row = {"matrix": name, "shape": [r, c], "m": m,
                   "tiles": p.n_tiles, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "flops": flops,
                   "boundary_outputs": int((hits > 0).sum())}
            emit({"phase": "kernel-shape", **row})
            rows.append(row)
    decode = [r for r in rows if r["m"] == 4]
    stats["decode_layer"] = {
        k: sum(PER_LAYER[r["matrix"]] * r[k] for r in decode)
        for k in ("ms", "plain_ms", "bound_ms")}
    return {"shapes": len(rows), "max_abs_err": stats["max_abs_err"],
            "decode_layer": stats["decode_layer"]}


def compare_runs(torch, ref, other, what, atol):
    """Greedy tokens equal (unless the reference's top two logits tie
    within 2 * atol) and logits within atol; returns the max |logit
    diff|."""
    err = 0.0
    for i, (la, lb) in enumerate(zip(ref.logits, other.logits)):
        la, lb = la.float().cpu(), lb.float().cpu()
        if not bool(torch.isfinite(lb).all()):
            raise AssertionError(f"{what}: non-finite logits at token {i}")
        err = max(err, float((la - lb).abs().max()))
        top2 = torch.topk(la, 2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= 2 * atol
        differ = la.argmax(-1) != lb.argmax(-1)
        if bool((differ & ~tie).any()):
            raise AssertionError(f"{what}: greedy token {i} differs")
    if err > atol:
        raise AssertionError(f"{what}: logits differ by {err} > {atol}")
    return err


@phase("serve")
def serve_phase(torch, K, serve, dev, stats):
    K.LAUNCHES = 0                       # the main path's run starts here
    res = serve.serve_static("gemma2-9b", cim=True, device=str(dev),
                             **SERVE)
    torch.cuda.synchronize()
    launches = K.LAUNCHES                # ... and ends here
    stats["launches"] = launches
    cfg, g = res.cfg, res.out
    want = 7 * SERVE["n_layers"] * SERVE["gen"]
    if launches != want:
        raise AssertionError(f"kernel launched {launches} times, the main "
                             f"path needs {want}")
    shape = (SERVE["batch"], SERVE["gen"])
    if tuple(g.tokens.shape) != shape:
        raise AssertionError(f"tokens {tuple(g.tokens.shape)} != {shape}")
    if not all(bool(torch.isfinite(lg).all()) for lg in g.logits):
        raise AssertionError("non-finite logits")
    # prefill + two decode steps through the plain versions, same chip,
    # fed the kernel run's tokens
    plain = serve.greedy_decode(res.params, cfg.replace(cim_impl="plain"),
                                res.prompts, 3, dev,
                                teacher=g.tokens[:, :2])
    ref = serve.Generation(g.tokens[:, :3], g.logits[:3], 0.0, [])
    err = compare_runs(torch, ref, plain, "kernel vs plain serve", 0.0)
    mean = lambda v: sum(v) / len(v)
    return {"config": "gemma2-9b full width, 4 of 42 layers",
            "deploy_s": res.deploy_s, "prefill_ms": g.prefill_s * 1e3,
            "decode_ms_per_token": mean(g.decode_s) * 1e3,
            "decode_ms_median": statistics.median(g.decode_s) * 1e3,
            "decode_tok_per_s": SERVE["batch"] / mean(g.decode_s),
            "launches": launches, "plain_max_abs_logit_err": err,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "sample_tokens": g.tokens[0, :8].tolist(),
            "decode_profile": profile_decode(torch, serve, res, dev)}


def profile_decode(torch, serve, res, dev):
    """Device time by kernel over as many decode steps as the serve run
    took, after a prefill (torch.profiler / CUPTI). The device's busy
    share is read twice: against the profiled window's wall time, and
    against the unprofiled serve run's mean CUDA-event step time (no
    profiler overhead on the host)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import (arch_serving, make_decode_step,
                                          make_prefill_step)
    from repro_torch.obs.clock import now
    cfg, prompts = res.cfg, res.prompts
    steps = len(res.out.decode_s)
    cache = arch_serving(cfg, dev).init_state(prompts.shape[0],
                                              prompts.shape[1] + steps + 1)
    decode = make_decode_step(cfg)
    logits, cache = make_prefill_step(cfg)(res.params, cache,
                                           {"tokens": prompts})
    tok = torch.argmax(logits, -1)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = now()
        for _ in range(steps):
            logits, cache = decode(res.params, cache, {"tokens": tok})
            tok = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()
        wall = now() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            key = e.name.replace("(anonymous namespace)::", "")
            key = key.split("(")[0][:60]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        return {"device_ms_per_step": "not measured"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    cim = sum(v for k, v in by_name.items() if "cim_mvm_packed" in k)
    step_s = sum(res.out.decode_s) / steps
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_ms_per_step": busy / 1e3 / steps,
            "device_busy_share": busy / 1e6 / wall,
            "device_busy_share_of_serve_step": busy / 1e6 / steps / step_s,
            "cim_kernel_share_of_device": cim / busy,
            "top_kernels_ms_per_step": {k: v / 1e3 / steps for k, v in top}}


@phase("smoke")
def smoke_phase(torch, serve, dev):
    """Same seeded params, calibration batches and prompts, served on the
    card (kernel) and on the CPU (plain versions)."""
    from repro_torch.core.cim import synthetic_x_cal
    from repro_torch.models import nn, transformer
    cfg = serve.serving_config("gemma2-9b", smoke=True, cim=True)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(7)
    x_cal = [{n: synthetic_x_cal(params["layers"][n].shape[1], 3.0, gen)
              for n in sorted(nn.PACKED_PROJ_KEYS) if n in params["layers"]}
             for _ in range(cfg.n_layers)]
    args = dict(smoke=True, batch=2, prompt_len=8, gen=4, cim=True,
                x_cal=x_cal)
    cpu = serve.serve_static("gemma2-9b", device="cpu", params=params,
                             **args)
    on_card = {k: ({n: t.to(dev) for n, t in v.items()}
                   if isinstance(v, dict) else v.to(dev))
               for k, v in params.items()}
    card = serve.serve_static("gemma2-9b", device=str(dev),
                              params=on_card, prompts=cpu.prompts, **args)
    err = compare_runs(torch, cpu.out, card.out, "card vs CPU smoke serve",
                       SMOKE_ATOL)
    return {"max_abs_logit_err": err,
            "tokens_equal": bool(torch.equal(cpu.out.tokens,
                                             card.out.tokens.cpu()))}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import cim
    from repro_torch.core.types import CIMConfig, CoreSpec
    from repro_torch.kernels.cim_mvm import kernel as K
    from repro_torch.launch import serve
    from repro_torch.obs.clock import stopwatch

    dev = serve.resolve_device("cuda")
    stats = {"max_abs_err": 0.0}
    info = device_phase(torch)
    if build_phase(K, stopwatch) is None:
        return 1
    kernel_phase(torch, K, cim, CIMConfig, CoreSpec, dev, stats)
    torch.cuda.empty_cache()
    smoke_phase(torch, serve, dev)      # also loads the model's CUDA modules
    serve_phase(torch, K, serve, dev, stats)

    layer = stats.get("decode_layer", {})
    emit({"kernels": [{
        "name": "cim_mvm_packed", "route": "cuda",
        "source": "src/repro_torch/kernels/cim_mvm/csrc/cim_mvm_packed.cu",
        "replaces": "src/repro/kernels/cim_mvm/kernel.py:238",
        "launches": stats.get("launches", 0),
        "max_abs_err": stats["max_abs_err"],
        "ms": layer.get("ms"), "plain_ms": layer.get("plain_ms"),
        "bound_ms": layer.get("bound_ms"), "bound_by": "bytes",
        "library_ms": None,
        "at": "one full-width layer's seven projections at M = 4 "
              "(a decode step)",
        "ok": not failures}]})
    if failures or info is None:
        print(f"chip_smoke.py: failed phases: {failures}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
