#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA
H100: the quickest proof that the port starts, builds and serves on the
card.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits nonzero without
the final result line:

  device        the card (nvidia-smi name and power limit); no CUDA fails
  build         nvcc build of every kernel, from this checkout, in parallel;
                every CIM and noisy-matmul kernel's registers and spills
                from `-Xptxas -v`
  kernel        the packed kernel against its plain PyTorch version at the
                full-width gemma2-9b layer shapes, M = 1, 4, 16 (the split
                route), 17, 32, 64 and 256 (the walk), every activation,
                with the plan's denorm and with the valid-column mask;
                times and bounds at M = 4, 16, 17, 32, 64 and 256, each
                line with its route and the walk's geometry and grid, and
                the walk's time at the split route's M in the same run
                (`walk_ms`, through the kernel module's own
                `launch_walk`); a route-edge line sums a layer's seven
                projections per M on both routes
  kernel-runs   the scheduled kernel on the multi-pass w_g and w_o of a
                full-width layer compiled on a 3072-core chip (M as the
                kernel phase, both weightings, the walk timed beside the
                split route) and on a 35-row IR-drop layer whose tiles are
                not 16-byte multiples, the scheduled kernel forced onto a
                single-pass plan against the packed kernel (and timed
                beside it, kernel-level line), and the transposed kernel on
                the bwd direction of that chip's w_g and w_o (the walk at
                every M, timed at the kernel phase's M), at the RBM's
                geometry (795 x 121, M = 4, 16 and 64) and on the
                interleaved smoke RBM's 70 x 33 tiles (M = 1, 4, 16, 17,
                64); every activation including stochastic, bit for bit,
                with times and bounds
  smoke         the smoke-size model served on the card against the same
                model served by the plain versions on the CPU
  serve         full-width gemma2-9b (4 of 42 layers, random weights from
                a seed) on a 6144-core chip, batch 4, prompt 64, 32
                tokens; launches counted; prefill and two decode steps
                rerun through the plain versions
  serve-merged  the same model on a 3072-core chip (merged cores), 8
                tokens: 4 projections per layer on the packed kernel, 3 on
                the scheduled kernel; launches counted exactly; plain rerun
  serve-irdrop  2 layers on a 32768-core IR-drop chip (alpha 2e-7, 47-column
                tiles), 4 tokens: every projection scheduled; plain rerun
  serve-traffic continuous batching (launch/scheduler) of the serve model:
                slots 4, chunk 32, 16 requests from `traffic_requests`
                seeded 1 (prompts 32-64 in pages of 32, 16-32 tokens, 50
                req/s, realtime); one decode capture; packed launches
                exactly 28 per chunk and decode step call, and on the
                device (profiler) 28 term passes and folds per replay, 28
                walks in a 32-row chunk, 28 term passes and folds in a
                16-row one; a second engine on the same chip (prompts of
                32, 48 and 64 tokens: a 16-row chunk at offset 32) where
                one replayed step equals the step run eagerly on a clone
                of the pool (every slot live, then one frozen), bit for
                bit, and which then serves those prompts; each request of
                both engines equal to it served alone on the static path
                (tokens; logits within TRAFFIC_ATOL); a realtime=False
                rerun of all of them through the plain versions equal;
                tok/s, p50/p99, TTFT, utilization and energy, the decode
                step replayed beside eager (CUDA events), its device ms
                and busy share (profiler), prefill chunks of 32 and 16
                rows; the static baseline (`scheduler.serve_static`) on
                the same requests
  serve-traffic-merged  the same on the 3072-core chip (the scheduled
                kernel through the pool)
  recover       Bayesian image recovery at paper geometry (784 pixels + 10
                labels, 120 hidden units), batch 64, 10 Gibbs cycles:
                digital, stochastic and pixel-interleaved runs, launches
                counted per run, a plain rerun from the same seeds
  chip-linear   the single-matrix kernel against its plain version at
                every 7-layer CNN and ResNet-20 matrix shape at batch 256
                (im2col rows M, K with the bias row, N) and at ragged
                shapes (M = 1, 3, 257; N = 10), on relaxed conductances,
                every activation including stochastic, bit for bit; times
                and bounds per shape; and per CNN shape the fused forward
                (core.cim.forward: float patches in, the bias row, float
                out) against forward(impl="plain") in every activation it
                takes, bit for bit, timed beside its own bound; at the
                ragged shapes the fused forward with two bias rows; the
                wrappers' host us per call
  cnn7          the 7-layer CNN at 28x28x1, batch 256 (random weights from
                seed 0, 32 calibration images): deploy and chip inference,
                relaxed and writeverify, 6 + 7 launches each; a plain
                rerun's logits equal; top-1 agreement with the software
                path (a check of the path, not an accuracy)
  resnet20      ResNet-20 at 32x32x3, batch 256, relaxed: 21 + 22 launches,
                plain rerun equal, top-1 agreement
  train-cnn7    cnn7 at 28x28x1 trained with the reference's noise-resilient
                recipe (2048 cluster images, 240 steps of 64, weight noise
                0.15 after a clean half): ms per step clean and noisy (CUDA
                events), top-1 under weight noise 0, 0.1 and 0.2 (3 trials);
                a relaxed deploy on 32 images and chip inference on 512 test
                images (6 + 7 launches) equal to the plain rerun; software
                and chip top-1 and their agreement
  chip-in-loop  progressive fine-tuning of that model over its 7 stages (192
                images, 25 steps per stage, lr 5e-4, noise 0.1) on the Fig.
                3f chip (IR drop 4e-5, ADC offset spread 0.004: the
                bit-serial oracle, no kernel launch) and on a relaxed chip
                (every stage's deploy and chip prefix through cim_mvm, each
                held against the plain version); test top-1 without and
                with fine-tuning, seconds and launches per stage
  train-resnet20  ResNet-20 at 32x32x3, 20 clean steps of 64 with BN state
                (ms per step; the running means moved); deploy(upto=1, 9,
                10, 22), one launch per programmed convolution; chip
                inference on 256 images (22 launches) equal to the plain
                rerun
  lstm          the 4-cell LSTM at paper geometry (hidden 112, 50 steps of
                40 MFCC features, 12 classes; 2048 / 512 keyword series),
                200 steps of 64 at lr 3e-3, noise 0.15 after a clean half;
                a relaxed deploy on 16 series; chip inference on the test
                set: 404 launches, equal to the plain rerun; top-1 of both,
                ms per step and per chip inference (its device ms in the
                profile phase); cell 0's three matrices (N = 448, 448, 12)
                against the plain version in every activation, timed beside
                their bound
  noisy-matmul  the noise-injection training matmul at the 7-layer CNN's
                conv5 and a gemma2-9b w_g in training (2 launches), then
                against its plain version (NOISY_TOL), seed determinism,
                sigma 0 against the plain product, and the reference
                test's noise statistic; times beside a torch.matmul on the
                materialised noisy weight ("matmul only"), with its two
                kernels' device times (weight pass, SGEMM) read by the
                profiler from the wrapper's own launches; the phase's
                peak device memory
  profile       a profiled prefill of each serve path (the walk's device ms
                per projection, in the model's call order) and a profiled
                decode window (the split route's term and fold kernels
                timed apart; a decode step that launches the walk fails),
                three
                profiled chip inferences of each CNN path and the LSTM (the
                single-matrix kernel's and the glue's device ms: the
                elementwise and concatenation kernels), and the
                transposed kernel's device time at the RBM's shape, after
                every timed run
  kernels       one line per the contract below, then the result line

Tolerances: every kernel and its plain version must agree bit for bit in
every activation mode — the tile dot is exact in FP64 and every later
operation is the same IEEE operation in the same order, the stochastic
neuron's hash included — so the served logits and the Gibbs trajectories
of the kernel runs and of the plain reruns must be equal too. The
card-vs-CPU smoke comparison differs in the float ops around the kernel
(attention, norms, matmuls on two devices): logits within SMOKE_ATOL and
greedy tokens equal unless the top two logits lie within 2 * SMOKE_ATOL.
A request served through the slot pool and served alone differ only in
the float ops around the kernels (attention's batched products, chunked
prefill): logits within TRAFFIC_ATOL and greedy tokens equal.
The noisy matmul sums in f32 in another order than its plain version and
draws eps with the same hash but possibly other logf / cosf roundings:
NOISY_TOL, |kernel - plain| <= (2K + 8) * 2^-24 * (|x| @ (|w| + sigma *
|eps|)) elementwise.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP64_FLOPS_PER_S = 67e12         # H100 SXM FP64 peak (tensor cores; 34 on CUDA cores)
SMOKE_ATOL = 1e-4                # smoke logits are O(1); f32 roundings
TRAFFIC_ATOL = 1e-4              # LOGIT_ATOL of tests/test_torch_serve.py
SPIN_CYCLES = 1_000_000          # ~0.5 ms at 1.98 GHz: covers a wrapper's host time
LAYER = {"wq": (3584, 4096), "wk": (3584, 2048), "wo": (4096, 3584),
         "w_g": (3584, 14336), "w_o": (14336, 3584)}
FULL_LAYER = {"wq": (3584, 4096), "wk": (3584, 2048), "wv": (3584, 2048),
              "wo": (4096, 3584), "w_g": (3584, 14336),
              "w_i": (3584, 14336), "w_o": (14336, 3584)}
# projections of one gemma2-9b layer per LAYER shape (wv = wk, w_i = w_g)
PER_LAYER = {"wq": 1, "wk": 2, "wo": 1, "w_g": 2, "w_o": 1}
ACTIVATIONS = ("none", "relu", "tanh", "sigmoid", "identity")
ALL_ACTIVATIONS = ACTIVATIONS + ("stochastic",)
COMPARE_ROWS = (1, 4, 16, 17, 32, 64, 256)   # both routes, prefill
TIME_ROWS = (4, 16, 17, 32, 64, 256)  # decode, the route's edge, prefill
# the model's projections in their call order inside a layer
PROJ_ORDER = ("wq", "wk", "wv", "wo", "w_g", "w_i", "w_o")
SEED = 1234                      # the stochastic neuron's salt
SERVE = dict(n_layers=4, batch=4, prompt_len=64, gen=32, cim_cores=6144)
MERGED = dict(n_layers=4, batch=4, prompt_len=64, gen=8, cim_cores=3072)
IRDROP = dict(n_layers=2, batch=4, prompt_len=64, gen=4, cim_cores=32768,
              cim_ir_drop=2e-7)
TRAFFIC = dict(n_layers=4, cim_cores=6144, slots=4, chunk=32, requests=16,
               prompt_len=64, gen=32, rate=50.0)
TRAFFIC_MERGED = dict(TRAFFIC, cim_cores=3072)
# projections per layer on each kernel (the plans the chips compile to)
SERVE_ROUTES = {"cim_mvm_packed": 7}
MERGED_ROUTES = {"cim_mvm_packed": 4, "cim_mvm_scheduled": 3}
IRDROP_ROUTES = {"cim_mvm_scheduled": 7}
RECOVER = ["--pixels", "784", "--labels", "10", "--hidden", "120",
           "--batch", "64", "--cycles", "10", "--mode", "ideal"]
SOURCES = {k: f"src/repro_torch/kernels/{v}"
           for k, v in (("cim_mvm_packed", "cim_mvm/csrc/cim_mvm_packed.cu"),
                        ("cim_mvm_scheduled",
                         "cim_mvm/csrc/cim_mvm_scheduled.cu"),
                        ("cim_mvm_transposed",
                         "cim_mvm/csrc/cim_mvm_transposed.cu"),
                        ("cim_mvm", "cim_mvm/csrc/cim_mvm.cu"),
                        ("noisy_matmul",
                         "noisy_matmul/csrc/noisy_matmul.cu"))}
REPLACES = {"cim_mvm_packed": "src/repro/kernels/cim_mvm/kernel.py:238",
            "cim_mvm_scheduled": "src/repro/kernels/cim_mvm/kernel.py:351",
            "cim_mvm_transposed": "src/repro/kernels/cim_mvm/kernel.py:466",
            "cim_mvm": "src/repro/kernels/cim_mvm/kernel.py:161",
            "noisy_matmul": "src/repro/kernels/noisy_matmul/kernel.py:44"}
FP32_FLOPS_PER_S = 67e12         # H100 SXM FP32 peak (CUDA cores, no TF32)
CNN_BATCH, CNN_CAL = 256, 32     # images per inference; calibration images
# every chip matrix of the two CNNs at batch 256: (rows M of the im2col'd
# input, K weight rows with the one bias row untrained weights give, N)
CNN7_SHAPES = {"conv0": (200704, 10, 16), "conv1": (200704, 145, 16),
               "conv2": (50176, 145, 32), "conv3": (50176, 289, 32),
               "conv4": (12544, 289, 64), "conv5": (12544, 577, 64),
               "fc": (256, 577, 10)}
RESNET20_SHAPES = {"stem": (262144, 28, 16),
                   "s0 c1/c2 (x6)": (262144, 145, 16),
                   "s1b0c1": (65536, 145, 32),
                   "s1 c2, b1-2 c1 (x5)": (65536, 289, 32),
                   "s1b0proj": (65536, 17, 32), "s2b0c1": (16384, 289, 64),
                   "s2 c2, b1-2 c1 (x5)": (16384, 577, 64),
                   "s2b0proj": (16384, 33, 64), "fc": (256, 65, 10)}
# ragged batches and widths, held against the plain version only
RAGGED_SHAPES = {"M 1": (1, 577, 10), "M 3": (3, 145, 16),
                 "M 257": (257, 289, 10), "M 257, N 64": (257, 33, 64),
                 "N 500": (5, 300, 500)}
NOISY_SHAPES = {"cnn7 conv5 training": (12544, 577, 64),
                "gemma2-9b w_g training": (2048, 3584, 14336)}
# the training paths: the reference's recipes (benchmarks/bench_accuracy.py,
# bench_chip_in_loop.py, tests/test_models.py) at the paper's geometry
TRAIN_CNN7 = dict(hw=28, train=2048, test=512, batch=64, steps=240,
                  noise=0.15, lr=1e-3, cal=32)
CHIP_IN_LOOP = dict(train=192, cal=24, ft_steps=25, lr=5e-4, noise=0.1)
TRAIN_RESNET20 = dict(hw=32, train=2048, batch=64, steps=20, cal=32,
                      uptos=(1, 9, 10, 22))
LSTM = dict(train=2048, test=512, batch=64, steps=200, noise=0.15, lr=3e-3,
            cal=16)

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
    """Median CUDA-event time of `fn`. With `flush` (a kernel's time): each
    run after an L2 flush (the serving path finds every layer's
    conductances cold) and a spin of SPIN_CYCLES on the card, so the host
    enqueues fn's launches while the card is still busy and the window
    holds the device's time, not the wrapper's host latency. Without it
    (an inference's time), host time counts."""
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def host_us(torch, fn, reps=20):
    """Host microseconds per call of `fn` (the wrapper's own time): reps
    calls enqueued behind a 10 ms spin of the card, so none waits on the
    device; their wall time over reps."""
    torch.cuda.synchronize()
    torch.cuda._sleep(20 * SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def reset_launches(K):
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0


def free(torch):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


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
    from repro_torch.kernels import build
    from repro_torch.kernels.noisy_matmul import kernel as NK
    with stopwatch() as sw:
        libs = build.build()
        K.load()
        NK.load()
    return {"seconds": sw.s,
            "libraries": {k: str(v.relative_to(ROOT))
                          for k, v in libs.items()},
            "ptxas": {k: ptxas_kernels(build.ptxas_log(libs[k]))
                      for k in (*K.SPLIT_KERNELS, "cim_mvm_transposed",
                                "noisy_matmul")}}


def ptxas_kernels(log):
    """Registers and spill bytes of each kernel of a library, from the
    build's `-Xptxas -v` report (name<template ints>: [registers, spill
    stores, spill loads])."""
    import re
    if not log.exists():
        return "not measured"
    out = {}
    for block in log.read_text().split("Compiling entry function")[1:]:
        mangled = block.split("'")[1]
        ident = re.search(r"\d+((?:cim|noisy)_[a-z_]+)", mangled)
        args = re.findall(r"L[ib](\d+)E", mangled)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if ident and regs:
            name = ident.group(1) + (f"<{','.join(args)}>" if args else "")
            out[name] = [int(regs.group(1))] + (
                [int(v) for v in spill.groups()] if spill else [])
    return out


def packed_args(p, den=None):
    return (p.gd_tiles, p.inv_norm_tiles,
            p.denorm_tiles if den is None else den, p.v_decr_tiles,
            p.row_index, p.col_start)


def live_slots(p):
    """Slots whose run is live: idle slots (pass padding) are work the
    function does not need."""
    return [s for s in range(p.n_tiles) if p.out_col[p.out_slot[s]] >= 0]


def bound(p, m, kernel):
    """(bound ms, bound_by, bytes, flops) of one launch of plan p on M rows
    through `kernel`: bytes each live tile's tensors read once, the index
    tables the kernel reads, x read once, the output written once; FP64
    multiply-adds of the live tiles."""
    n_live = len(live_slots(p))
    tile_bytes = p.bk * p.bn * 4 + 2 * p.bn * 4 + 4 + 4
    tables = [p.row_index] + ([p.col_start] if kernel == "cim_mvm_packed"
                              else [p.run_start, p.col_run_start, p.col_runs])
    if p.tile_index is not None:
        tables.append(p.tile_index)
    tables = sum(t.numel() * 4 for t in tables)
    nbytes = (n_live * tile_bytes + tables + m * p.n_rows * 4
              + m * p.n_col_blocks * p.bn * 4)
    flops = 2.0 * m * n_live * p.bk * p.bn
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP64_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def check_equal(torch, a, b, what, stats, kernel):
    """a equals b bit for bit; records the max |a - b| of `kernel`."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{what}: non-finite output")
    d = (a - b).abs()
    err = stats["err"]
    err[kernel] = max(err.get(kernel, 0.0),
                      float(d.max()) if d.numel() else 0.0)
    if bool((d != 0).any()):
        raise AssertionError(f"{what}: {int((d != 0).sum())} outputs differ "
                             f"from the plain version (max {float(d.max())})")


def walk_call(K, p, x, kernel, den=None):
    """p's launch through the walk at any M (the kernel module's own
    launch function: the wrappers take the split route up to 16 rows)."""
    tiles = (p.inv_norm_tiles, p.denorm_tiles if den is None else den,
             p.v_decr_tiles)
    tables = ((p.row_index, p.col_start) if kernel == "cim_mvm_packed"
              else (p.row_index, p.run_start, p.col_run_start, p.col_runs))
    return K.launch_walk(kernel, x, p.gd_tiles, tiles, tables,
                         p.n_col_blocks, p.bk, p.bn, activation="none",
                         n_max=127, v_read=0.5, seed=SEED)


def walk_geo(K, kernel, p, m, dev):
    """The walk's geometry and grid for plan p at m rows on `dev`."""
    g, grid = K.walk_launch_geometry(kernel, m, p.bk, p.bn, p.n_col_blocks,
                                     dev)
    return {**g.as_dict(), "grid": grid}


def layer_sums(rows, per_layer):
    """Per M: the ms, plain, bound (and, where the split route ran, the
    walk's) times of a layer's projections, summed with per_layer[name]
    launches each."""
    out = {}
    for m in sorted({r["m"] for r in rows}):
        rs = [r for r in rows if r["m"] == m]
        keys = ("ms", "plain_ms", "bound_ms") + (
            ("walk_ms",) if all("walk_ms" in r for r in rs) else ())
        out[m] = {k: sum(per_layer[r["matrix"]] * r[k] for r in rs)
                  for k in keys}
        out[m]["route"] = rs[0]["route"]
    return out


def common_bound(rows):
    """What bounds every row alike ("bytes" or "operations"), else
    "mixed"."""
    kinds = {r["bound_by"] for r in rows}
    return kinds.pop() if len(kinds) == 1 else "mixed"


def route_edge(K, kernel, sums):
    """The route-edge line of `kernel`: per M the layer's time on the route
    it took, and the walk's beside the split route's; the largest
    SPLIT_ROWS value at which the split route still beats the walk (0:
    none)."""
    wins = [m for m, v in sums.items()
            if v["route"] == "split" and v["ms"] < v.get("walk_ms", 0.0)]
    edge = max((r for r in K.SPLIT_ROWS
                if all(m in wins for m in sums if m <= r)), default=0)
    row = {"phase": "route-edge", "kernel": kernel, "layer": sums,
           "split_rows": list(K.SPLIT_ROWS), "split_wins_up_to": edge}
    emit(row)
    return row


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
                  v_read=0.5, seed=SEED)
        for m in COMPARE_ROWS:
            x = torch.randint(-7, 8, (m, r), generator=gen,
                              device=dev).to(torch.float32)
            for act in ALL_ACTIVATIONS:
                for den in (mask, p.denorm_tiles):
                    a = K.cim_mvm_packed(x, *packed_args(p, den),
                                         activation=act, **kw)
                    b = K.cim_mvm_packed(x, *packed_args(p, den),
                                         activation=act, impl="plain", **kw)
                    check_equal(torch, a, b, f"{name} M={m} {act}", stats,
                                "cim_mvm_packed")
            if m not in TIME_ROWS:
                continue
            run_k = lambda: K.cim_mvm_packed(x, *packed_args(p),
                                             activation="none", **kw)
            run_p = lambda: K.cim_mvm_packed(x, *packed_args(p),
                                             activation="none",
                                             impl="plain", **kw)
            run_k()
            ms = median_ms(torch, run_k, 20, flush)
            plain_ms = median_ms(torch, run_p, 5, flush)
            b_ms, b_by, nbytes, flops = bound(p, m, "cim_mvm_packed")
            row = {"matrix": name, "shape": [r, c], "m": m,
                   "tiles": p.n_tiles, "route": route_name(K, m), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / ms, "bytes": nbytes, "flops": flops,
                   "walk_geometry": walk_geo(K, "cim_mvm_packed", p, m, dev)}
            if K.split_route(m):
                row["walk_ms"] = time_walk(torch, K, p, x, "cim_mvm_packed",
                                           run_k, flush, stats)
            emit({"phase": "kernel-shape", "kernel": "cim_mvm_packed", **row})
            rows.append(row)
    sums = layer_sums(rows, PER_LAYER)
    edge = route_edge(K, "cim_mvm_packed", sums)
    t = stats["time"]["cim_mvm_packed"] = dict(sums[4], bound_by="bytes")
    t.pop("route")
    t.update({f"prefill_{k}": v for k, v in sums[256].items()
              if k != "route"})
    t["prefill_bound_by"] = common_bound(r for r in rows if r["m"] == 256)
    return {"shapes": len(rows),
            "max_abs_err": stats["err"]["cim_mvm_packed"],
            "decode_layer": sums[4], "prefill_layer": sums[256],
            "split_wins_up_to": edge["split_wins_up_to"]}


def route_name(K, m):
    return "split" if K.split_route(m) else "walk"


def time_walk(torch, K, p, x, kernel, run_split, flush, stats):
    """The walk's time on x (median of 20 after an L2 flush each), in the
    same run as the split route's, after checking that the walk's output
    equals the split route's bit for bit."""
    check_equal(torch, walk_call(K, p, x, kernel), run_split(),
                f"{p.layer} walk vs split M={x.shape[0]}", stats, kernel)
    return median_ms(torch, lambda: walk_call(K, p, x, kernel), 20, flush)


def time_route(torch, K, ops, p, x, flush, kernel, label, stats,
               scheduled=None):
    """Kernel and plain times of plan p on x (activation none) with its
    bound, the walk's geometry, and the walk's time where the scheduled
    kernel takes the split route at M = 4; emitted as one kernel-shape
    line."""
    from repro_torch.core.types import CIMConfig
    cfg = CIMConfig()
    run_k = lambda: ops.cim_mvm_packed(x, p, cfg, scheduled=scheduled)
    run_p = lambda: ops.cim_mvm_packed(x, p, cfg, scheduled=scheduled,
                                       impl="plain")
    run_k()
    ms = median_ms(torch, run_k, 20, flush)
    plain_ms = median_ms(torch, run_p, 5, flush)
    b_ms, b_by, nbytes, flops = bound(p, x.shape[0], kernel)
    m = x.shape[0]
    row = {"kernel": kernel, "matrix": label, "m": m,
           "slots": p.n_tiles, "live_tiles": len(live_slots(p)),
           "passes": p.n_passes, "runs": len(p.out_col), "bn": p.bn,
           "route": (route_name(K, m) if kernel in K.SPLIT_KERNELS
                     else "walk"),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / ms, "bytes": nbytes,
           "flops": flops}
    row["walk_geometry"] = walk_geo(K, kernel, p, m, x.device)
    if kernel in K.SPLIT_KERNELS and K.split_route(m):
        row["walk_ms"] = time_walk(torch, K, p, x, kernel, run_k, flush,
                                   stats)
    emit({"phase": "kernel-shape", **row})
    return row


def time_level(torch, ops, p, x, flush):
    """The packed and the forced-scheduled launch of one single-pass plan
    (activation none), timed in the order packed, scheduled, scheduled,
    packed; emitted as one kernel-level line."""
    from repro_torch.core.types import CIMConfig
    cfg = CIMConfig()
    out = {"cim_mvm_packed": [], "cim_mvm_scheduled": []}
    for scheduled in (False, True, True, False):
        run = lambda: ops.cim_mvm_packed(x, p, cfg, scheduled=scheduled)
        run()
        out[p.route(scheduled)].append(median_ms(torch, run, 20, flush))
    row = {"matrix": "wq single-pass", "m": x.shape[0], "tiles": p.n_tiles,
           "packed_ms": out["cim_mvm_packed"],
           "scheduled_ms": out["cim_mvm_scheduled"]}
    emit({"phase": "kernel-level", **row})
    return row


def profiled_ms(torch, fn, name, reps, flush):
    """Median device time of the kernel whose name holds `name`, one launch
    per call of fn, each call after an L2 flush (torch.profiler / CUPTI):
    the kernel alone, without the wrapper's host work (and its cast of x
    to int8)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type.name == "CUDA" and name in e.name]
    if len(us) != reps:
        return "not measured"
    return statistics.median(us) / 1e3


def compare_all(torch, K, ops, p, x, what, stats, kernel, scheduled=None,
                against_packed=False):
    """`kernel` at every activation, with the plan's denorm and with the
    valid-column mask as the weight, against its plain version (or, with
    against_packed, against the packed kernel on the same plan)."""
    import dataclasses
    from repro_torch.core.types import CIMConfig
    mask = (p.inv_norm_tiles > 0).to(torch.float32)
    for plan in (p, dataclasses.replace(p, denorm_tiles=mask)):
        for act in ALL_ACTIVATIONS:
            cfg = CIMConfig(activation=act)
            before = K.LAUNCHES[kernel]
            a = ops.cim_mvm_packed(x, plan, cfg, seed=SEED,
                                   scheduled=scheduled)
            torch.cuda.synchronize()
            if K.LAUNCHES[kernel] != before + 1:
                raise AssertionError(f"{what} {act}: {kernel} did not "
                                     "launch")
            if against_packed:
                b = ops.cim_mvm_packed(x, plan, cfg, seed=SEED,
                                       scheduled=False)
            else:
                b = ops.cim_mvm_packed(x, plan, cfg, seed=SEED,
                                       scheduled=scheduled, impl="plain")
            check_equal(torch, a, b, f"{what} M={x.shape[0]} {act}", stats,
                        kernel)


@phase("kernel-runs")
def kernel_runs_phase(torch, K, ops, cim, CIMConfig, CoreSpec, dev, stats):
    gen = torch.Generator(dev).manual_seed(12)
    # in sorted name order, as the serving deploy plans them: the merge
    # takes tiles in that order
    weights = {n: torch.randn(r, c, generator=gen, device=dev) / r ** 0.5
               for n, (r, c) in sorted(FULL_LAYER.items())}
    chip = cim.compile_chip(weights, CIMConfig(), CoreSpec(n_cores=3072),
                            "ideal", in_alpha=3.0, directions=("fwd", "bwd"),
                            generator=gen)
    del weights
    flush = torch.empty(64 * 1024 * 1024, device=dev)   # 256 MB > L2
    rows = {}
    for name in ("w_g", "w_o"):
        for d, kernel in (("fwd", "cim_mvm_scheduled"),
                          ("bwd", "cim_mvm_transposed")):
            p = chip.layers_for(d)[name].packed
            if p.route() != kernel or p.n_passes < 2:
                raise AssertionError(f"{name} {d}: {p.n_passes} passes, "
                                     f"route {p.route()}")
            for m in COMPARE_ROWS:
                x = torch.randint(-7, 8, (m, p.n_rows), generator=gen,
                                  device=dev).to(torch.float32)
                compare_all(torch, K, ops, p, x, f"{name} {d}", stats,
                            kernel)
                if m in TIME_ROWS:
                    rows[name, d, m] = time_route(torch, K, ops, p, x, flush,
                                                  kernel, f"{name} {d}",
                                                  stats)
    # the scheduled kernel forced onto a single-pass plan is the packed one
    single = chip.layers["wq"].packed
    if single.n_passes != 1:
        raise AssertionError("wq is not single-pass on the 3072-core chip")
    for m in COMPARE_ROWS:
        x = torch.randint(-7, 8, (m, single.n_rows), generator=gen,
                          device=dev).to(torch.float32)
        compare_all(torch, K, ops, single, x, "wq forced scheduled", stats,
                    "cim_mvm_scheduled", scheduled=True, against_packed=True)
        if m in (4, 256):
            level = time_level(torch, ops, single, x, flush)
            rows["wq", "level", x.shape[0]] = level
    del chip
    free(torch)
    # 35-row IR-drop tiles (35 x 47 x 4 = 6,580 B): chunks off the 16-byte
    # grid of the bulk copy, single-pass and scheduled
    from repro_torch.core.types import NonIdealityConfig
    ir = CIMConfig(nonideal=NonIdealityConfig(ir_drop_alpha=2e-7))
    for cores in (48, 3):
        w = {"m": torch.randn(35, 470, generator=gen, device=dev) / 6.0}
        p = cim.compile_chip(w, ir, CoreSpec(n_cores=cores), "ideal",
                             in_alpha=3.0, generator=gen).layers["m"].packed
        if (p.bk * p.bn * 4) % 16 == 0:
            raise AssertionError(f"35-row IR-drop tiles are {p.bk} x {p.bn}")
        for m in COMPARE_ROWS:
            x = torch.randint(-7, 8, (m, 35), generator=gen,
                              device=dev).to(torch.float32)
            compare_all(torch, K, ops, p, x, f"35x470 ir-drop {cores} cores",
                        stats, p.route())
    # the interleaved smoke RBM (139 x 33 augmented, 2 cores): 70 x 33
    # tiles, stored rows off the 16-byte grid
    p = rbm_bwd_plan(torch, dev, gen, 138, 32, interleave=True)
    if tuple(p.gd_tiles.shape[1:]) != (70, 33):
        raise AssertionError(f"interleaved RBM tiles {p.gd_tiles.shape}")
    for m in (1, 4, 16, 17, 64):
        x = torch.randint(0, 2, (m, p.n_rows), generator=gen,
                          device=dev).to(torch.float32)
        compare_all(torch, K, ops, p, x, "rbm interleaved 70x33 bwd", stats,
                    "cim_mvm_transposed")
    # the RBM's geometry: the augmented 795 x 121 array, 7 tiles
    w = {"rbm": torch.randn(795, 121, generator=gen, device=dev) * 0.3}
    rchip = cim.compile_chip(w, CIMConfig(in_bits=2), CoreSpec(), "ideal",
                             directions=("fwd", "bwd"), generator=gen)
    p = rchip.bwd_layers["rbm"].packed
    for m in (4, 16, 64):
        x = torch.randint(0, 2, (m, p.n_rows), generator=gen,
                          device=dev).to(torch.float32)
        compare_all(torch, K, ops, p, x, "rbm bwd", stats,
                    "cim_mvm_transposed")
        rows["rbm", "bwd", m] = time_route(torch, K, ops, p, x, flush,
                                           "cim_mvm_transposed", "rbm bwd",
                                           stats)
    # its device time (the walk at M = 64) is read in the profile phase,
    # after every timed run
    stats["kernel_profile"] = (
        "cim_mvm_transposed", "cim_walk",
        lambda: ops.cim_mvm_packed(x, p, CIMConfig()), flush)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    # a merged layer runs w_g, w_i (= w_g's shape) and w_o scheduled
    merged = [dict(r, matrix=n) for (n, d, _), r in rows.items()
              if d == "fwd"]
    sums = layer_sums(merged, {"w_g": 2, "w_o": 1})
    edge = route_edge(K, "cim_mvm_scheduled", sums)
    t = stats["time"]["cim_mvm_scheduled"] = dict(
        sums[4], bound_by=common_bound(r for r in merged if r["m"] == 4))
    t.pop("route")
    t.update({f"prefill_{k}": v for k, v in sums[256].items()
              if k != "route"})
    t["prefill_bound_by"] = common_bound(r for r in merged if r["m"] == 256)
    stats["time"]["cim_mvm_transposed"] = {
        k: rows["rbm", "bwd", 64][k] for k in keys}
    stats["time"]["cim_mvm_transposed"]["bwd_ms"] = {
        n: {m: rows[n, "bwd", m]["ms"] for m in (4, 256)}
        for n in ("w_g", "w_o")}
    return {"shapes": len(rows),
            "max_abs_err": {k: stats["err"].get(k) for k in
                            ("cim_mvm_scheduled", "cim_mvm_transposed")},
            "merged_layer": sums,
            "split_wins_up_to": edge["split_wins_up_to"]}


def rbm_bwd_plan(torch, dev, gen, n_vis, n_hid, interleave):
    """The h->v plan of a random RBM (weights from `gen`) deployed on the
    card as the recovery deploys it."""
    from repro_torch.core.types import CIMConfig
    from repro_torch.models import nn
    params = {"w": torch.randn(n_vis, n_hid, generator=gen, device=dev) * .3,
              "a": torch.randn(n_vis, generator=gen, device=dev) * 0.1,
              "b": torch.randn(n_hid, generator=gen, device=dev) * 0.1}
    v_cal = (torch.rand(64, n_vis, generator=gen, device=dev) < 0.5).float()
    crbm = nn.deploy_rbm_cim(params, CIMConfig(in_bits=2), v_cal,
                             interleave=interleave, generator=gen)
    return crbm.chip.layers_for("bwd")["rbm"].packed


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


def serve_and_check(torch, K, ops, serve, dev, stats, path, conf, routes):
    """Serve `conf` with the launch counts set to 0 just before and read
    just after. The chip's projections must route as `routes` says, and
    each kernel must launch once per projection, layer and token. Then
    prefill and two decode steps rerun through the plain versions on the
    same chip, fed the kernel run's tokens: logits equal. Returns
    (result, launches, plain err)."""
    reset_launches(K)                    # the path's run starts here
    res = serve.serve_static("gemma2-9b", cim=True, device=str(dev), **conf)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)          # ... and ends here
    stats["launches"][path] = launches
    got = {}
    for k, v in res.params["layers"].items():
        if k.endswith("_cim"):
            r = v[0].packed.route()
            got[r] = got.get(r, 0) + 1
    if got != routes:
        raise AssertionError(f"{path}: projections route {got}, expected "
                             f"{routes}")
    want = {k: routes.get(k, 0) * conf["n_layers"] * conf["gen"]
            for k in K.LAUNCHES}
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, the path needs "
                             f"{want}")
    g = res.out
    shape = (conf["batch"], conf["gen"])
    if tuple(g.tokens.shape) != shape:
        raise AssertionError(f"tokens {tuple(g.tokens.shape)} != {shape}")
    if not all(bool(torch.isfinite(lg).all()) for lg in g.logits):
        raise AssertionError("non-finite logits")
    plain = serve.greedy_decode(res.params, res.cfg.replace(cim_impl="plain"),
                                res.prompts, 3, dev, teacher=g.tokens[:, :2])
    ref = serve.Generation(g.tokens[:, :3], g.logits[:3], 0.0, [])
    err = compare_runs(torch, ref, plain, f"{path}: kernel vs plain", 0.0)
    return res, launches, err


def serve_numbers(res, conf):
    g = res.out
    mean = lambda v: sum(v) / len(v)
    return {"deploy_s": res.deploy_s, "prefill_ms": g.prefill_s * 1e3,
            "decode_ms_per_token": mean(g.decode_s) * 1e3,
            "decode_ms_median": statistics.median(g.decode_s) * 1e3,
            "decode_tok_per_s": conf["batch"] / mean(g.decode_s),
            "sample_tokens": g.tokens[0, :8].tolist()}


SERVE_PATHS = (
    ("serve", SERVE, SERVE_ROUTES,
     "gemma2-9b full width, 4 of 42 layers, 6144 cores"),
    ("serve-merged", MERGED, MERGED_ROUTES,
     "gemma2-9b full width, 4 of 42 layers, 3072 cores"),
    ("serve-irdrop", IRDROP, IRDROP_ROUTES,
     "gemma2-9b full width, 2 of 42 layers, 32768 cores, "
     "ir_drop_alpha 2e-7"))


def serve_path(torch, K, ops, serve, dev, stats, path, conf, routes, text):
    """One serve path: its timed run and plain rerun; the deployed model
    is kept for the profile phase, which runs after every timed run (a
    profiled window can slow the host's launches after it)."""
    torch.cuda.reset_peak_memory_stats(dev)
    res, launches, err = serve_and_check(torch, K, ops, serve, dev, stats,
                                         path, conf, routes)
    stats["profile"].append((path, res))
    return {"config": text, **serve_numbers(res, conf), "launches": launches,
            "plain_max_abs_logit_err": err,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "plans": plan_summary(res.params)}


def traffic_path(torch, K, serve, dev, stats, path, conf, routes):
    """Continuous batching of `conf` through the port's engine, with the
    launch counts set to 0 just before the run (warmup and capture
    included) and read just after; then the engine's checks (module
    docstring) and its times."""
    from repro_torch.launch import scheduler
    from repro_torch.launch.scheduler import ContinuousBatchingEngine
    reset_launches(K)                    # the path's run starts here
    res = serve.serve_traffic("gemma2-9b", cim=True, device=str(dev),
                              capture_logits=True, **conf)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)          # ... and ends here
    stats["launches"][path] = launches
    eng, st = res.engine, res.stats
    if st["decode_traces"] != 1:
        raise AssertionError(f"{path}: {st['decode_traces']} decode "
                             "captures, the contract is 1")
    # every prefill and decode call (warm-ups, the capture call's one
    # eager run, replays) runs each projection once per layer; the profiled
    # replays in traffic_times show the replays' kernels on the device
    runs = {"prefill": eng._prefill.calls, "decode": eng._decode.calls}
    per_exec = conf["n_layers"] * sum(routes.values())
    if sum(eng._decode.fun.per_replay.values()) != per_exec:
        raise AssertionError(f"{path}: the captured step holds "
                             f"{eng._decode.fun.per_replay} launches, the "
                             f"path needs {per_exec}")
    want = {k: routes.get(k, 0) * conf["n_layers"] * sum(runs.values())
            for k in K.LAUNCHES}
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, the path needs "
                             f"{want} ({runs} executions)")
    m = eng.metrics
    chunks = int(m.value("serve_prefill_chunks"))
    steps = int(m.value("serve_decode_steps"))
    for r in res.requests:
        if len(r.tokens) != r.max_new or len(r.logits) != r.max_new or \
                not all(bool(torch.isfinite(torch.as_tensor(x)).all())
                        for x in r.logits):
            raise AssertionError(f"{path}: request {r.rid} returned "
                                 f"{len(r.tokens)} of {r.max_new} tokens "
                                 "or non-finite logits")
    replay, probe = replay_equals_eager(torch, res, eng)
    # each request alone on the static path, same cache length
    alone_err = 0.0
    for r in res.requests + probe:
        g = serve.greedy_decode(res.params, res.cfg,
                                torch.as_tensor(r.prompt[None]).long()
                                .to(dev), r.max_new, dev,
                                max_len=eng.max_len)
        if g.tokens[0].tolist() != r.tokens:
            raise AssertionError(f"{path}: request {r.rid}'s pool tokens "
                                 f"{r.tokens} != alone {g.tokens[0]}")
        for a, b in zip(r.logits, g.logits):
            alone_err = max(alone_err, float(
                (torch.as_tensor(a) - b[0].cpu()).abs().max()))
    if alone_err > TRAFFIC_ATOL:
        raise AssertionError(f"{path}: pool vs alone logits differ by "
                             f"{alone_err} > {TRAFFIC_ATOL}")
    # the plain versions, every request (the probe's too) admitted as soon
    # as a slot frees
    plain = ContinuousBatchingEngine(
        res.cfg.replace(cim_impl="plain"), res.params, n_slots=eng.n_slots,
        max_len=eng.max_len, chunk=eng.chunk, capture_logits=True)
    copies = [type(r)(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                      arrival=r.arrival) for r in res.requests + probe]
    plain.run(copies, realtime=False)
    for r, q in zip(res.requests + probe, copies):
        if q.tokens != r.tokens or any(
                not (a == b).all() for a, b in zip(r.logits, q.logits)):
            raise AssertionError(f"{path}: request {r.rid}: the plain "
                                 "rerun's tokens or logits differ")
    times = traffic_times(torch, eng, dev, per_exec)
    # the static baseline at equal load: the same requests in arrival
    # order, in lockstep batches of `slots`, left-padded, realtime
    copies = [type(r)(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                      arrival=r.arrival) for r in res.requests]
    static = scheduler.serve_static(res.cfg, res.params, copies,
                                    batch=eng.n_slots, max_len=eng.max_len)
    out = {"config": f"gemma2-9b full width, {conf['n_layers']} of 42 "
                     f"layers, {conf['cim_cores']} cores, slots "
                     f"{conf['slots']}, chunk {conf['chunk']}",
           "nvidia_smi": stats["smi"], "deploy_s": res.deploy_s,
           **{k: st[k] for k in ("requests", "tokens", "wall_s",
                                 "tok_per_s", "p50_ms", "p99_ms",
                                 "ttft_p50_ms", "decode_traces",
                                 "utilization", "energy_pj",
                                 "pj_per_token", "tops_per_w",
                                 "mvm_dispatches")},
           "chunks": chunks, "decode_steps": steps,
           "warmup_executions": {"prefill": runs["prefill"] - chunks,
                                 "decode": runs["decode"] - steps},
           "launches": launches,
           "packed_launches_per_execution": conf["n_layers"] * routes.get(
               "cim_mvm_packed", 0),
           "launches_per_replay": eng._decode.fun.per_replay,
           "replay_vs_eager": replay, "alone_max_abs_logit_err": alone_err,
           "plain_rerun": "equal", **times,
           "static_baseline": {k: static[k] for k in (
               "tokens", "wall_s", "tok_per_s", "p50_ms", "p99_ms",
               "utilization", "pj_per_token")}}
    del res, eng, plain
    free(torch)
    return out


def replay_equals_eager(torch, res, eng):
    """A second engine on the same chip, warmed for chunks of 32 and 16
    rows: one request per slot admitted and prefilled (fills 32, 48 and
    64: the 48-token prompt's second chunk, 16 rows on the split route,
    lands at offset 32), then one replayed decode step held against the
    step function run eagerly on a clone of the pool, bit for bit — with
    every slot live, then with slot 0 frozen (its state must not move).
    The slots are freed, and the same prompts are served through the
    engine's run (realtime=False); those requests are returned for the
    checks the traffic's requests go through."""
    from repro_torch.launch.scheduler import ContinuousBatchingEngine, Request
    probe = ContinuousBatchingEngine(res.cfg, res.params,
                                     n_slots=eng.n_slots, max_len=eng.max_len,
                                     chunk=eng.chunk, capture_logits=True)
    by_len = sorted(res.requests, key=lambda r: len(r.prompt))
    prompts = [by_len[(i * (len(by_len) - 1)) // max(eng.n_slots - 1, 1)]
               .prompt for i in range(eng.n_slots)]
    prompts[-2] = by_len[-1].prompt[:eng.chunk * 3 // 2]
    probe.warmup({eng.chunk, eng.chunk // 2})
    probe.jitwatch.seal()
    for i, p in enumerate(prompts):
        probe._admit(Request(rid=1000 + i, prompt=p, max_new=4))
    while probe._jobs:
        probe._prefill_one_chunk(0.0)
    fills = probe.pool["len"].tolist()
    if eng.chunk * 3 // 2 not in fills or \
            len(set(fills)) < min(3, eng.n_slots):
        raise AssertionError(f"replay vs eager: fills {fills}, not mixed "
                             "with a half chunk")
    checked = []
    for frozen in (False, True):
        if frozen:
            probe._activate(probe.pool, 0, False)
        before = {k: v.clone() for k, v in probe.pool.items()}
        clone = {k: v.clone() for k, v in probe.pool.items()}
        logits, _ = probe._decode(probe.params, probe.pool)    # a replay
        logits = logits.clone()
        eager, _ = probe._step(probe.params, clone)
        torch.cuda.synchronize()
        if not torch.equal(logits, eager):
            raise AssertionError(
                f"replay vs eager: logits differ by "
                f"{float((logits - eager).abs().max())} (frozen {frozen})")
        for k, v in probe.pool.items():
            if not torch.equal(v, clone[k]):
                raise AssertionError(f"replay vs eager: pool {k} differs "
                                     f"(frozen {frozen})")
        if frozen and not all(torch.equal(slot0(k, v), slot0(k, before[k]))
                              for k, v in probe.pool.items()):
            raise AssertionError("a frozen slot's state moved")
        checked.append("frozen slot 0" if frozen else "all live")
    for slot in list(probe._live):
        probe._finish(slot, 0.0)
    served = [Request(rid=1000 + i, prompt=p, max_new=4)
              for i, p in enumerate(prompts)]
    st = probe.run(served, realtime=False)
    if st["decode_traces"] != 1 or probe._prefill.traces != 2:
        raise AssertionError(f"probe: {st['decode_traces']} decode captures, "
                             f"{probe._prefill.traces} prefill signatures")
    del probe
    return {"fills": fills, "checked": checked,
            "served_prompt_lens": [len(p) for p in prompts]}, served


def slot0(key, t):
    """Slot 0's part of the pool tensor `key` (the slot dim is axis 1 of
    the cache, axis 0 of the bookkeeping)."""
    return t[:, 0] if key in ("k", "v") else t[0]


def kernel_counts(prof):
    """Device launches of the CIM kernels in a torch.profiler window, by
    the name's stem: the split route's term pass and fold, the walk."""
    names = ("cim_tile_terms", "cim_fold_runs", "cim_walk")
    out = dict.fromkeys(names, 0)
    for e in prof.events():
        if e.device_type.name == "CUDA":
            for n in names:
                out[n] += n in e.name
    return out


def traffic_times(torch, eng, dev, per_exec):
    """On the idle pool (a step changes nothing there): the decode step
    replayed and run eagerly (CUDA events, median of 20, host included);
    the replays' device time by kernel and busy share (torch.profiler),
    where each of 10 replays must show `per_exec` term passes and folds
    of the split route on the device; and prefill chunks of 32 and 16 rows
    on slot 0 through the step function (median of 5, slot reset before
    each), the last of each profiled: `per_exec` walks at 32 rows,
    `per_exec` term passes and folds at 16."""
    from torch.profiler import ProfilerActivity, profile
    replay = lambda: eng._decode(eng.params, eng.pool)
    eager = lambda: eng._step(eng.params, eng.pool)
    for f in (replay, eager):
        f()
    replay_ms = median_ms(torch, replay, 20)
    eager_ms = median_ms(torch, eager, 20)
    torch.cuda.synchronize()
    reps = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            replay()
        torch.cuda.synchronize()
    by_name = device_us_by_kernel(prof)
    busy = sum(by_name.values()) / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    counts = {"decode replays": (kernel_counts(prof), {
        "cim_tile_terms": per_exec * reps, "cim_fold_runs": per_exec * reps,
        "cim_walk": 0})}
    chunk_ms = {}
    for n in (32, 16):
        toks = torch.zeros((1, n), dtype=torch.long, device=dev)
        times = []
        for i in range(6):
            eng._reset(eng.pool, 0)
            if i == 5:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    eng._prefill.fun(eng.params, eng.pool, toks, 0)
                    torch.cuda.synchronize()
                split = n <= 16
                counts[f"prefill chunk {n}"] = (kernel_counts(prof), {
                    "cim_tile_terms": per_exec * split,
                    "cim_fold_runs": per_exec * split,
                    "cim_walk": per_exec * (not split)})
                continue
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            eng._prefill.fun(eng.params, eng.pool, toks, 0)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        chunk_ms[n] = statistics.median(times)
    eng._reset(eng.pool, 0)
    for what, (got, want) in counts.items():
        if got != want:
            raise AssertionError(f"{what}: device launches {got}, the path "
                                 f"needs {want}")
    return {"decode_step_ms_replayed": replay_ms,
            "decode_step_ms_eager": eager_ms,
            "decode_step_device_ms": busy if busy else "not measured",
            "decode_busy_share": busy / replay_ms if busy else
            "not measured",
            "decode_top_kernels_ms": {k: v / 1e3 / reps for k, v in top},
            "device_launches": {k: v[0] for k, v in counts.items()},
            "prefill_chunk_ms": chunk_ms}


TRAFFIC_PATHS = (("serve-traffic", TRAFFIC, SERVE_ROUTES),
                 ("serve-traffic-merged", TRAFFIC_MERGED, MERGED_ROUTES))


@phase("profile")
def profile_phase(torch, dev, stats):
    out = {}
    if "kernel_profile" in stats:
        kernel, name, fn, flush = stats.pop("kernel_profile")
        t = stats["time"][kernel]
        t["device_ms"] = profiled_ms(torch, fn, name, 20, flush)
        out["rbm bwd"] = {"kernel": kernel, "device_ms": t["device_ms"],
                          "event_ms": t["ms"]}
        del fn, flush
        free(torch)
    while stats["profile"]:
        path, res = stats["profile"].pop(0)
        out[path] = {"prefill": profile_prefill(torch, res, dev),
                     **profile_decode(torch, res, dev)}
        del res
        free(torch)
    while stats["profile_cnn"]:
        path, fn, ms = stats["profile_cnn"].pop(0)
        out[path] = profile_inference(torch, fn, 3, ms)
        del fn
        free(torch)
    return out


def plan_summary(params):
    """Per projection of layer 0: slots, live tiles, passes, runs, bn."""
    out = {}
    for k, v in params["layers"].items():
        if k.endswith("_cim"):
            p = v[0].packed
            out[k[:-4]] = {"slots": p.n_tiles, "tiles": len(live_slots(p)),
                           "passes": p.n_passes, "runs": len(p.out_col),
                           "bn": p.bn}
    return out


def device_us_by_kernel(prof):
    """Device microseconds per kernel name of a torch.profiler window."""
    by_name = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            key = e.name.replace("(anonymous namespace)::", "")
            key = key.split("(")[0][:60]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    return by_name


def profile_inference(torch, fn, reps, event_ms):
    """Device time by kernel over `reps` calls of a CNN chip inference
    (torch.profiler / CUPTI), and the device's busy share against the
    profiled window and against the unprofiled CUDA-event time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.clock import now
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = now()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = now() - t0
    by_name = device_us_by_kernel(prof)
    busy = sum(by_name.values())
    if not busy:
        return {"device_ms_per_inference": "not measured"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    cim = sum(v for k, v in by_name.items() if "cim_mvm" in k)
    glue = sum(v for k, v in by_name.items()
               if "elementwise" in k or "CatArrayBatchedCopy" in k)
    return {"reps": reps, "wall_ms_per_inference": wall * 1e3 / reps,
            "device_ms_per_inference": busy / 1e3 / reps,
            "cim_kernel_ms_per_inference": cim / 1e3 / reps,
            "glue_ms_per_inference": glue / 1e3 / reps,
            "device_busy_share": busy / 1e6 / wall,
            "device_busy_share_of_event_time": busy / 1e3 / reps / event_ms,
            "cim_kernel_share_of_device": cim / busy,
            "top_kernels_ms_per_inference": {k: v / 1e3 / reps
                                             for k, v in top}}


def profile_prefill(torch, res, dev):
    """Device time of one profiled prefill (after one unprofiled one) of a
    served model (torch.profiler / CUPTI): every walk launch in start
    order, each layer's seven projections in the model's call order
    (PROJ_ORDER), so the walk's device ms per projection is the mean over
    the layers; the prefill's device ms by kernel. The profiler can miss
    the first kernels of its window (on the card it has missed a
    prefill's first walk launch), so the window opens on another prefill
    and a marker kernel (`torch.cuda._sleep`), and only what follows the
    marker is read."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import arch_serving, make_prefill_step
    cfg, prompts = res.cfg, res.prompts
    prefill = make_prefill_step(cfg)
    cache_len = prompts.shape[1] + 1

    def cache():
        return arch_serving(cfg, dev).init_state(prompts.shape[0], cache_len)
    prefill(res.params, cache(), {"tokens": prompts})
    torch.cuda.synchronize()
    lead, state = cache(), cache()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prefill(res.params, lead, {"tokens": prompts})
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)          # the marker
        prefill(res.params, state, {"tokens": prompts})
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type.name == "CUDA"),
                    key=lambda e: e.time_range.start)
    if not events:
        return {"device_ms": "not measured"}
    marks = [e.time_range.end for e in events if "spin_kernel" in e.name]
    if not marks:
        raise AssertionError("prefill: the marker kernel is not in the "
                             "profile")
    events = [e for e in events if e.time_range.start >= marks[-1]]
    walk = [e.time_range.elapsed_us() / 1e3 for e in events
            if "cim_walk" in e.name]
    if not walk or len(walk) % len(PROJ_ORDER):
        raise AssertionError(f"prefill: {len(walk)} walk launches, not "
                             f"{len(PROJ_ORDER)} per layer")
    n_layers = len(walk) // len(PROJ_ORDER)
    per_proj = {n: sum(walk[i::len(PROJ_ORDER)]) / n_layers
                for i, n in enumerate(PROJ_ORDER)}
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    top = sorted(device_us_by_kernel(prof).items(), key=lambda kv: -kv[1])
    return {"m": prompts.numel(), "layers": n_layers,
            "device_ms": busy, "walk_ms": sum(walk),
            "walk_ms_per_projection": per_proj,
            "walk_ms_per_layer": sum(walk) / n_layers,
            "top_kernels_ms": {k: v / 1e3 for k, v in top[:6]}}


def profile_decode(torch, res, dev):
    """Device time by kernel over as many decode steps as the serve run
    took, after a prefill and as many unprofiled steps, whose host time
    (until decode() returns; median) is read first (torch.profiler /
    CUPTI). The device's busy share is read twice: against the profiled
    window's wall time, and against the unprofiled serve run's mean
    CUDA-event step time (no profiler overhead on the host). The host's
    busiest operators by self time come from the profiled window."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import (arch_serving, make_decode_step,
                                          make_prefill_step)
    from repro_torch.obs.clock import now
    cfg, prompts = res.cfg, res.prompts
    steps = len(res.out.decode_s)
    cache = arch_serving(cfg, dev).init_state(
        prompts.shape[0], prompts.shape[1] + 2 * steps + 1)
    decode = make_decode_step(cfg)
    logits, cache = make_prefill_step(cfg)(res.params, cache,
                                           {"tokens": prompts})
    tok = torch.argmax(logits, -1)[:, None]
    torch.cuda.synchronize()
    host_s = []              # host time until decode() returns, unprofiled
    for _ in range(steps):
        t0 = now()
        logits, cache = decode(res.params, cache, {"tokens": tok})
        host_s.append(now() - t0)
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
    by_name = device_us_by_kernel(prof)
    busy = sum(by_name.values())
    if not busy:
        return {"device_ms_per_step": "not measured"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    per_step = lambda *names: sum(
        v for k, v in by_name.items() if any(n in k for n in names)) \
        / 1e3 / steps
    split = {"terms": per_step("cim_tile_terms"),
             "fold": per_step("cim_fold_runs")}
    walk = per_step("cim_walk")
    if walk or not (split["terms"] and split["fold"]):
        raise AssertionError(f"decode at M = {prompts.shape[0]}: split route "
                             f"{split} ms/step, walk {walk} ms/step")
    cim = per_step("cim_mvm_", "cim_walk", "cim_tile_terms", "cim_fold_runs")
    step_s = sum(res.out.decode_s) / steps
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type.name == "CPU"), key=lambda r: -r[1])[:10]
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "host_ms_per_step": statistics.median(host_s) * 1e3,
            "device_ms_per_step": busy / 1e3 / steps,
            "device_busy_share": busy / 1e6 / wall,
            "device_busy_share_of_serve_step": busy / 1e6 / steps / step_s,
            "cim_ms_per_step": cim, "split_ms_per_step": split,
            "walk_ms_per_step": walk,
            "cim_kernel_share_of_device": cim * 1e3 * steps / busy,
            "top_kernels_ms_per_step": {k: v / 1e3 / steps for k, v in top},
            "host_top_self_ms_per_step": {k: [us / 1e3 / steps, n / steps]
                                          for k, us, n in host}}


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


@phase("recover")
def recover_phase(torch, K, dev, stats):
    """Paper-geometry recovery, three ways. Per run: launches counted
    (packed 10 = the v->h half-steps, transposed 10 = h->v), a plain
    rerun from the same generator seeds bitwise equal, the per-cycle L2
    reduction and the CUDA-event time of one Gibbs run."""
    from repro_torch.launch import recover
    from repro_torch.obs.clock import timed_call
    out = {}
    for mode, flags in (("digital", []), ("stochastic", ["--stochastic"]),
                        ("interleave", ["--interleave"])):
        args = recover.parse_args(RECOVER + flags + ["--device", str(dev)])
        setup = recover.build(args, dev)
        reset_launches(K)                # the path's run starts here
        traj = recover.recover(setup, args)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)      # ... and ends here
        stats["launches"][f"recover-{mode}"] = launches
        want = {k: 0 for k in K.LAUNCHES}
        want.update(cim_mvm_packed=args.cycles,
                    cim_mvm_transposed=args.cycles)
        if launches != want:
            raise AssertionError(f"recover {mode}: launches {launches}, "
                                 f"the path needs {want}")
        shape = (args.cycles, args.batch, setup.crbm.n_vis)
        if tuple(traj.shape) != shape or not bool(torch.isfinite(traj).all()):
            raise AssertionError(f"recover {mode}: trajectory "
                                 f"{tuple(traj.shape)} != {shape} or not "
                                 "finite")
        plain = recover.recover(setup, args, impl="plain")
        if not torch.equal(traj, plain):
            raise AssertionError(f"recover {mode}: the plain rerun's "
                                 "trajectory differs")
        _, t_run = timed_call(recover.recover, setup, args, device=dev)
        red = recover.reductions(setup, traj, args.pixels)
        out[mode] = {"launches": launches, "l2_reduction_per_cycle": red,
                     "ms_per_gibbs_run": t_run * 1e3,
                     "train_s": setup.train_s, "deploy_s": setup.deploy_s,
                     "tiles": setup.crbm.chip.layers["rbm"].packed.n_tiles}
        del setup, traj, plain
        free(torch)
    return out


def cim_mvm_bound(m, k, n, k_x=None):
    """(bound ms, bound_by, bytes, flops) of one single-matrix launch: x
    (k_x columns; k for the unfused entry), gd, inv_norm and v_decr read
    once, the output written once; the fused forward also reads norm, the
    offset counts and three scalars. FP64 multiply-adds."""
    if k_x is None:
        nbytes = (m * k + k * n + n + 1 + m * n) * 4
    else:
        nbytes = (m * k_x + k * n + 3 * n + 4 + m * n) * 4
    flops = 2.0 * m * k * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP64_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


@phase("chip-linear")
def chip_linear_phase(torch, K, cim, CIMConfig, dev, stats):
    """The single-matrix kernel at every CNN matrix shape: bit for bit
    against its plain version in every activation, then timed (device ms,
    and the wrapper's host us per call); the fused forward the same at
    every CNN shape; ragged shapes compared only, the fused forward there
    with two bias rows."""
    gen = torch.Generator(dev).manual_seed(13)
    flush = torch.empty(64 * 1024 * 1024, device=dev)   # 256 MB > L2
    rows = {}
    for model, shapes in (("cnn7", CNN7_SHAPES),
                          ("resnet20", RESNET20_SHAPES),
                          ("ragged", RAGGED_SHAPES)):
        for name, (m, k, n) in shapes.items():
            w = torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
            lay = cim.program(w, CIMConfig(), 3.0, mode="relaxed",
                              generator=gen)
            gd, inv = lay.gd, lay.inv_norm
            x = torch.randint(-7, 8, (m, k), generator=gen,
                              device=dev).to(torch.float32)
            for act in ALL_ACTIVATIONS:
                kw = dict(activation=act, seed=SEED)
                a = K.cim_mvm(x, gd, inv, lay.v_decr, **kw)
                b = K.cim_mvm(x, gd, inv, lay.v_decr, impl="plain", **kw)
                check_equal(torch, a, b, f"{model} {name} {act}", stats,
                            "cim_mvm")
            g, grid = K.mvm_launch_geometry(m, k, n, k, False, dev)
            geo = {**g.as_dict(), "grid": grid}
            if model == "ragged":
                # the fused forward with two bias rows: where K is split,
                # they fall into the last slice, apart from the patches
                xf = torch.randn(m, k - 2, generator=gen, device=dev) * 2.0
                for act in ACTIVATIONS:
                    cfg = CIMConfig(activation=act)
                    a = cim.forward(lay, xf, cfg, bias=lay.in_alpha,
                                    bias_rows=2)
                    b = cim.forward(lay, xf, cfg, bias=lay.in_alpha,
                                    bias_rows=2, impl="plain")
                    check_equal(torch, a, b,
                                f"{model} {name} forward 2 bias rows {act}",
                                stats, "cim_mvm")
                g, grid = K.mvm_launch_geometry(m, k, n, k - 2, True, dev)
                emit({"phase": "kernel-shape", "kernel": "cim_mvm",
                      "model": model, "matrix": name, "m": m, "k": k,
                      "n": n, "compared": list(ALL_ACTIVATIONS),
                      "fused_compared": list(ACTIVATIONS), "bias_rows": 2,
                      "geometry": geo,
                      "fused_geometry": {**g.as_dict(), "grid": grid}})
                del x, xf, lay
                continue
            run_k = lambda: K.cim_mvm(x, gd, inv, lay.v_decr)
            run_p = lambda: K.cim_mvm(x, gd, inv, lay.v_decr, impl="plain")
            run_k()
            ms = median_ms(torch, run_k, 20, flush)
            plain_ms = median_ms(torch, run_p, 5, flush)
            k_host_us = host_us(torch, run_k)
            b_ms, b_by, nbytes, flops = cim_mvm_bound(m, k, n)
            # the fused forward: float patches (K - 1 columns, past the
            # clip too) and the bias row
            del x
            xf = torch.randn(m, k - 1, generator=gen, device=dev) * 2.0
            for act in ACTIVATIONS:      # the fused forward: no stochastic
                cfg = CIMConfig(activation=act)
                a = cim.forward(lay, xf, cfg, bias=lay.in_alpha, bias_rows=1)
                b = cim.forward(lay, xf, cfg, bias=lay.in_alpha, bias_rows=1,
                                impl="plain")
                check_equal(torch, a, b, f"{model} {name} forward {act}",
                            stats, "cim_mvm")
            cfg = CIMConfig()
            run_f = lambda: cim.forward(lay, xf, cfg, bias=lay.in_alpha,
                                        bias_rows=1)
            run_fp = lambda: cim.forward(lay, xf, cfg, bias=lay.in_alpha,
                                         bias_rows=1, impl="plain")
            fused_ms = median_ms(torch, run_f, 20, flush)
            fused_plain_ms = median_ms(torch, run_fp, 5, flush)
            g, grid = K.mvm_launch_geometry(m, k, n, k - 1, True, dev)
            f_ms, f_by, f_bytes, _ = cim_mvm_bound(m, k, n, k - 1)
            row = {"kernel": "cim_mvm", "model": model, "matrix": name,
                   "m": m, "k": k, "n": n, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "bound_share": b_ms / ms, "bytes": nbytes,
                   "flops": flops, "fused_ms": fused_ms,
                   "fused_plain_ms": fused_plain_ms, "fused_bound_ms": f_ms,
                   "fused_bound_by": f_by, "fused_bound_share": f_ms / fused_ms,
                   "fused_bytes": f_bytes, "geometry": geo,
                   "fused_geometry": {**g.as_dict(), "grid": grid},
                   "host_us": k_host_us,
                   "fused_host_us": host_us(torch, run_f)}
            emit({"phase": "kernel-shape", **row})
            rows[model, name] = row
            del xf, lay
    # one 7-layer CNN chip inference at batch 256: its 7 launches, the
    # bound of their bytes and operations together
    cnn = [r for (mdl, _), r in rows.items() if mdl == "cnn7"]
    t_bytes = sum(r["bytes"] for r in cnn) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(r["flops"] for r in cnn) / FP64_FLOPS_PER_S * 1e3
    f_bytes = sum(r["fused_bytes"] for r in cnn) / HBM_BYTES_PER_S * 1e3
    stats["time"]["cim_mvm"] = {
        "ms": sum(r["ms"] for r in cnn),
        "plain_ms": sum(r["plain_ms"] for r in cnn),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "fused_ms": sum(r["fused_ms"] for r in cnn),
        "fused_plain_ms": sum(r["fused_plain_ms"] for r in cnn),
        "fused_bound_ms": max(f_bytes, t_ops),
        "fused_host_us": sum(r["fused_host_us"] for r in cnn)}
    res = [r for (mdl, _), r in rows.items() if mdl == "resnet20"]
    return {"shapes": len(rows), "ragged": len(RAGGED_SHAPES),
            "max_abs_err": stats["err"]["cim_mvm"],
            "cnn7_inference_launches": stats["time"]["cim_mvm"],
            "resnet20_inference_launches_ms": sum(
                r["ms"] * (6 if "x6" in r["matrix"] else 5 if "x5" in
                           r["matrix"] else 1) for r in res),
            "resnet20_inference_fused_ms": sum(
                r["fused_ms"] * (6 if "x6" in r["matrix"] else 5 if "x5" in
                                 r["matrix"] else 1) for r in res)}


def cnn_path(torch, K, model, dev, stats, path, hw, channels, mode,
             n_deploy, n_infer):
    """Deploy `model` (init seeded 0) on CNN_CAL calibration images and run
    chip inference on CNN_BATCH images, with the launch counts set to 0
    just before the deploy and read after it and after the inference:
    exactly n_deploy and n_deploy + n_infer single-matrix launches. Then
    the plain rerun (equal logits) and the software path's top-1."""
    from repro_torch.core.types import CIMConfig
    from repro_torch.data import cluster_images
    from repro_torch.obs.clock import stopwatch
    cfg = CIMConfig(in_bits=4, out_bits=8)
    gen = torch.Generator(dev).manual_seed(0)
    x, labels = cluster_images(gen, CNN_CAL + CNN_BATCH, hw=hw,
                               channels=channels)
    x_cal, x = x[:CNN_CAL], x[CNN_CAL:]
    params = (model.init_full(gen, x_cal[:2]) if hasattr(model, "init_full")
              else model.init(gen, in_ch=channels))
    want = {k: 0 for k in K.LAUNCHES}
    reset_launches(K)                    # the path's run starts here
    with stopwatch() as sw:
        states = model.deploy(params, cfg, x_cal, mode=mode, generator=gen)
        torch.cuda.synchronize()
    after_deploy = dict(K.LAUNCHES)
    logits = model.chip_apply(states, params, x, cfg)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)          # ... and ends here
    stats["launches"][path] = launches
    if after_deploy != dict(want, cim_mvm=n_deploy) or \
            launches != dict(want, cim_mvm=n_deploy + n_infer):
        raise AssertionError(f"{path}: launches {after_deploy} after deploy"
                             f", {launches} after inference; the path needs "
                             f"{n_deploy} + {n_infer} cim_mvm")
    if tuple(logits.shape) != (CNN_BATCH, 10) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{path}: logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    plain = model.chip_apply(states, params, x, cfg, impl="plain")
    if not torch.equal(plain, logits):
        raise AssertionError(f"{path}: the plain rerun's logits differ by "
                             f"{float((plain - logits).abs().max())}")
    if dict(K.LAUNCHES) != launches:
        raise AssertionError(f"{path}: the plain rerun launched a kernel")
    infer = lambda: model.chip_apply(states, params, x, cfg)
    ms = median_ms(torch, infer, 5)
    # its device time by kernel is read in the profile phase
    stats["profile_cnn"].append((path, infer, ms))
    soft = model.apply(params, x)
    soft = soft[0] if isinstance(soft, tuple) else soft
    agree = float((soft.argmax(-1) == logits.argmax(-1)).float().mean())
    return {"mode": mode, "images": [CNN_BATCH, hw, hw, channels],
            "launches": launches, "deploy_s": sw.s, "inference_ms": ms,
            "top1_agreement_chip_vs_software": agree,
            "top1_vs_labels_untrained": float(
                (logits.argmax(-1) == labels[CNN_CAL:]).float().mean()),
            "layers": len(states)}


@phase("cnn7")
def cnn7_phase(torch, K, dev, stats):
    from repro_torch.models import cnn7
    out = {}
    for mode in ("relaxed", "writeverify"):
        out[mode] = cnn_path(torch, K, cnn7, dev, stats, f"cnn7-{mode}", 28,
                             1, mode, 6, 7)
        free(torch)
    return out


@phase("resnet20")
def resnet20_phase(torch, K, dev, stats):
    from repro_torch.models import resnet20
    out = cnn_path(torch, K, resnet20, dev, stats, "resnet20-relaxed", 32, 3,
                   "relaxed", 21, 22)
    free(torch)
    return out


def train_step_ms(torch, step, params, data, gen, batch, reps=10):
    """Median CUDA-event ms of one train step (host included) on a fixed
    batch, from a copy of the optimizer state (the params are not
    kept)."""
    from repro_torch.train.optimizer import adamw_init
    x, y = data
    xb, yb = x[:batch], y[:batch]
    opt = adamw_init(params)
    step(params, opt, xb, yb, gen)
    return median_ms(torch, lambda: step(params, opt, xb, yb, gen), reps)


def check_plain(torch, a, b, what):
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: the plain rerun differs by "
                             f"{float((a - b).abs().max())}")


def top1(torch, logits, labels):
    return float((logits.argmax(-1) == labels).to(torch.float32).mean())


@phase("train-cnn7")
def train_cnn7_phase(torch, K, dev, stats):
    """cnn7 at 28x28x1 trained with the noise-resilient recipe, then chip
    inference on the relaxed chip: the launches of deploy and inference
    counted, logits equal to the plain rerun."""
    from repro_torch.core.types import CIMConfig
    from repro_torch.data import cluster_images
    from repro_torch.models import cnn7
    from repro_torch.obs.clock import stopwatch
    from repro_torch.train import noisy
    c = TRAIN_CNN7
    x, y = cluster_images(torch.Generator(dev).manual_seed(0), c["train"],
                          hw=c["hw"])
    xt, yt = cluster_images(torch.Generator(dev).manual_seed(99), c["test"],
                            hw=c["hw"])
    params = cnn7.init_full(torch.Generator(dev).manual_seed(1), x[:2])
    with stopwatch() as sw:
        params, losses = noisy.train(
            torch.Generator(dev).manual_seed(2), params, cnn7.apply, (x, y),
            steps=c["steps"], batch=c["batch"], noise_frac=c["noise"],
            lr=c["lr"])
        torch.cuda.synchronize()
    gen = torch.Generator(dev).manual_seed(3)
    clean_ms = train_step_ms(torch, noisy.make_train_step(
        cnn7.apply, 0.0, c["lr"]), params, (x, y), gen, c["batch"])
    noisy_ms = train_step_ms(torch, noisy.make_train_step(
        cnn7.apply, c["noise"], 0.3 * c["lr"]), params, (x, y), gen,
        c["batch"])
    with torch.no_grad():
        soft = cnn7.apply(params, xt)
        sweep = noisy.eval_under_noise(
            torch.Generator(dev).manual_seed(4), params, cnn7.apply,
            (xt, yt), (0.0, 0.1, 0.2), n_trials=3)
        cfg = CIMConfig(in_bits=4, out_bits=8)
        reset_launches(K)                # the path's run starts here
        states = cnn7.deploy(params, cfg, x[:c["cal"]], mode="relaxed",
                             generator=torch.Generator(dev).manual_seed(5))
        chip = cnn7.chip_apply(states, params, xt, cfg)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)      # ... and ends here
        stats["launches"]["train-cnn7"] = launches
        if launches != dict({k: 0 for k in K.LAUNCHES}, cim_mvm=13):
            raise AssertionError(f"train-cnn7: launches {launches}, the "
                                 "path needs 6 + 7 cim_mvm")
        check_plain(torch, chip, cnn7.chip_apply(states, params, xt, cfg,
                                                 impl="plain"),
                    "train-cnn7 chip inference")
    tenth = max(1, len(losses) // 10)
    first, last = (sum(v) / tenth for v in (losses[:tenth], losses[-tenth:]))
    if not last < first or not bool(torch.isfinite(chip).all()):
        raise AssertionError(f"train-cnn7: mean loss of the first tenth "
                             f"{first}, of the last {last}; or chip logits "
                             "not finite")
    stats["cnn7_trained"] = (params, x, y, xt, yt)
    return {"images": [c["train"], c["hw"], c["hw"], 1],
            "steps": c["steps"], "batch": c["batch"], "train_s": sw.s,
            "ms_per_step_clean": clean_ms, "ms_per_step_noisy": noisy_ms,
            "loss_first": losses[0], "loss_last": losses[-1],
            "software_top1": top1(torch, soft, yt),
            "top1_under_weight_noise": sweep,
            "chip_top1_relaxed": top1(torch, chip, yt),
            "top1_agreement_chip_vs_software": float(
                (chip.argmax(-1) == soft.argmax(-1)).float().mean()),
            "launches": launches, "test_images": c["test"]}


def finetune_path(torch, K, dev, cnn7, cfg, params, data, test, plain):
    """Accuracy on the chip without and with progressive fine-tuning, the
    seconds and cim_mvm launches of each stage; with `plain`, each stage's
    deploy (from the same generator state) and chip prefix rerun through
    the plain version and held equal."""
    from repro_torch.train.chip_in_loop import progressive_finetune
    from repro_torch.train.noisy import accuracy
    from repro_torch.obs.clock import now
    c = CHIP_IN_LOOP
    x, y = data
    xt, yt = test
    with torch.no_grad():
        s0 = cnn7.deploy_upto(params, cfg, x[:c["cal"]], cnn7.N_STAGES,
                              generator=torch.Generator(dev).manual_seed(5))
        acc0 = float(accuracy(cnn7.chip_prefix(s0, params, xt,
                                               cnn7.N_STAGES, cfg), yt))
    marks, launches = [], []

    def deploy(g, p, cf, xc, upto):
        torch.cuda.synchronize()
        marks.append(now())
        launches.append(K.LAUNCHES["cim_mvm"])
        state = g.get_state()
        s = cnn7.deploy_upto(p, cf, xc, upto, generator=g)
        if plain:
            g2 = torch.Generator(dev)
            g2.set_state(state)
            sp = cnn7.deploy_upto(p, cf, xc, upto, generator=g2,
                                  impl="plain")
            for n in s:
                for f in ("g_pos", "g_neg", "v_decr", "adc_offset"):
                    check_plain(torch, getattr(s[n].layer, f),
                                getattr(sp[n].layer, f),
                                f"chip-in-loop stage {upto} deploy {n} {f}")
        return s

    def prefix(s, p, xx, upto):
        h = cnn7.chip_prefix(s, p, xx, upto, cfg)
        if plain:
            check_plain(torch, h, cnn7.chip_prefix(s, p, xx, upto, cfg,
                                                   impl="plain"),
                        f"chip-in-loop stage {upto} chip_prefix")
        return h

    states, ft, accs = progressive_finetune(
        torch.Generator(dev).manual_seed(5), dict(params), cfg, x, y,
        deploy_upto=deploy, chip_prefix=prefix, soft_suffix=cnn7.soft_suffix,
        n_stages=cnn7.N_STAGES, noise_frac=c["noise"], ft_steps=c["ft_steps"],
        lr=c["lr"])
    torch.cuda.synchronize()
    marks.append(now())
    launches.append(K.LAUNCHES["cim_mvm"])
    with torch.no_grad():
        acc1 = float(accuracy(cnn7.chip_prefix(states, ft, xt,
                                               cnn7.N_STAGES, cfg), yt))
    return {"test_top1_no_finetune": acc0, "test_top1_finetuned": acc1,
            "train_top1_per_stage": accs,
            "s_per_stage": [b - a for a, b in zip(marks, marks[1:])],
            "cim_mvm_launches_per_stage": [b - a for a, b in
                                           zip(launches, launches[1:])]}


@phase("chip-in-loop")
def chip_in_loop_phase(torch, K, dev, stats):
    """Progressive fine-tuning of the trained cnn7 on two chips: the Fig.
    3f chip (IR drop and an ADC offset spread: the bit-serial oracle, no
    kernel launch) and a relaxed one (every stage's deploy and chip prefix
    through cim_mvm, held against the plain version)."""
    from repro_torch.core.types import CIMConfig, NonIdealityConfig
    from repro_torch.models import cnn7
    if "cnn7_trained" not in stats:
        raise AssertionError("chip-in-loop needs the train-cnn7 model")
    params, x, y, xt, yt = stats["cnn7_trained"]
    n = CHIP_IN_LOOP["train"]
    data = (x[:n], y[:n])
    out = {}
    for name, ni, plain in (
            ("fig3f", NonIdealityConfig(ir_drop_alpha=4e-5,
                                        adc_offset_sigma=0.004), False),
            ("relaxed", NonIdealityConfig(), True)):
        cfg = CIMConfig(in_bits=4, out_bits=8, nonideal=ni)
        reset_launches(K)                # the path's run starts here
        res = finetune_path(torch, K, dev, cnn7, cfg, params, data,
                            (xt, yt), plain)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)      # ... and ends here
        stats["launches"][f"chip-in-loop-{name}"] = launches
        # per stage k: min(k, 6) convolutions run during the deploy, and
        # the prefix's min(k, 6) + (the fc at k = 7)
        want = [0] * 7 if name == "fig3f" else \
            [2 * min(k, 6) + (k == 7) for k in range(1, 8)]
        if res["cim_mvm_launches_per_stage"] != want:
            raise AssertionError(
                f"chip-in-loop {name}: launches per stage "
                f"{res['cim_mvm_launches_per_stage']}, the path needs {want}")
        out[name] = {**res, "launches": launches}
    return out


@phase("train-resnet20")
def train_resnet20_phase(torch, K, dev, stats):
    """ResNet-20 at 32x32x3: clean steps with BN state, partial deploys
    stopping at the first layer past `upto`, chip inference through the
    kernel equal to the plain rerun."""
    from repro_torch.core.types import CIMConfig
    from repro_torch.data import cluster_images
    from repro_torch.models import resnet20
    from repro_torch.obs.clock import stopwatch
    from repro_torch.train import noisy
    from repro_torch.train.optimizer import tree_leaves
    c = TRAIN_RESNET20
    x, y = cluster_images(torch.Generator(dev).manual_seed(0), c["train"],
                          hw=c["hw"], channels=3)
    xt, yt = cluster_images(torch.Generator(dev).manual_seed(99),
                            CNN_BATCH, hw=c["hw"], channels=3)
    init = resnet20.init(torch.Generator(dev).manual_seed(1))
    with stopwatch() as sw:
        params, losses = noisy.train(
            torch.Generator(dev).manual_seed(2), init, resnet20.apply,
            (x, y), steps=c["steps"], batch=c["batch"], noise_frac=0.0,
            has_bn_state=True)
        torch.cuda.synchronize()
    step_ms = train_step_ms(torch, noisy.make_train_step(
        resnet20.apply, 0.0, 1e-3, has_bn_state=True), params, (x, y),
        torch.Generator(dev).manual_seed(3), c["batch"])
    bns = [k for k in params if isinstance(params[k], dict)
           and "mean" in params[k]]
    moved = min(float((params[k]["mean"] - init[k]["mean"]).abs().max())
                for k in bns)
    if not moved > 0 or any(t.requires_grad for t in tree_leaves(params)):
        raise AssertionError("train-resnet20: a BN running mean did not "
                             "move, or a param keeps autograd history")
    cfg = CIMConfig(in_bits=4, out_bits=8)
    names = resnet20.conv_layers(params)
    upto = {}
    with torch.no_grad():
        for k in c["uptos"]:
            reset_launches(K)
            states = resnet20.deploy(
                params, cfg, x[:c["cal"]], upto=k,
                generator=torch.Generator(dev).manual_seed(4))
            torch.cuda.synchronize()
            n = K.LAUNCHES["cim_mvm"]
            # every programmed convolution runs once on the chip
            if list(states) != names[:k] or n != min(k, len(names) - 1):
                raise AssertionError(f"train-resnet20: deploy(upto={k}) "
                                     f"gave {list(states)} in {n} launches")
            upto[k] = {"layers": len(states), "launches": n}
        reset_launches(K)                # the path's run starts here
        chip = resnet20.chip_apply(states, params, xt, cfg)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)      # ... and ends here
        stats["launches"]["train-resnet20"] = launches
        if launches != dict({k: 0 for k in K.LAUNCHES}, cim_mvm=22):
            raise AssertionError(f"train-resnet20: inference launches "
                                 f"{launches}, the path needs 22 cim_mvm")
        check_plain(torch, chip, resnet20.chip_apply(states, params, xt, cfg,
                                                     impl="plain"),
                    "train-resnet20 chip inference")
        soft, _ = resnet20.apply(params, xt)
    return {"steps": c["steps"], "batch": c["batch"], "train_s": sw.s,
            "ms_per_step": step_ms, "loss_first": losses[0],
            "loss_last": losses[-1], "bn_running_mean_moved_min": moved,
            "deploy_upto": upto, "launches": launches,
            "software_top1": top1(torch, soft, yt),
            "chip_top1_relaxed": top1(torch, chip, yt)}


@phase("lstm")
def lstm_phase(torch, K, dev, stats):
    """The 4-cell LSTM at paper geometry trained on keyword MFCCs, a
    relaxed deploy, chip inference (n_cells * (2 T + 1) launches, equal to
    the plain rerun), and its three matrix shapes timed against their
    bound."""
    from repro_torch.core import cim
    from repro_torch.core.types import CIMConfig
    from repro_torch.data import keyword_mfcc
    from repro_torch.models import lstm
    from repro_torch.obs.clock import stopwatch
    from repro_torch.train import noisy
    c = LSTM
    x, y = keyword_mfcc(torch.Generator(dev).manual_seed(0), c["train"])
    xt, yt = keyword_mfcc(torch.Generator(dev).manual_seed(9), c["test"])
    params = lstm.init(torch.Generator(dev).manual_seed(1))

    def apply_fn(p, xx, generator=None, noise_frac=0.0, train=False):
        return lstm.apply(p, xx, generator=generator, noise_frac=noise_frac)
    with stopwatch() as sw:
        params, losses = noisy.train(
            torch.Generator(dev).manual_seed(2), params, apply_fn, (x, y),
            steps=c["steps"], batch=c["batch"], noise_frac=c["noise"],
            lr=c["lr"])
        torch.cuda.synchronize()
    gen = torch.Generator(dev).manual_seed(3)
    step_ms = {nf: train_step_ms(torch, noisy.make_train_step(
        apply_fn, nf, c["lr"]), params, (x, y), gen, c["batch"], reps=5)
        for nf in (0.0, c["noise"])}
    cfg = CIMConfig(in_bits=4, out_bits=8)
    with torch.no_grad():
        soft = apply_fn(params, xt)
        states = lstm.deploy(params, cfg, x[:c["cal"]],
                             generator=torch.Generator(dev).manual_seed(4))
        t = x.shape[1]
        n_launch = lstm.N_CELLS * (2 * t + 1)
        reset_launches(K)                # the path's run starts here
        chip = lstm.chip_apply(states, params, xt, cfg)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)      # ... and ends here
        stats["launches"]["lstm"] = launches
        if launches != dict({k: 0 for k in K.LAUNCHES}, cim_mvm=n_launch):
            raise AssertionError(f"lstm: launches {launches}, the path "
                                 f"needs {n_launch} cim_mvm")
        check_plain(torch, chip, lstm.chip_apply(states, params, xt, cfg,
                                                 impl="plain"),
                    "lstm chip inference")
        if not bool(torch.isfinite(chip).all()):
            raise AssertionError("lstm: chip logits not finite")
        infer = lambda: lstm.chip_apply(states, params, xt, cfg)
        ms = median_ms(torch, infer, 3)
        # its device time by kernel is read in the profile phase
        stats["profile_cnn"].append(("lstm", infer, ms))
        shapes = lstm_shapes(torch, K, cim, cfg, states, xt, dev, stats)
    return {"cells": lstm.N_CELLS, "hidden": lstm.HIDDEN, "t": t,
            "features": x.shape[2], "classes": lstm.N_CLASSES,
            "steps": c["steps"], "batch": c["batch"], "train_s": sw.s,
            "ms_per_step_clean": step_ms[0.0],
            "ms_per_step_noisy": step_ms[c["noise"]],
            "loss_first": losses[0], "loss_last": losses[-1],
            "software_top1": top1(torch, soft, yt),
            "chip_top1_relaxed": top1(torch, chip, yt),
            "top1_agreement_chip_vs_software": float(
                (chip.argmax(-1) == soft.argmax(-1)).float().mean()),
            "launches": launches, "inference_ms": ms, "shapes": shapes}


def lstm_shapes(torch, K, cim, cfg, states, xt, dev, stats):
    """Cell 0's three matrices at the test batch: the fused forward held
    against its plain version in every activation it takes, then timed
    (L2 flushed) beside its bound."""
    import dataclasses
    gen = torch.Generator(dev).manual_seed(6)
    flush = torch.empty(64 * 1024 * 1024, device=dev)   # 256 MB > L2
    rows = {}
    m = xt.shape[0]
    for name in ("ih", "hh", "ho"):
        cl = states[f"cell0_{name}"]
        lay = cl.layer
        k, n = lay.gd.shape
        xf = torch.randn(m, k - cl.bias_rows, generator=gen, device=dev)
        for act in ACTIVATIONS:
            cf = dataclasses.replace(cfg, activation=act)
            check_equal(torch, cim.forward(lay, xf, cf, bias=cl.alpha,
                                           bias_rows=cl.bias_rows),
                        cim.forward(lay, xf, cf, bias=cl.alpha,
                                    bias_rows=cl.bias_rows, impl="plain"),
                        f"lstm {name} {act}", stats, "cim_mvm")
        run = lambda: cim.forward(lay, xf, cfg, bias=cl.alpha,
                                  bias_rows=cl.bias_rows)
        run_p = lambda: cim.forward(lay, xf, cfg, bias=cl.alpha,
                                    bias_rows=cl.bias_rows, impl="plain")
        ms = median_ms(torch, run, 20, flush)
        b_ms, b_by, nbytes, flops = cim_mvm_bound(m, k, n,
                                                  k - cl.bias_rows)
        g, grid = K.mvm_launch_geometry(m, k, n, k - cl.bias_rows, True,
                                        dev)
        rows[name] = {"m": m, "k": k, "n": n, "bias_rows": cl.bias_rows,
                      "ms": ms, "plain_ms": median_ms(torch, run_p, 5, flush),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "bound_share": b_ms / ms, "bytes": nbytes,
                      "flops": flops, "geometry": {**g.as_dict(),
                                                   "grid": grid}}
        emit({"phase": "kernel-shape", "kernel": "cim_mvm", "model": "lstm",
              "matrix": f"cell {name}", **rows[name]})
    t = stats["time"].setdefault("cim_mvm", {})
    t["lstm_ms"] = {k: r["ms"] for k, r in rows.items()}
    t["lstm_bound_ms"] = {k: r["bound_ms"] for k, r in rows.items()}
    return rows


def noisy_tol(torch, NK, x, w, sigma_frac, seed):
    """NOISY_TOL (module docstring) at the reference's default block."""
    k, n = w.shape
    sig = sigma_frac * w.abs().max()
    eps = NK.weight_noise_eps(k, n, seed, min(256, k), min(256, n), w.device)
    return (2 * k + 8) * 2.0 ** -24 * (x.abs() @ (w.abs() + sig * eps.abs()))


@phase("noisy-matmul")
def noisy_matmul_phase(torch, K, dev, stats):
    from repro_torch.kernels.noisy_matmul import kernel as NK, ops as nops
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(dev).manual_seed(14)
    data = {name: (torch.randn(m, k, generator=gen, device=dev),
                   torch.randn(k, n, generator=gen, device=dev) / k ** 0.5)
            for name, (m, k, n) in NOISY_SHAPES.items()}
    reset_launches(K)                    # the path's run starts here
    outs = {name: nops.noisy_matmul(x, w, 0.1, seed=3)
            for name, (x, w) in data.items()}
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)          # ... and ends here
    stats["launches"]["noisy-matmul"] = launches
    if launches != dict({k: 0 for k in K.LAUNCHES}, noisy_matmul=2):
        raise AssertionError(f"noisy-matmul: launches {launches}, the path "
                             "needs 2 noisy_matmul")
    err = stats["err"]
    cases = dict(data, ragged=(torch.randn(50, 300, generator=gen,
                                           device=dev),
                               torch.randn(300, 70, generator=gen,
                                           device=dev)))
    for name, (x, w) in cases.items():
        a = outs.get(name)
        a = nops.noisy_matmul(x, w, 0.1, seed=3) if a is None else a
        b = nops.noisy_matmul(x, w, 0.1, seed=3, impl="plain")
        d = (a - b).abs()
        err["noisy_matmul"] = max(err.get("noisy_matmul", 0.0),
                                  float(d.max()))
        if not bool((d <= noisy_tol(torch, NK, x, w, 0.1, 3)).all()):
            raise AssertionError(f"noisy-matmul {name}: outside NOISY_TOL "
                                 f"(max |err| {float(d.max())})")
        if not torch.equal(a, nops.noisy_matmul(x, w, 0.1, seed=3)):
            raise AssertionError(f"noisy-matmul {name}: not deterministic")
        if torch.equal(a, nops.noisy_matmul(x, w, 0.1, seed=4)):
            raise AssertionError(f"noisy-matmul {name}: seed 4 = seed 3")
        z = nops.noisy_matmul(x, w, 0.0)
        bound0 = (2 * x.shape[1] + 8) * 2.0 ** -24 * (x.abs() @ w.abs())
        if not bool(((z - x @ w).abs() <= bound0).all()):
            raise AssertionError(f"noisy-matmul {name}: sigma 0 is not x @ w")
    # the reference test's statistic (tests/test_kernels.py)
    x = torch.randn(64, 128, generator=gen, device=dev)
    w = torch.randn(128, 64, generator=gen, device=dev)
    d = nops.noisy_matmul(x, w, 0.1, seed=3, block=(64, 64, 64)) - x @ w
    pred = 0.1 * float(w.abs().max()) * float(
        torch.sqrt(torch.mean(torch.sum(x ** 2, dim=1))))
    ratio = float(d.std()) / pred
    if not 0.7 < ratio < 1.3:
        raise AssertionError(f"noisy-matmul: noise std ratio {ratio}")
    flush = torch.empty(64 * 1024 * 1024, device=dev)   # 256 MB > L2
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for name, (m, k, n) in NOISY_SHAPES.items():
        x, w = data[name]
        sig = 0.1 * w.abs().max()
        wn = NK.noisy_weight_plain(w, sig, seed=3, bk_ref=min(256, k),
                                   bn_ref=min(256, n))
        run_k = lambda: NK.noisy_matmul(x, w, sig, seed=3)
        run_k()
        ms = median_ms(torch, run_k, 20, flush)
        # each of the call's two kernels on the device, from the wrapper's
        # own launches
        tile = NK.sgemm_geometry(m, n, n_sm)
        weight_ms = profiled_ms(torch, run_k, "noisy_weight_kernel", 20,
                                flush)
        sgemm_ms = profiled_ms(torch, run_k, "noisy_sgemm", 20, flush)
        plain_ms = median_ms(
            torch, lambda: NK.noisy_matmul(x, w, sig, seed=3, impl="plain"),
            5, flush)
        mm_ms = median_ms(torch, lambda: torch.matmul(x, wn), 20, flush)
        nbytes = (m * k + k * n + m * n + 1) * 4
        flops = 2.0 * m * k * n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        # the weight pass's own bound: w read, w' written once
        w_bound = 2 * k * n * 4 / HBM_BYTES_PER_S * 1e3
        rows[name] = {"kernel": "noisy_matmul", "matrix": name, "m": m,
                      "k": k, "n": n, "ms": ms, "plain_ms": plain_ms,
                      "matmul_only_ms": mm_ms, "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations", "bound_share": max(t_bytes, t_ops)
                      / ms, "bytes": nbytes, "flops": flops,
                      "weight_ms": weight_ms, "weight_bound_ms": w_bound,
                      "sgemm_ms": sgemm_ms, "sgemm_tile": NK.SGEMM_TILES[tile],
                      "sgemm_blocks": NK.sgemm_blocks(m, n, tile)}
        emit({"phase": "kernel-shape", **rows[name]})
        del wn
    stats["time"]["noisy_matmul"] = {
        k: rows["gemma2-9b w_g training"][k]
        for k in ("ms", "plain_ms", "bound_ms", "bound_by", "matmul_only_ms",
                  "weight_ms", "sgemm_ms")}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    free(torch)
    return {"max_abs_err": err["noisy_matmul"], "noise_std_ratio": ratio,
            "peak_mem_gb": peak, "shapes": rows}


def kernels_line(stats):
    """The contract's kernels line: launches on each kernel's path (with
    every path's count beside it), max |err| against the plain version,
    and the kernel, plain and bound times of the shape noted in `at`."""
    at = {"cim_mvm_packed": "one full-width layer's seven projections at "
                            "M = 4 (a decode step, 6144-core chip; the "
                            "split route; walk_ms: the walk in this run; "
                            "prefill_*: the same at M = 256, the walk)",
          "cim_mvm_scheduled": "a merged full-width layer's three scheduled "
                               "projections (w_g, w_i, w_o) at M = 4 (a "
                               "decode step, 3072-core chip; the split "
                               "route; walk_ms: the walk in this run; "
                               "prefill_*: the same at M = 256, the walk)",
          "cim_mvm_transposed": "the RBM's h->v launch at paper geometry, "
                                "M = 64, the walk (CUDA-event window, host "
                                "work included; device_ms: the kernel "
                                "alone; bwd_ms: a full-width w_g / w_o bwd "
                                "at M = 4 and 256)",
          "cim_mvm": "one 7-layer CNN chip inference at 28x28, batch 256: "
                     "its 7 launches summed (relaxed conductances; "
                     "fused_host_us: the fused wrapper's host time for "
                     "them; lstm_ms: the LSTM's ih / hh / ho fused "
                     "launches at batch 512)",
          "noisy_matmul": "a gemma2-9b w_g in training, M 2048, K 3584, "
                          "N 14336, both kernels (weight_ms, sgemm_ms: "
                          "each one's device time in the call; "
                          "matmul_only_ms: torch.matmul on the "
                          "materialised noisy weight, no noise drawn)"}
    main_path = {"cim_mvm_packed": "serve",
                 "cim_mvm_scheduled": "serve-merged",
                 "cim_mvm_transposed": "recover-digital",
                 "cim_mvm": "cnn7-relaxed",
                 "noisy_matmul": "noisy-matmul"}
    paths = stats["launches"]
    rows = []
    for kernel in SOURCES:
        t = stats["time"].get(kernel, {})
        rows.append({
            "name": kernel, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel],
            "launches": paths.get(main_path[kernel], {}).get(kernel, 0),
            "launches_by_path": {p: c.get(kernel, 0)
                                 for p, c in paths.items()},
            "max_abs_err": stats["err"].get(kernel),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": None, "walk_ms": t.get("walk_ms"),
            "at": at[kernel],
            **{k: v for k, v in t.items()
               if k in ("device_ms", "bwd_ms", "matmul_only_ms",
                        "weight_ms", "sgemm_ms", "fused_ms", "fused_plain_ms",
                        "fused_bound_ms", "fused_host_us", "lstm_ms",
                        "lstm_bound_ms")
               or k.startswith("prefill_")},
            "ok": not failures})
    return {"kernels": rows}


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
    from repro_torch.kernels.cim_mvm import ops
    from repro_torch.launch import serve
    from repro_torch.obs.clock import stopwatch

    dev = serve.resolve_device("cuda")
    stats = {"err": {}, "time": {}, "launches": {}, "profile": [],
             "profile_cnn": []}
    info = device_phase(torch)
    stats["smi"] = info["nvidia_smi"] if info else "not measured"
    if build_phase(K, stopwatch) is None:
        return 1
    kernel_phase(torch, K, cim, CIMConfig, CoreSpec, dev, stats)
    free(torch)
    kernel_runs_phase(torch, K, ops, cim, CIMConfig, CoreSpec, dev, stats)
    free(torch)
    smoke_phase(torch, serve, dev)      # also loads the model's CUDA modules
    for path, conf, routes, text in SERVE_PATHS:
        phase(path)(serve_path)(torch, K, ops, serve, dev, stats, path, conf,
                                routes, text)
    for path, conf, routes in TRAFFIC_PATHS:
        phase(path)(traffic_path)(torch, K, serve, dev, stats, path, conf,
                                  routes)
    recover_phase(torch, K, dev, stats)
    chip_linear_phase(torch, K, cim, CIMConfig, dev, stats)
    free(torch)
    cnn7_phase(torch, K, dev, stats)
    resnet20_phase(torch, K, dev, stats)
    train_cnn7_phase(torch, K, dev, stats)
    chip_in_loop_phase(torch, K, dev, stats)
    stats.pop("cnn7_trained", None)
    free(torch)
    train_resnet20_phase(torch, K, dev, stats)
    free(torch)
    lstm_phase(torch, K, dev, stats)
    free(torch)
    noisy_matmul_phase(torch, K, dev, stats)
    profile_phase(torch, dev, stats)

    emit(kernels_line(stats))
    if failures or info is None:
        print(f"chip_smoke.py: failed phases: {failures}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
