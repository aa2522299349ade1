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
                projections per M on both routes; then the shapes of the
                other archs that no gemma2-9b layer has (qwen2-72b's w_o,
                K = 29568: 231 tiles of 128 x 256 per column block;
                its w_g, N = 29568: a half-live last column block;
                granite-20b's MQA wk, N = 128: one half-live column
                block of 48 tiles), each on a chip of its own, against
                the plain version in the same way and timed at the same M
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
  serve-traffic continuous batching (launch/scheduler) of the serve
                model's width, 2 layers: slots 4, chunk 32, 16 requests
                from `traffic_requests` seeded 1 (prompts 32-64 in pages
                of 32, 16-32 tokens, 50 req/s, realtime); one decode
                capture; packed launches exactly 14 per chunk and decode
                step call, and on the device (profiler) 14 term passes
                and folds per replay, 14 walks in a 32-row chunk, 14 term
                passes and folds in a 16-row one; a second engine on the same chip (prompts of
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
                kernel through the pool), 2 layers, 8 requests (the same
                generator and seed)
  recover       Bayesian image recovery at paper geometry (784 pixels + 10
                labels, 120 hidden units), batch 64, 10 Gibbs cycles:
                digital, stochastic and pixel-interleaved runs, launches
                counted per run, a plain rerun from the same seeds; then
                the entry point with --metrics-out, read back: fwd and bwd
                energies positive, finite and equal to the chip meter's
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
                100 steps of 64 at lr 3e-3, noise 0.15 after a clean half;
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
  engine        core.CIMEngine on two full-width gemma2-9b matrices (w_g,
                w_o; relaxed, 4096 cores, a clip per matrix and direction):
                forward launches at M = 4 and 64, transposed at 4 and 64,
                each bit for bit against its plain version; then
                core.multicore_mvm_packed(cfg=None), the exact tiled
                matmul, on the w_g plan at M = 4 and 32: bit for bit
                against its plain version, and within f32 rounding of
                torch.matmul (TF32 off)
  serve-moe     full-width deepseek-moe-16b (2 of 28 layers, random
                weights from a seed) on 2048 cores: one chip per layer
                (attention and shared experts) and one per (layer,
                expert), all single-pass; batch 4, prompt 64, 8 tokens;
                launches (4 + 3 + 3 x 64) per layer and token, all packed
                (static prefill: 30 rows per expert group, the walk;
                decode: 4, the split route); prefill and two decode steps
                rerun through the plain versions, logits equal
  serve-moe-merged  1 layer on 260 cores: the layer chip's seven
                projections and each expert's ew_g and ew_i merged into
                passes (scheduled kernel), ew_o single-pass (packed); 4
                tokens; the same checks
  serve-traffic-moe  the serve-moe chips behind the engine (slots 4, chunk
                32, 8 requests drawn as serve-traffic's): dropless dispatch
                forced by the engine, one capture, a replay equal to the
                eager step, every request equal to it served alone (no
                plain rerun of the stream and no static baseline: the
                plain MoE step is ~400 plain projections)
  profile-moe   the profile phase's windows for serve-moe and
                serve-moe-merged (they run after `profile`: their chips do
                not fit beside the dense models the profile phase holds)
  serve-rwkv6   full-width rwkv6-7b (4 of 32 layers, random weights from a
                seed) on 8192 cores: one chip per layer (wr wk wv wg wo cr
                ck cv, single-pass), the decay LoRA and the S recurrence
                float; batch 4, prompt 64, 32 tokens; launches 8 per layer
                and token, all packed (prefill: the walk; decode: the
                split route); prefill and two decode steps rerun through
                the plain versions, logits equal; peak memory with no
                other phase's chips held
  serve-traffic-rwkv6  serve-rwkv6's chips behind the engine (slots 4,
                chunk 32, the 16 requests of serve-traffic): one capture,
                launches per replay and per chunk (profiler), a probe
                engine's replay equal to the eager step (every slot live,
                then one frozen: its S, x_tm and x_cm unmoved), every
                request equal to it served alone (no plain rerun of the
                stream and no static baseline)
  profile-rwkv6 the profile phase's windows for serve-rwkv6, then its chips
                are freed
  serve-zamba2  full-width zamba2-7b, 6 of 81 layers (one group of mamba2
                layers and the shared attention block), 8192 cores: one
                chip per layer (in_proj out_proj w_g w_i w_o) and one for
                the shared block; batch 4, prompt 64, 8 tokens; 5 launches
                per layer and 7 per run of the block, per token; the same
                checks
  serve-traffic-zamba2  its chips behind the engine, chunk 64 (mamba2's
                scan chunk) on prompts of 64: the same checks (the frozen
                slot's h and KV unmoved)
  profile-zamba2  its profile windows (per projection the mean over the
                layers; the shared block's per run)
  batch-invariance  the outputs of RMSNorm's and attention's sums that
                move when a row shares a batch of 4 rather than running
                alone: in float32 (the reference's) and as the port sums
                them (float64, rounded once); reported, not checked
  serve-qwen2   full-width qwen2-72b (2 of 80 layers, float QKV bias) on
                32768 cores (a layer chip of 26,816 tiles, single-pass);
                batch 4, prompt 64, 16 tokens; 7 packed launches per
                layer and call; the same checks as serve-rwkv6
  serve-traffic-qwen2  its chips behind the engine (slots 4, chunk 32, the
                16 requests of serve-traffic): as serve-traffic-rwkv6
  profile-qwen2 its profile windows, then its chips are freed
  serve-granite full-width granite-20b (2 of 52 layers, one KV head) on
                16384 cores, 8 tokens; the same checks; profile-granite
  serve-internvl2  internvl2-1b at full width and depth (24 layers, QKV
                bias) on 512 cores; its prefill runs 256 seeded
                vision-prefix embeddings through every layer into the
                cache (`steps.make_prefill_step`), then the 64-token
                prompt: 7 launches per layer more; 16 tokens; the plain
                rerun runs the prefix too; profile-internvl2
  serve-seamless  seamless-m4t-medium at full width and depth: the float
                encoder (12 layers) over 64 seeded frames, 12 decoder
                layers each on a 128-core chip (every projection merged
                into 4 passes: 7 scheduled launches per layer and call),
                float cross-attention to the memory in prefill and every
                decode step; 8 tokens; profile-seamless
  attention-long  the chunked online-softmax attention (above 8192 keys)
                at B 4, 64 heads / 8 KV of 128, KV 16384: one decode
                query, and 256 queries with a 4096-key window, against
                the dense formula in float64 (ATTN_ATOL), its time beside
                one scaled_dot_product_attention call
  attention     the dense path's attention kernel (kernels/attention) at
                ATTN_SHAPES (granite-20b's and deepseek-moe-16b's decode at
                16 slots and 256-row chunks, qwen2-72b's GQA decode,
                gemma2-9b's local layer), f32: against the plain path
                (ATTN_TOL), the median of 20 launches with L2 flushed
                beside its bound, the plain path's ms and one
                scaled_dot_product_attention call on the repeated KV
  train-lm      `launch/train.py` at qwen2-72b's full width (2 of 80
                layers, bf16 params, f32 moments), batch 8 x 128, 6 steps
                under --cim off and then noisy: losses finite, the modes'
                step-0 losses different, no CIM launch, the attention
                kernel once a layer and step, the state on the card;
                median step ms (CUDA events), forward / backward /
                optimizer ms and the noise draws, peak GB, tokens/s and
                model TFLOP/s (6 x matmul weights x tokens per step)
  train-lm-parity  one make_train_step on the card against the CPU from
                one state and batch, qwen2-72b smoke in float32, off and
                noisy: loss and gnorm within TRAIN_RTOL, params within
                TRAIN_PARAM_ATOL off rounding-sized gradients
  train-resume  FaultTolerantTrainer at smoke size, checkpoints every 2
                steps, a fault at step 5, resumed: bit for bit the
                uninterrupted 8-step run (a child process with
                deterministic algorithms); both step-8 checkpoints
                restored on the card, leaf for leaf equal
  serve-tp      tensor-parallel serving: full-width gemma2-9b (2 of 42
                layers) deployed at 'model' width 8 on a mesh that repeats
                cuda:0 (`launch/mesh.Mesh`): eight 768-core shard chips
                per layer, each projection split col / row with 756 tiles
                a shard (wq 56, wk 28, wv 28, wo 56, w_g w_i w_o 196, all
                single-pass), batch 4, prompt 64, 8 tokens; partitions and
                tiles checked, launches exactly 56 a layer and token;
                prefill and two decode steps rerun through the plain
                versions; the executor equal to its shards' launches
                combined in shard order, bit for bit; one layer's 56
                launches timed at M = 4 and 256 (each of the 56 alone,
                summed, and all in one window) beside the bound and the
                unsharded layer's times from the kernel phase; a profiled
                decode
  serve-tp-merged  1 layer on 384-core shard chips, 4 tokens: a shard's
                w_g, w_i and w_o merge into 4 passes each (the scheduled
                kernel), the other four stay single-pass; launches
                counted, plain rerun
  serve-tp-moe  full-width deepseek-moe-16b, 1 layer, width 8, 4 tokens:
                the layer chip in 8 shards and the 64 expert chips placed
                expert-parallel (8 a shard, each expert's chip on its
                shard's device); launches counted, plain rerun
  pool-tp       the engine over serve-tp's chips: one decode capture
                (56 launches a layer per replay), a replay equal to the
                eager step bit for bit, 4 requests each equal to it alone
                (tokens; logits within TRAFFIC_ATOL)
  replicas      `launch/env.launch` runs 2 ranks of the serve CLI
                (gemma2-9b, 1 layer, 6144 cores, --traffic, 8 requests of
                up to 8 tokens) as a gloo group on the one card, beside a
                solo run of the same command: the ranks' request ids
                partition the stream as `route_requests` says, each
                request's tokens and logits equal the solo run's bit for
                bit (no row's arithmetic depends on its neighbours: the
                pool's step always runs every slot, a prompt prefills
                alone in its slot), rank 0's merged summary counts 8
                requests
  serve-dp      the data axis: full-width gemma2-9b (2 of 42 layers) on a
                2 x 2 ('data', 'model') mesh that repeats cuda:0: one
                deploy of 3072-core 'model'-width-2 shard chips, a copy per
                data row (`nn.row_params`); batch 4 striped 2 a row,
                prompt 64, 8 tokens; launches exactly 2 rows x 2 shards x
                7 a layer and token; tokens equal the same chips' unstriped
                serve, logits within TRAFFIC_ATOL; a profiled striped
                decode
  pool-dp       serve-dp's chips behind the engine: slots 4 in 2 stripes,
                8 requests of 4-8 tokens; one capture per stripe (28
                launches a replay), a replay equal to the eager step with
                every slot live, every request equal to it alone and to the
                unstriped pool's run of the same stream (tokens; logits
                within TRAFFIC_ATOL)
  train-dp      full-width deepseek-moe-16b (1 of 28 layers, f32) with the
                expert-parallel FFN on a 2 x 4 mesh over cuda:0, batch 8 x
                128, accum 2, 2 steps: unmeshed, then grad_spec =
                zero_pspecs, data_axes ('data',) under each grad_sync;
                loss and gnorm within TRAIN_RTOL of the unmeshed step,
                params after each step within TRAIN_PARAM_ATOL where
                every unmeshed gradient so far is above TRAIN_GRAD_FLOOR
                of its norm or zero, else 2 lr a step; the EP FFN on
                the card against its CPU run (EP_RTOL, the same drops)
                and, at capacity 4 (nothing dropped), against moe_ffn
  train-production  `launch/train.py --arch qwen2-72b --layers 1 --steps 2
                --batch 8 --seq 128` with and without --production-mesh
                (16 x 16 over cuda:0): every leaf's shards where its spec
                puts them (views: nothing copied), losses equal within
                bf16 rounding
  autotune      `kernels/cim_mvm/autotune.tune` on a full-width gemma2-9b
                `w_g` (6144 cores, the packed kernel) at M = 4, 16 and 256
                and on serve-merged's `w_g` (scheduled) at 4 and 256: each
                route candidate's time (the tuner's default timer), every one
                bit for bit the default route, the winner, a serving call
                with the route left open that launches the winner and
                equals the default; the default's and the winner's time
                after an L2 flush; then `tune_tiling` on a 3584 x 2048
                layer at M = 16 on 4096 cores (9 tilings), each re-pack
                against its own plain version
  packed-unfused  `fused=False` against `fused=True` on serve-merged's
                `w_g`, `w_i`, `w_o`, an IR-drop `wq` (2048 cores, 2
                passes) and the RBM's h->v plan at paper geometry: bit for
                bit with the valid-column mask (integer counts: every
                activation but identity), each against its plain version
                in every activation, both timed at M = 4 and 256
  dryrun        `launch/dryrun.lower_cell` on gemma2-9b train_4k,
                prefill_32k, decode_32k and rwkv6-7b long_500k at full
                config on the 16 x 16 production mesh of meta devices:
                roofline terms and model_over_hlo per cell; no CUDA memory
                allocated
  examples      the four `repro_torch.examples` scripts on the card: their
                lines, wall seconds beside the card's name and power
                limit, their kernel launches, the RBM's L2 error falling
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

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP64_FLOPS_PER_S = 67e12         # H100 SXM FP64 peak (tensor cores; 34 on CUDA cores)
SMOKE_ATOL = 1e-4                # smoke logits are O(1); f32 roundings
TRAFFIC_ATOL = 1e-4              # LOGIT_ATOL of tests/test_torch_serve.py
SPIN_CYCLES = 1_000_000          # ~0.5 ms at 1.98 GHz: covers a wrapper's host time
PAD_KERNELS = 64                 # spin kernels a profiler window opens on
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
# 2 of serve's 4 layers, and serve-merged's with 8 requests: their plain
# reruns of the stream were the script's longest phases (PERF.md section 4
# names every cut)
TRAFFIC = dict(n_layers=2, cim_cores=6144, slots=4, chunk=32, requests=16,
               prompt_len=64, gen=32, rate=50.0)
TRAFFIC_MERGED = dict(TRAFFIC, cim_cores=3072, requests=8)
# deepseek-moe-16b at full width (d 2048, 64 routed experts of width 1408,
# top-6, 2 shared experts): one chip per layer (attention and shared
# experts: 1040 tiles) and one per (layer, expert) (280 tiles). 2048 cores
# keep every chip single-pass; on 260 (the fewest the layer chip fits) the
# layer chip's seven projections and each expert's ew_g and ew_i merge into
# passes, ew_o (88 tiles) stays single-pass
MOE = "deepseek-moe-16b"
MOE_EXPERTS = 64
SERVE_MOE = dict(n_layers=2, batch=4, prompt_len=64, gen=8, cim_cores=2048)
MERGED_MOE = dict(n_layers=1, batch=4, prompt_len=64, gen=4, cim_cores=260)
TRAFFIC_MOE = dict(TRAFFIC, n_layers=2, cim_cores=2048, requests=8)
# the CIMEngine phase: two full-width gemma2-9b matrices, both directions,
# a clip of their own per matrix and direction
ENGINE = dict(cores=4096, fwd_rows=(4, 64), bwd_rows=(4, 64),
              mvm_rows=(4, 32), alpha={"w_g": 3.0, "w_o": 2.0},
              alpha_bwd={"w_g": 1.5, "w_o": 2.5})
# projections per layer on each kernel (the plans the chips compile to)
SERVE_ROUTES = {"cim_mvm_packed": 7}
MERGED_ROUTES = {"cim_mvm_packed": 4, "cim_mvm_scheduled": 3}
IRDROP_ROUTES = {"cim_mvm_scheduled": 7}
SERVE_MOE_ROUTES = {"cim_mvm_packed": 4 + 3 + 3 * MOE_EXPERTS}
MERGED_MOE_ROUTES = {"cim_mvm_scheduled": 7 + 2 * MOE_EXPERTS,
                     "cim_mvm_packed": MOE_EXPERTS}
# the recurrent family at full width, on 8192-core chips (every chip
# single-pass): rwkv6-7b (d 4096, 64 heads of 64, d_ff 14336, vocab 65536;
# a layer chip of 6656 tiles: wr wk wv wg wo cr 512 each, ck cv 1792) and
# zamba2-7b (d 3584, 112 SSM heads of 64, state 64, d_ff 14336, vocab
# 32000; a layer chip of 7084 tiles: in_proj 1596, out_proj 784, w_g w_i
# w_o 1568 each; the shared attention block's chip 6272). zamba2 runs one
# full group of 6 layers and its shared block; its engine prefills in
# chunks of 64, its scan's chunk, on prompts of 64
RWKV, ZAMBA = "rwkv6-7b", "zamba2-7b"
SERVE_RWKV = dict(n_layers=4, batch=4, prompt_len=64, gen=32, cim_cores=8192)
SERVE_ZAMBA = dict(n_layers=6, batch=4, prompt_len=64, gen=8, cim_cores=8192)
TRAFFIC_RWKV = dict(TRAFFIC, n_layers=4, cim_cores=8192)
TRAFFIC_ZAMBA = dict(TRAFFIC, n_layers=6, cim_cores=8192, chunk=64)
RWKV_ROUTES = {"cim_mvm_packed": 8}
ZAMBA_ROUTES = {"cim_mvm_packed": 5}
# chips outside the layer stack, per arch: launches per run of the block
# (zamba2's shared block runs once per group of hybrid_attn_every layers)
SHARED_ROUTES = {ZAMBA: {"cim_mvm_packed": 7}}
# per recurrent arch: its static path, its engine path on the same chips
RECURRENT_PATHS = (
    (RWKV, "serve-rwkv6", SERVE_RWKV, "serve-traffic-rwkv6", TRAFFIC_RWKV,
     RWKV_ROUTES, "rwkv6-7b full width, 4 of 32 layers, 8192 cores"),
    (ZAMBA, "serve-zamba2", SERVE_ZAMBA, "serve-traffic-zamba2",
     TRAFFIC_ZAMBA, ZAMBA_ROUTES,
     "zamba2-7b full width, 6 of 81 layers (one group and the shared "
     "block), 8192 cores"))
# the dense, VLM and encoder-decoder archs at full width: qwen2-72b (d 8192,
# 64 heads / 8 KV of 128, d_ff 29568, vocab 152064, float QKV bias; a layer
# chip of 26,816 tiles, 878 M weights: 2 of 80 layers), granite-20b (d
# 6144, 48 heads / 1 KV of 128, d_ff 24576; 16,176 tiles: 2 of 52),
# internvl2-1b (d 896, 14 heads / 2 KV of 64, d_ff 4864, QKV bias; 501
# tiles; all 24 layers, its prefill running 256 seeded vision-prefix
# embeddings ahead of the prompt) and seamless-m4t-medium (d 1024, 16
# heads of 64, d_ff 4096; all 12 + 12 layers: a float encoder over 64
# seeded frames, then 12 decoder layers cross-attending its memory, each
# decoder chip's 512 tiles merged onto 128 cores, the fewest its planner
# accepts: every projection in 4 passes, on the scheduled kernel)
QWEN, GRANITE = "qwen2-72b", "granite-20b"
INTERNVL, SEAMLESS = "internvl2-1b", "seamless-m4t-medium"
SERVE_QWEN = dict(n_layers=2, batch=4, prompt_len=64, gen=16,
                  cim_cores=32768)
TRAFFIC_QWEN = dict(TRAFFIC, n_layers=2, cim_cores=32768)
SERVE_GRANITE = dict(n_layers=2, batch=4, prompt_len=64, gen=8,
                     cim_cores=16384)
SERVE_INTERNVL = dict(batch=4, prompt_len=64, gen=16, cim_cores=512,
                      vis_prefix=True)
SERVE_SEAMLESS = dict(batch=4, prompt_len=64, gen=8, cim_cores=128)
SEAMLESS_ROUTES = {"cim_mvm_scheduled": 7}
# per arch: its static path, its engine path on the same chips (None: the
# reference serves no pool for an encoder-decoder or a vision prefix)
ARCH_PATHS = (
    (QWEN, "serve-qwen2", SERVE_QWEN, "serve-traffic-qwen2", TRAFFIC_QWEN,
     SERVE_ROUTES, "qwen2-72b full width, 2 of 80 layers, 32768 cores"),
    (GRANITE, "serve-granite", SERVE_GRANITE, None, None, SERVE_ROUTES,
     "granite-20b full width, 2 of 52 layers, 16384 cores"),
    (INTERNVL, "serve-internvl2", SERVE_INTERNVL, None, None, SERVE_ROUTES,
     "internvl2-1b full width and depth (24 layers), 512 cores, a "
     "256-patch vision prefix"),
    (SEAMLESS, "serve-seamless", SERVE_SEAMLESS, None, None,
     SEAMLESS_ROUTES, "seamless-m4t-medium full width and depth (12 "
     "encoder + 12 decoder layers), 128 cores"))
# layer shapes of those archs that no gemma2-9b layer has, held against the
# plain version in the kernel phase before a served path runs them:
# qwen2-72b's w_o (K = 29568: 231 tiles of 128 x 256 per column block,
# gemma2-9b's most is 112), its w_g (N = 29568 = 115 * 256 + 128: a
# half-live last column block) and granite-20b's MQA wk (N = 128: one
# half-live column block of 48 tiles)
ARCH_SHAPES = {"qwen2-72b w_o": (29568, 8192), "qwen2-72b w_g": (8192, 29568),
               "granite-20b wk": (6144, 128)}
# the chunked online-softmax attention above 2 * ATTN_CHUNK keys, at
# qwen2-72b's heads: one decode query and a 256-query prefill with a
# sliding window, against the dense formula in float64 on the card
ATTN_LONG = dict(batch=4, heads=64, kv_heads=8, head_dim=128, kv=16384,
                 cases=((1, 0), (256, 4096)))
# the reference's bound for its chunked path against the dense one
# (tests/test_transformer.py): f32 sums over 16384 keys, O(1e-2) outputs
ATTN_ATOL = 2e-5
# each layer's projections in the model's call order
RWKV_ORDER = ("wr", "wk", "wv", "wg", "wo", "ck", "cr", "cv")
MAMBA_ORDER = ("in_proj", "out_proj", "w_g", "w_i", "w_o")
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
                         "noisy_matmul/csrc/noisy_matmul.cu"),
                        ("gqa_attention",
                         "attention/csrc/gqa_attention.cu"))}
REPLACES = {"cim_mvm_packed": "src/repro/kernels/cim_mvm/kernel.py:238",
            "cim_mvm_scheduled": "src/repro/kernels/cim_mvm/kernel.py:351",
            "cim_mvm_transposed": "src/repro/kernels/cim_mvm/kernel.py:466",
            "cim_mvm": "src/repro/kernels/cim_mvm/kernel.py:161",
            "noisy_matmul": "src/repro/kernels/noisy_matmul/kernel.py:44",
            # the reference's attention is plain jnp: no Pallas kernel
            "gqa_attention": "none (src/repro/models/transformer.py's "
                             "attention, plain jnp)"}
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
LSTM = dict(train=2048, test=512, batch=64, steps=100, noise=0.15, lr=3e-3,
            cal=16)
# LM training (`launch/train.py`) at qwen2-72b's full width, 2 of 80 layers
TRAIN_LM = ["--arch", "qwen2-72b", "--layers", "2", "--steps", "6",
            "--batch", "8", "--seq", "128", "--ckpt-every", "1000"]
TRAIN_LM_SPLIT_REPS = 3          # steps timed piece by piece after the run
TRAIN_PARITY = dict(batch=8, seq=128, lr=3e-4)   # qwen2-72b smoke, float32
TRAIN_RESUME = dict(batch=4, seq=64, steps=8, ckpt_every=2, fault_at=5)
# tensor-parallel serving: gemma2-9b at full width, 'model' width 8 on a mesh
# that repeats cuda:0. A shard chip holds 756 tiles (wq 56, wk 28, wv 28, wo
# 56, w_g w_i w_o 196): 768 cores keep it single-pass; on 384 its w_g, w_i
# and w_o merge into 4 passes each (the scheduled kernel), as on the
# unsharded 3072-core chip. deepseek-moe-16b's shard chip holds 152 tiles,
# each expert chip 280
TP = 8
SERVE_TP = dict(n_layers=2, batch=4, prompt_len=64, gen=8, cim_cores=768)
MERGED_TP = dict(n_layers=1, batch=4, prompt_len=64, gen=4, cim_cores=384)
MOE_TP = dict(n_layers=1, batch=4, prompt_len=64, gen=4, cim_cores=2048)
POOL_TP = dict(TRAFFIC, n_layers=2, cim_cores=768, requests=4, gen=8)
TP_ROUTES = {"cim_mvm_packed": 7 * TP}
MERGED_TP_ROUTES = {"cim_mvm_packed": 4 * TP, "cim_mvm_scheduled": 3 * TP}
MOE_TP_ROUTES = {"cim_mvm_packed": 7 * TP + 3 * MOE_EXPERTS}
TP_PARTITIONS = {"wq": "col", "wk": "col", "wv": "col", "wo": "row",
                 "w_g": "col", "w_i": "col", "w_o": "row"}
TP_TILES = {"wq": 56, "wk": 28, "wv": 28, "wo": 56, "w_g": 196, "w_i": 196,
            "w_o": 196}
TP_ROWS = (4, 256)               # a decode step, a prefill
# the data axis: gemma2-9b at full width on a 2 x 2 ('data', 'model') mesh
# that repeats cuda:0: two data rows, each with its own copy of the layer's
# 'model'-width-2 shard chips (3024 tiles a shard: wq 224, wk 112, wv 112,
# wo 224, w_g w_i w_o 784; 3072 cores keep them single-pass)
DP = {"data": 2, "model": 2}
SERVE_DP = dict(n_layers=2, batch=4, prompt_len=64, gen=8, cim_cores=3072)
POOL_DP = dict(TRAFFIC, n_layers=2, cim_cores=3072, slots=4, requests=8,
               gen=8)
DP_PER_LAYER = 7 * DP["model"]   # one row's packed launches a layer
# training on a mesh: deepseek-moe-16b at full width, 1 of 28 layers, f32,
# the expert-parallel FFN on a 2 x 4 mesh over cuda:0; qwen2-72b's CLI on
# the production mesh (16 x 16 over cuda:0)
TRAIN_DP = dict(mesh={"data": 2, "model": 4}, batch=8, seq=128, accum=2,
                steps=2, lr=1e-4)
TRAIN_PROD = ["--arch", "qwen2-72b", "--layers", "1", "--steps", "2",
              "--batch", "8", "--seq", "128"]
EP_RTOL = 1e-5
# the replicas' serve command (2 ranks and a solo run on the one card)
REPLICAS = ["--arch", "gemma2-9b", "--layers", "1", "--cim", "--cim-cores",
            "6144", "--traffic", "--requests", "8", "--gen", "8"]
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 peak (tensor cores)
# the card's step against the CPU's from one state (f32 sums in another
# order): loss and gnorm; params where every gradient entry is above 1e-4
# of the global norm (else Adam's first step is the sign of a rounding)
TRAIN_RTOL = 1e-5
TRAIN_PARAM_ATOL = 1e-6
# train-dp, meshed against unmeshed: params held at TRAIN_PARAM_ATOL where
# every step's unmeshed gradient so far is above this share of its norm or
# zero (the MoE's routed experts take gradients mostly under 1e-4 of it)
TRAIN_GRAD_FLOOR = 1e-6

# the float glue's attention kernel (`kernels/attention`), counted in
# LAUNCHES beside the CIM kernels: one launch a `transformer.attention` call
ATTN = "gqa_attention"
# the attention phase's shapes: name -> (B, Sq, H, Hkv, D, Sk, fill,
# window, softcap); every slot filled to `fill`, its rows ending there
# (granite-20b and deepseek-moe-16b as the chat cells run them, the chat
# mix's median fill beside the full slot; qwen2-72b's GQA; gemma2-9b's
# local layer with its softcap)
ATTN_SHAPES = {
    "granite decode 4096": (16, 1, 48, 1, 128, 4096, 4096, 0, 0.0),
    "granite decode 1400": (16, 1, 48, 1, 128, 4096, 1400, 0, 0.0),
    "granite chunk at 1000": (1, 256, 48, 1, 128, 4096, 1256, 0, 0.0),
    "granite chunk at 3840": (1, 256, 48, 1, 128, 4096, 4096, 0, 0.0),
    "deepseek decode 4096": (16, 1, 16, 16, 128, 4096, 4096, 0, 0.0),
    "deepseek decode 1400": (16, 1, 16, 16, 128, 4096, 1400, 0, 0.0),
    "deepseek chunk at 3840": (1, 256, 16, 16, 128, 4096, 4096, 0, 0.0),
    "qwen2 decode 4096": (16, 1, 64, 8, 128, 4096, 4096, 0, 0.0),
    "gemma2 local chunk at 7936": (1, 256, 16, 8, 256, 8192, 8192, 4096,
                                   50.0),
}
# the kernels line's row for the attention kernel reads this shape
ATTN_ROW = "granite decode 4096"
# |kernel - plain| over sum_k p_k |v_k| in f32 (tests/test_torch_attention)
ATTN_TOL = 2.0 ** -19

failures = []


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase(name):
    """Run a phase; a failure is printed and recorded, never swallowed.
    Each line carries the phase's wall seconds (`phase_s`): the script
    has a time limit to keep."""
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                emit({"phase": name, "ok": True,
                      "phase_s": time.perf_counter() - t0, **(out or {})})
                return out
            except Exception as e:          # reported, and fails the run
                traceback.print_exc()
                failures.append(name)
                emit({"phase": name, "ok": False,
                      "phase_s": time.perf_counter() - t0,
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


def attention_calls(cfg):
    """`transformer.attention` calls in one pass of `cfg`'s decoder: one a
    layer, zamba2's shared block once a group, none for RWKV."""
    if cfg.rwkv:
        return 0
    if cfg.hybrid_attn_every > 0:
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


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
                                "noisy_matmul", "gqa_attention")}}


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
        ident = re.search(r"\d+((?:cim|noisy|gqa)_[a-z_]+)", mangled)
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
    arch_rows = arch_shapes(torch, K, cim, CIMConfig, CoreSpec, dev, stats,
                            flush)
    sums = layer_sums(rows, PER_LAYER)
    edge = route_edge(K, "cim_mvm_packed", sums)
    t = stats["time"]["cim_mvm_packed"] = dict(sums[4], bound_by="bytes")
    t.pop("route")
    t.update({f"prefill_{k}": v for k, v in sums[256].items()
              if k != "route"})
    t["prefill_bound_by"] = common_bound(r for r in rows if r["m"] == 256)
    return {"shapes": len(rows), "arch_shapes": len(arch_rows),
            "max_abs_err": stats["err"]["cim_mvm_packed"],
            "decode_layer": sums[4], "prefill_layer": sums[256],
            "split_wins_up_to": edge["split_wins_up_to"]}


def arch_shapes(torch, K, cim, CIMConfig, CoreSpec, dev, stats, flush):
    """ARCH_SHAPES, each on a chip of its own (single-pass): the packed
    kernel against its plain version at COMPARE_ROWS, every activation,
    with the denorm and the valid-column mask (`compare_all`); timed at
    TIME_ROWS beside its bound (kernel-shape lines, `time_route`)."""
    from repro_torch.kernels.cim_mvm import ops
    gen = torch.Generator(dev).manual_seed(13)
    rows = []
    for label, (r, c) in ARCH_SHAPES.items():
        w = torch.randn(r, c, generator=gen, device=dev) / r ** 0.5
        chip = cim.compile_chip({"w": w}, CIMConfig(), CoreSpec(n_cores=8192),
                                "ideal", in_alpha=3.0, generator=gen)
        p = chip.layers["w"].packed
        if p.n_passes != 1:
            raise AssertionError(f"{label}: {p.n_passes} passes")
        for m in COMPARE_ROWS:
            x = torch.randint(-7, 8, (m, r), generator=gen,
                              device=dev).to(torch.float32)
            compare_all(torch, K, ops, p, x, label, stats, "cim_mvm_packed")
            if m in TIME_ROWS:
                rows.append(time_route(torch, K, ops, p, x, flush,
                                       "cim_mvm_packed", label, stats))
        del chip, w, p
    return rows


def route_name(K, m):
    return "split" if K.split_route(m) else "walk"


def time_walk(torch, K, p, x, kernel, run_split, flush, stats):
    """The walk's time on x (median of 20 after an L2 flush each), in the
    same run as the split route's, after checking that the walk's output
    equals the split route's bit for bit (on the split route's columns:
    `ops` cuts the last column block's padding, the launch keeps it)."""
    split = run_split()
    check_equal(torch, walk_call(K, p, x, kernel)[:, :split.shape[1]], split,
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


def marked_window(torch, lead, body):
    """The device events of body() in a torch.profiler (CUPTI) window, in
    start order. The profiler can miss the first kernels of its window (on
    the card it has missed a prefill's first walk launch, a decode
    replay's first split-route pair, and a lead launch with the marker
    after it), so the window opens on a pause, PAD_KERNELS short spin
    kernels and lead(), then a marker kernel (`torch.cuda._sleep`), and
    only what follows the last spin kernel is read. [] when the profiler
    shows no device events, None when it shows no spin kernel."""
    from torch.profiler import ProfilerActivity, profile
    lead()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(PAD_KERNELS):
            torch.cuda._sleep(50)
        lead()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)          # the marker
        body()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type.name == "CUDA"),
                    key=lambda e: e.time_range.start)
    if not events:
        return []
    marks = [e.time_range.end for e in events if "spin_kernel" in e.name]
    if not marks:
        return None
    return [e for e in events if e.time_range.start >= marks[-1]]


def marked_events(torch, what, lead, body):
    """`marked_window`'s events, where a window without its marker fails
    `what`."""
    events = marked_window(torch, lead, body)
    if events is None:
        raise AssertionError(f"{what}: the marker kernel is not in the "
                             "profile")
    return events


def profiled_ms(torch, fn, name, reps, flush):
    """Median device time of the kernel whose name holds `name`, one launch
    per call of fn, each call after an L2 flush (torch.profiler / CUPTI,
    `marked_window`): the kernel alone, without the wrapper's host work
    (and its cast of x to int8)."""
    def body():
        for _ in range(reps):
            flush.zero_()
            fn()
    us = [e.time_range.elapsed_us()
          for e in marked_window(torch, fn, body) or [] if name in e.name]
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


def layer0_chips(v):
    """Layer 0's chips of a deployed '<name>_cim' stack: one, one per
    expert, or one per tensor-parallel shard."""
    return v[0] if isinstance(v[0], list) else chips_of(v[0])


def chips_of(c):
    """The chips of one layer's projection: its shards, or itself."""
    return list(c.shards) if hasattr(c, "shards") else [c]


def token_launches(K, cfg, routes, arch):
    """Launches per kernel for one token through the model: `routes` per
    layer, and an arch's chips outside the stack (SHARED_ROUTES: zamba2's
    shared block, once per group); the attention kernel once per
    `transformer.attention` call (`attention_calls`)."""
    shared = SHARED_ROUTES.get(arch, {})
    runs = cfg.n_layers // cfg.hybrid_attn_every if shared else 0
    out = {k: routes.get(k, 0) * cfg.n_layers + shared.get(k, 0) * runs
           for k in K.LAUNCHES}
    out[ATTN] = attention_calls(cfg)
    return out


def chip_routes(chips):
    """Kernel -> chips that route to it, among `chips`."""
    got = {}
    for c in chips:
        r = c.packed.route()
        got[r] = got.get(r, 0) + 1
    return got


def serve_and_check(torch, K, ops, serve, dev, stats, path, conf, routes,
                    arch="gemma2-9b"):
    """Serve `conf` with the launch counts set to 0 just before and read
    just after. The chips must route as `routes` says (per layer, an
    expert stack counts one chip per expert; SHARED_ROUTES the chips
    outside the stack), and each kernel must launch once per chip, run
    of its layer or block, and token (a VLM's vision prefix: once more).
    Then prefill and two decode steps
    rerun through the plain versions on the same chip, fed the kernel
    run's tokens: logits equal. Returns (result, launches, plain err)."""
    reset_launches(K)                    # the path's run starts here
    res = serve.serve_static(arch, cim=True, device=str(dev), **conf)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)          # ... and ends here
    stats["launches"][path] = launches
    got = chip_routes(c for k, v in res.params["layers"].items()
                      if k.endswith("_cim") for c in layer0_chips(v))
    shared = chip_routes(v for k, v in res.params.get("shared_attn",
                                                      {}).items()
                         if k.endswith("_cim"))
    if got != routes or shared != SHARED_ROUTES.get(arch, {}):
        raise AssertionError(f"{path}: projections route {got} (shared "
                             f"{shared}), expected {routes}")
    # a VLM's vision prefix is one more pass through every layer
    calls = conf["gen"] + (res.vis_embeds is not None)
    want = {k: n * calls for k, n in
            token_launches(K, res.cfg, routes, arch).items()}
    if res.memory is not None:           # the encoder, once: its layers
        want[ATTN] += res.cfg.enc_layers
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
                                res.prompts, 3, dev, teacher=g.tokens[:, :2],
                                memory=res.memory, vis_embeds=res.vis_embeds)
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


def serve_path(torch, K, ops, serve, dev, stats, path, conf, routes, text,
               arch="gemma2-9b", queue="profile"):
    """One serve path: its timed run and plain rerun; the deployed model
    is kept for the profile phase (`queue`), which runs after the timed
    runs (a profiled window can slow the host's launches after it)."""
    torch.cuda.reset_peak_memory_stats(dev)
    res, launches, err = serve_and_check(torch, K, ops, serve, dev, stats,
                                         path, conf, routes, arch)
    stats[queue].append((path, res))
    return {"config": text, **serve_numbers(res, conf), "launches": launches,
            "plain_max_abs_logit_err": err,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "plans": plan_summary(res.params)}


def traffic_path(torch, K, serve, dev, stats, path, conf, routes,
                 arch="gemma2-9b", deployed=None, full=True):
    """Continuous batching of `conf` through the port's engine, with the
    launch counts set to 0 just before the run (warmup and capture
    included) and read just after; then the engine's checks (module
    docstring) and its times. deployed: a static serve path's result
    whose chips the engine serves instead of deploying its own; full:
    also the plain rerun of every request and the static baseline."""
    from repro_torch.launch import scheduler
    from repro_torch.launch.scheduler import ContinuousBatchingEngine
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(K)                    # the path's run starts here
    if deployed is None:
        res = serve.serve_traffic(arch, cim=True, device=str(dev),
                                  capture_logits=True, **conf)
    else:
        res = engine_traffic(serve, deployed, conf, dev)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)          # ... and ends here
    stats["launches"][path] = launches
    eng, st = res.engine, res.stats
    if eng.cfg.n_experts > 0 and not eng.cfg.moe_dropless:
        raise AssertionError(f"{path}: the engine serves {arch} with "
                             "capacity dispatch, not dropless")
    if st["decode_traces"] != 1:
        raise AssertionError(f"{path}: {st['decode_traces']} decode "
                             "captures, the contract is 1")
    # every prefill and decode call (warm-ups, the capture call's one
    # eager run, replays) runs each projection once per layer; the profiled
    # replays in traffic_times show the replays' kernels on the device
    decode = eng.stripes[0].decode
    runs = {"prefill": eng._prefill.calls, "decode": decode.calls}
    per_token = token_launches(K, eng.cfg, routes, arch)
    per_exec = sum(per_token.values())
    if sum(decode.fun.per_replay.values()) != per_exec:
        raise AssertionError(f"{path}: the captured step holds "
                             f"{decode.fun.per_replay} launches, the "
                             f"path needs {per_exec}")
    want = {k: n * sum(runs.values()) for k, n in per_token.items()}
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, the path needs "
                             f"{want} ({runs} executions)")
    # the attention kernel once a layer (zamba2: a group) and replay
    attn = decode.fun.per_replay.get(ATTN, 0)
    if attn != per_token[ATTN]:
        raise AssertionError(f"{path}: {attn} attention launches a replay, "
                             f"the path needs {per_token[ATTN]}")
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
    replay, probe, probe_len = replay_equals_eager(torch, res, eng)
    # each request alone on the static path with the engine's config (an
    # MoE arch's dropless dispatch), its engine's cache length
    alone_err = 0.0
    for r, max_len in [(r, eng.max_len) for r in res.requests] + \
            [(r, probe_len) for r in probe]:
        g = serve.greedy_decode(res.params, eng.cfg,
                                torch.as_tensor(r.prompt[None]).long()
                                .to(dev), r.max_new, dev, max_len=max_len)
        if g.tokens[0].tolist() != r.tokens:
            raise AssertionError(f"{path}: request {r.rid}'s pool tokens "
                                 f"{r.tokens} != alone {g.tokens[0]}")
        for a, b in zip(r.logits, g.logits):
            alone_err = max(alone_err, float(
                (torch.as_tensor(a) - b[0].cpu()).abs().max()))
    if alone_err > TRAFFIC_ATOL:
        raise AssertionError(f"{path}: pool vs alone logits differ by "
                             f"{alone_err} > {TRAFFIC_ATOL}")
    extra = {}
    if full:
        # the plain versions, every request (the probe's too) admitted as
        # soon as a slot frees
        plain = ContinuousBatchingEngine(
            eng.cfg.replace(cim_impl="plain"), res.params,
            n_slots=eng.n_slots, max_len=eng.max_len, chunk=eng.chunk,
            capture_logits=True)
        copies = [type(r)(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                          arrival=r.arrival) for r in res.requests + probe]
        plain.run(copies, realtime=False)
        for r, q in zip(res.requests + probe, copies):
            if q.tokens != r.tokens or any(
                    not (a == b).all() for a, b in zip(r.logits, q.logits)):
                raise AssertionError(f"{path}: request {r.rid}: the plain "
                                     "rerun's tokens or logits differ")
        del plain
        extra["plain_rerun"] = "equal"
    # the profiler counts the CIM kernels' device launches
    times = traffic_times(torch, eng, dev, per_exec - per_token[ATTN])
    if full:
        # the static baseline at equal load: the same requests in arrival
        # order, in lockstep batches of `slots`, left-padded, realtime
        copies = [type(r)(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                          arrival=r.arrival) for r in res.requests]
        static = scheduler.serve_static(eng.cfg, res.params, copies,
                                        batch=eng.n_slots,
                                        max_len=eng.max_len)
        extra["static_baseline"] = {k: static[k] for k in (
            "tokens", "wall_s", "tok_per_s", "p50_ms", "p99_ms",
            "utilization", "pj_per_token")}
    out = {"config": f"{arch} full width, {eng.cfg.n_layers} of "
                     f"{serve.configs.get(arch).n_layers} layers, "
                     f"{conf['cim_cores']} cores, slots {conf['slots']}, "
                     f"chunk {conf['chunk']}"
                     + (", the serve path's chips" if deployed else ""),
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
           "packed_launches_per_execution": per_token["cim_mvm_packed"],
           "launches_per_replay": decode.fun.per_replay,
           "attention_launches_per_replay": attn,
           "moe_dropless": eng.cfg.moe_dropless,
           "replay_vs_eager": replay, "alone_max_abs_logit_err": alone_err,
           **times, **extra,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del res, eng
    free(torch)
    return out


def engine_traffic(serve, deployed, conf, dev):
    """serve.serve_traffic's stream and engine on an already deployed
    static serve path's model (its chips, its config): a TrafficResult."""
    from repro_torch.launch.scheduler import ContinuousBatchingEngine
    cfg, params = deployed.cfg, deployed.params
    reqs, max_len = serve.traffic_stream(
        cfg, conf["requests"], prompt_len=conf["prompt_len"],
        gen=conf["gen"], chunk=conf["chunk"], rate=conf["rate"], device=dev)
    eng = ContinuousBatchingEngine(cfg, params, n_slots=conf["slots"],
                                   max_len=max_len, chunk=conf["chunk"],
                                   capture_logits=True)
    st = eng.run(reqs)
    return serve.TrafficResult(cfg, params, reqs, st, eng, deployed.deploy_s)


def replay_equals_eager(torch, res, eng):
    """A second engine on the same chip, warmed for chunks of c and c / 2
    rows (c the engine's chunk): one request per slot admitted and
    prefilled (prompts of c, 2c, 1.5c and c / 2 tokens cut from the
    traffic's: the 1.5c prompt's second chunk, c / 2 rows, lands at
    offset c; at c = 32 16 rows on the split route), then one replayed
    decode step held against the step function run eagerly on a clone of
    the pool, bit for bit — with every slot live, then with slot 0 frozen
    (its state must not move). The slots are freed, and the same prompts
    are served through the engine's run (realtime=False); those requests
    and the probe's cache length are returned for the checks the
    traffic's requests go through."""
    import numpy as np
    from repro_torch.launch.scheduler import ContinuousBatchingEngine, Request
    c = eng.chunk
    max_len = max(eng.max_len, 2 * c + 4)
    probe = ContinuousBatchingEngine(res.cfg, res.params,
                                     n_slots=eng.n_slots, max_len=max_len,
                                     chunk=c, capture_logits=True)
    stream = np.concatenate([r.prompt for r in res.requests])
    lens = [c, 2 * c, c * 3 // 2, c // 2][-eng.n_slots:]
    cuts = np.cumsum([0] + lens)
    prompts = [stream[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    probe.warmup({c, c // 2})
    probe.jitwatch.seal()
    for i, p in enumerate(prompts):
        probe._admit(Request(rid=1000 + i, prompt=p, max_new=4))
    while probe._jobs:
        probe._prefill_one_chunk(0.0)
    fills = probe.pool["len"].tolist()
    if c * 3 // 2 not in fills or len(set(fills)) < min(3, eng.n_slots):
        raise AssertionError(f"replay vs eager: fills {fills}, not mixed "
                             "with a half chunk")
    checked = []
    for frozen in (False, True):
        if frozen:
            probe._activate(probe.pool, 0, False)
        before = {k: v.clone() for k, v in probe.pool.items()}
        clone = {k: v.clone() for k, v in probe.pool.items()}
        logits, _ = probe.stripes[0].decode(probe.params,
                                            probe.pool)         # a replay
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
            "served_prompt_lens": [len(p) for p in prompts]}, served, max_len


def slot0(key, t):
    """Slot 0's part of the pool tensor `key` (the slot dim is axis 1 of
    the cache and the recurrent state, axis 0 of the bookkeeping)."""
    return t[0] if key in ("len", "active", "tok") else t[:, 0]


def kernel_counts(events):
    """Device launches of the CIM kernels among a profiler window's device
    events, by the name's stem: the split route's term pass and fold, the
    walk."""
    names = ("cim_tile_terms", "cim_fold_runs", "cim_walk")
    out = dict.fromkeys(names, 0)
    for e in events:
        for n in names:
            out[n] += n in e.name
    return out


def traffic_times(torch, eng, dev, per_exec):
    """On the idle pool (a step changes nothing there): the decode step
    replayed and run eagerly (CUDA events, median of 20, host included);
    the replays' device time by kernel and busy share (torch.profiler),
    where each of up to 10 replays (at most ~1000 CIM launches in all)
    must show `per_exec` term passes and folds of the split route on the
    device; and prefill chunks of c and c / 2
    rows (c the engine's chunk) on slot 0 through the step function
    (median of 5, slot reset before each), the last of each profiled:
    `per_exec` walks above 16 rows, `per_exec` term passes and folds at 16
    or fewer. Each profiled window opens on a lead call and a marker
    (`marked_window`)."""
    replay = lambda: eng.stripes[0].decode(eng.params, eng.pool)
    eager = lambda: eng._step(eng.params, eng.pool)
    for f in (replay, eager):
        f()
    replay_ms = median_ms(torch, replay, 20)
    eager_ms = median_ms(torch, eager, 20)
    torch.cuda.synchronize()
    # at most ~1000 CIM launches in the window: CUPTI dropped 74 of the
    # MoE step's 3980 term passes over 10 replays of ~4600 kernels each
    reps = max(1, min(10, 1000 // per_exec))

    def replays():
        for _ in range(reps):
            replay()
    events = marked_events(torch, "decode replays", replay, replays)
    by_name = device_us_by_kernel(events)
    busy = sum(by_name.values()) / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    counts = {"decode replays": (kernel_counts(events), {
        "cim_tile_terms": per_exec * reps, "cim_fold_runs": per_exec * reps,
        "cim_walk": 0})}
    chunk_ms = {}
    for n in (eng.chunk, eng.chunk // 2):
        toks = torch.zeros((1, n), dtype=torch.long, device=dev)
        times = []
        chunk = lambda: eng._prefill.fun(eng.params, eng.pool, toks, 0)
        for i in range(6):
            eng._reset(eng.pool, 0)
            if i == 5:
                fresh = lambda: (eng._reset(eng.pool, 0), chunk())
                events = marked_events(torch, f"prefill chunk {n}", fresh,
                                       fresh)
                split = n <= 16
                counts[f"prefill chunk {n}"] = (kernel_counts(events), {
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


def profile_served(torch, dev, stats, queue):
    """The profile phase's prefill and decode windows for the serve paths
    held in stats[queue], after their timed runs and the traffic path
    that serves their chips; each model freed after its windows."""
    out = {}
    while stats[queue]:
        path, res = stats[queue].pop(0)
        out[path] = {"prefill": profile_prefill(torch, res, dev),
                     **profile_decode(torch, res, dev)}
        del res
        free(torch)
    return out


@phase("engine")
def engine_phase(torch, K, dev, stats):
    """`core.CIMEngine` on two full-width gemma2-9b matrices (w_g, w_o),
    relaxed, programmed for both directions with a clip per matrix and
    direction (`ENGINE`), on a single-pass 4096-core chip: forward
    launches (packed kernel: split route at 4 rows, the walk at 64) and
    transposed ones (the walk), each held against its plain version bit
    for bit; then `core.multicore_mvm_packed(cfg=None)`, the exact tiled
    matmul, on the w_g plan over the weights rounded onto the 2^-23 grid
    with integer x (|x| <= 127, so every tile's FP64 dot is exact) at 4
    and 32 rows: bit for bit against its plain version, and against
    torch.matmul (TF32 off) within (K + 2) 2^-24 |x| @ |W|, the f32
    error bound of any summation order. Launches counted from the first
    engine launch to the last kernel launch."""
    from repro_torch.core import CIMEngine, multicore_mvm_packed
    from repro_torch.core.mapping import pack_tiles
    from repro_torch.core.types import CIMConfig, CoreSpec
    from repro_torch.obs.clock import stopwatch
    gen = torch.Generator(dev).manual_seed(11)
    shapes = {n: FULL_LAYER[n] for n in ("w_g", "w_o")}
    w = {n: torch.randn(r, c, generator=gen, device=dev) / r ** 0.5
         for n, (r, c) in shapes.items()}
    torch.cuda.reset_peak_memory_stats(dev)
    eng = CIMEngine(CIMConfig(), CoreSpec(n_cores=ENGINE["cores"]),
                    mode="relaxed", device=dev)
    with stopwatch() as sw:
        eng.program(w, in_alpha=ENGINE["alpha"], directions=("fwd", "bwd"),
                    in_alpha_bwd=ENGINE["alpha_bwd"], generator=gen)
        torch.cuda.synchronize()
    for d, want in (("fwd", ENGINE["alpha"]), ("bwd", ENGINE["alpha_bwd"])):
        got = {n: float(p.layer.in_alpha)
               for n, p in eng.chip.layers_for(d).items()}
        if got != want:
            raise AssertionError(f"engine {d} clips {got} != {want}")
    routes = {(n, d): eng.chip.layers_for(d)[n].packed.route()
              for n in shapes for d in ("fwd", "bwd")}
    wg = torch.round(w["w_g"] * 2.0 ** 23) / 2.0 ** 23
    pt = pack_tiles(eng.plan.tiles_for("w_g"), wg)
    calls = []                   # (what, kernel, x, launch, plain)
    for n, (r, c) in shapes.items():
        for d, rows, k in (("fwd", ENGINE["fwd_rows"], r),
                           ("bwd", ENGINE["bwd_rows"], c)):
            for m in rows:
                x = torch.randn(m, k, generator=gen, device=dev)
                calls.append((f"engine {n} {d} M={m}", routes[(n, d)], x,
                              lambda x, n=n, d=d, i="auto":
                              eng.forward(n, x, direction=d, impl=i)))
    for m in ENGINE["mvm_rows"]:
        x = torch.randint(-127, 128, (m, shapes["w_g"][0]), generator=gen,
                          device=dev).to(torch.float32)
        calls.append((f"multicore_mvm_packed w_g M={m}", "cim_mvm_packed",
                      x, lambda x, i="auto":
                      multicore_mvm_packed(x, pt, impl=i)))
    torch.cuda.synchronize()
    reset_launches(K)                    # the path's launches start here
    outs = [fn(x) for _, _, x, fn in calls]
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)          # ... and end here
    stats["launches"]["engine"] = launches
    want = {}
    for _, kernel, _, _ in calls:
        want[kernel] = want.get(kernel, 0) + 1
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"engine: launches {launches}, the calls "
                             f"need {want}")
    for (what, kernel, x, fn), y in zip(calls, outs):
        check_equal(torch, y, fn(x, i="plain"), what, stats, kernel)
    mm = {}
    for (what, _, x, _), y in zip(calls, outs):
        if what.startswith("multicore"):
            ref = x @ wg
            band = (wg.shape[0] + 2) * 2.0 ** -24 * (x.abs() @ wg.abs())
            err = (y - ref).abs()
            if bool((err > band).any()):
                raise AssertionError(f"{what}: off torch.matmul by more "
                                     "than f32 rounding")
            mm[what] = {"max_abs_err_vs_matmul": float(err.max()),
                        "max_err_over_bound": float((err / band).max())}
    out = {"config": "gemma2-9b " + " and ".join(
               f"{n} ({r} x {c})" for n, (r, c) in shapes.items())
               + f", relaxed, {ENGINE['cores']} cores, fwd and bwd",
           "program_s": sw.s, "routes": {f"{n} {d}": r
                                         for (n, d), r in routes.items()},
           "clips": {"fwd": ENGINE["alpha"], "bwd": ENGINE["alpha_bwd"]},
           "launches": launches, "plain": "equal", "matmul": mm,
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del eng, calls, outs, pt, wg, w
    free(torch)
    return out


def plan_summary(params):
    """Per projection of layer 0 (and of zamba2's shared block, as
    shared_attn/<name>): slots, live tiles, passes, runs, bn (and the
    chips of an expert stack, all on one plan)."""
    out = {}
    for prefix, tree, first in (("", params["layers"], layer0_chips),
                                ("shared_attn/", params.get("shared_attn",
                                                            {}),
                                 chips_of)):
        for k, v in tree.items():
            if k.endswith("_cim"):
                chips = first(v)
                p = chips[0].packed
                out[prefix + k[:-4]] = {
                    "slots": p.n_tiles, "tiles": len(live_slots(p)),
                    "passes": p.n_passes, "runs": len(p.out_col),
                    "bn": p.bn, "chips": len(chips)}
    return out


def call_order(params, cfg):
    """(packed launches in the model's call order, the layers they cover):
    a dense layer's PROJ_ORDER; an MoE layer's attention projections, each
    expert's ew_g, then ew_i, then ew_o (expert 0 first), then the shared
    experts' sw_g, sw_i, sw_o (`models/moe.moe_ffn`); an rwkv6 layer's
    RWKV_ORDER; a group of zamba2's mamba2 layers (MAMBA_ORDER each), then
    its shared block's PROJ_ORDER (as shared_attn/<name>)."""
    lay = params["layers"]

    def each(names, tree=lay, prefix=""):
        # a tensor-parallel projection launches once per shard, in order
        return [prefix + n for n in names
                for _ in chips_of(tree[n + "_cim"][0] if tree is lay
                                  else tree[n + "_cim"])]
    if "wr_cim" in lay:
        return each(RWKV_ORDER), 1
    if "in_proj_cim" in lay:
        every = cfg.hybrid_attn_every or cfg.n_layers
        shared = each(PROJ_ORDER, params["shared_attn"], "shared_attn/") \
            if "shared_attn" in params else []
        return each(MAMBA_ORDER) * every + shared, every
    if "ew_g_cim" not in lay:
        return each(PROJ_ORDER), 1
    n_e = len(lay["ew_g_cim"][0])
    return each(["wq", "wk", "wv", "wo"]) \
        + [n for n in ("ew_g", "ew_i", "ew_o") for _ in range(n_e)] \
        + each(["sw_g", "sw_i", "sw_o"]), 1


def device_us_by_kernel(events):
    """Device microseconds per kernel name among a profiler window's
    events."""
    by_name = {}
    for e in events:
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
    by_name = device_us_by_kernel(prof.events())
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


def served_inputs(res):
    """What a served model's prefill (and, but for the vision prefix, its
    decode steps) takes beside the tokens: an encoder-decoder's memory, a
    VLM's vision prefix when its serve path ran one."""
    out = {} if res.memory is None else {"memory": res.memory}
    if res.vis_embeds is not None:
        out["vis_embeds"] = res.vis_embeds
    return out


def profile_prefill(torch, res, dev):
    """Device time of one profiled prefill (after one unprofiled one) of a
    served model (torch.profiler / CUPTI): every walk launch in start
    order, in the model's call order (`call_order`), so the walk's device
    ms per projection is the mean over the layers (zamba2's shared block:
    per run; a VLM's vision prefix and prompt: both passes); the prefill's
    device ms by kernel. The window opens on another prefill and a marker
    (`marked_window`)."""
    from repro_torch.launch.steps import arch_serving, make_prefill_step
    cfg, prompts = res.cfg, res.prompts
    prefill = make_prefill_step(cfg)
    batch = dict(served_inputs(res), tokens=prompts)
    passes = 1 + ("vis_embeds" in batch)
    cache_len = prompts.shape[1] + 1 + cfg.vis_patches

    states = [arch_serving(cfg, dev).init_state(prompts.shape[0],
                                                cache_len) for _ in range(3)]
    run = lambda: prefill(res.params, states.pop(), batch)
    events = marked_events(torch, "prefill", run, run)
    if not events:
        return {"device_ms": "not measured"}
    walk = [e.time_range.elapsed_us() / 1e3 for e in events
            if "cim_walk" in e.name]
    order, unit = call_order(res.params, cfg)
    if not walk or len(walk) % len(order):
        raise AssertionError(f"prefill: {len(walk)} walk launches, not "
                             f"{len(order)} per {unit} layers")
    n_units = len(walk) // len(order) // passes
    n_layers = n_units * unit
    per_proj = {}                # an expert projection: all its experts
    for i, n in enumerate(order):
        runs = n_units if n.startswith("shared_attn/") else n_layers
        per_proj[n] = per_proj.get(n, 0.0) + sum(walk[i::len(order)]) \
            / runs
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    top = sorted(device_us_by_kernel(events).items(), key=lambda kv: -kv[1])
    rows = prompts.numel() + (res.vis_embeds.shape[:2].numel()
                              if passes > 1 else 0)
    return {"m": rows, "layers": n_layers,
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
        prompts.shape[0], prompts.shape[1] + 2 * steps + 1 + cfg.vis_patches)
    decode = make_decode_step(cfg)
    first = dict(served_inputs(res), tokens=prompts)
    feed = {k: v for k, v in first.items() if k == "memory"}
    logits, cache = make_prefill_step(cfg)(res.params, cache, first)
    tok = torch.argmax(logits, -1)[:, None]
    torch.cuda.synchronize()
    host_s = []              # host time until decode() returns, unprofiled
    for _ in range(steps):
        t0 = now()
        logits, cache = decode(res.params, cache, dict(feed, tokens=tok))
        host_s.append(now() - t0)
        tok = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = now()
        for _ in range(steps):
            logits, cache = decode(res.params, cache, dict(feed, tokens=tok))
            tok = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()
        wall = now() - t0
    by_name = device_us_by_kernel(prof.events())
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
    reduction and the CUDA-event time of one Gibbs run. Then the entry
    point itself (digital) with --metrics-out to a temporary file, read
    back: the fwd and bwd energies positive, finite and equal to the
    meter of the digital run's chip (`recover.meter_run`), and the
    printed energy lines."""
    from repro_torch.launch import recover
    from repro_torch.obs.clock import timed_call
    out, meter = {}, None
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
        if mode == "digital":
            meter = recover.meter_run(setup, args)
        del setup, traj, plain
        free(torch)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "recover_metrics.json")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            recover.main(RECOVER + ["--device", str(dev), "--metrics-out",
                                    path])
        with open(path) as f:
            doc = json.load(f)
    got = {(g["name"], g["labels"]["direction"]): g["value"]
           for g in doc["gauges"] + doc["counters"]}
    energy = {}
    for d in ("fwd", "bwd"):
        want = meter.energy_pj(direction=d)
        e = got[("chip_energy_pj", d)]
        if not (e > 0 and e == want and e < float("inf")):
            raise AssertionError(f"--metrics-out {d} energy {e} pJ, the "
                                 f"meter's {want}")
        energy[d] = {"pj_per_mvm": got[("chip_pj_per_mvm", d)],
                     "tops_per_w": got[("chip_tops_per_w", d)],
                     "mvms": got[("chip_mvm_dispatches", d)],
                     "energy_pj": e}
    lines = [ln for ln in text.getvalue().splitlines()
             if ln.startswith("energy/")]
    if len(lines) != 2:
        raise AssertionError(f"recover printed {lines}")
    out["metrics_out"] = {"energy": energy, "lines": lines}
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
                          "materialised noisy weight, no noise drawn)",
          "gqa_attention": f"granite-20b's decode attention, {ATTN_ROW}: 16 "
                           "slots of 4096 keys, all full, f32 (max_abs_err: "
                           "the worst of ATTN_SHAPES against the plain path; "
                           "the attention phase's line has every shape)"}
    at["cim_mvm_packed"] += ("; tp_layer: serve-tp's layer at 'model' width "
                             "8, its 56 launches at M = 4 and 256")
    main_path = {"cim_mvm_packed": "serve",
                 "cim_mvm_scheduled": "serve-merged",
                 "cim_mvm_transposed": "recover-digital",
                 "cim_mvm": "cnn7-relaxed",
                 "noisy_matmul": "noisy-matmul",
                 "gqa_attention": "serve-granite"}
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
            "library_ms": t.get("library_ms"), "walk_ms": t.get("walk_ms"),
            "at": at[kernel],
            **{k: v for k, v in t.items()
               if k in ("device_ms", "bwd_ms", "matmul_only_ms",
                        "weight_ms", "sgemm_ms", "fused_ms", "fused_plain_ms",
                        "fused_bound_ms", "fused_host_us", "lstm_ms",
                        "lstm_bound_ms")
               or k.startswith(("prefill_", "tp_", "tuned_", "unfused_"))},
            "ok": not failures})
    return {"kernels": rows}


def moe_phases(torch, K, ops, serve, dev, stats):
    """The engine phase, then the MoE serve paths (static on single-pass
    and merged chips, continuous batching on the single-pass chips of
    serve-moe) and their profile. They run after the profile phase has
    freed the dense models: their ~30 GB of chips do not fit beside
    them."""
    # what a failed profile phase left held would not fit beside them
    for queue in ("profile", "profile_cnn"):
        stats[queue].clear()
    free(torch)
    engine_phase(torch, K, dev, stats)
    text = "deepseek-moe-16b full width, {} of 28 layers, {} cores"
    moe = phase("serve-moe")(serve_path)(
        torch, K, ops, serve, dev, stats, "serve-moe", SERVE_MOE,
        SERVE_MOE_ROUTES, text.format(SERVE_MOE["n_layers"],
                                      SERVE_MOE["cim_cores"]),
        MOE, "profile_moe")
    phase("serve-moe-merged")(serve_path)(
        torch, K, ops, serve, dev, stats, "serve-moe-merged", MERGED_MOE,
        MERGED_MOE_ROUTES, text.format(MERGED_MOE["n_layers"],
                                       MERGED_MOE["cim_cores"]),
        MOE, "profile_moe")
    served = dict(stats["profile_moe"]).get("serve-moe") if moe else None
    if served is None:
        failures.append("serve-traffic-moe")
        emit({"phase": "serve-traffic-moe", "ok": False,
              "error": "no serve-moe chips to serve"})
    else:
        phase("serve-traffic-moe")(traffic_path)(
            torch, K, serve, dev, stats, "serve-traffic-moe", TRAFFIC_MOE,
            SERVE_MOE_ROUTES, MOE, deployed=served, full=False)
    del served
    phase("profile-moe")(profile_served)(torch, dev, stats, "profile_moe")


def arch_phases(torch, K, ops, serve, dev, stats, paths):
    """Per arch of `paths` (RECURRENT_PATHS, ARCH_PATHS): its static serve
    path, the engine on its chips where the arch has an engine path (no
    plain rerun of the stream and no static baseline, as for
    serve-traffic-moe), then its profile windows. They run after the MoE
    phases have freed their chips, and each arch's chips are freed before
    the next arch's are made (zamba2's ~34 GB would not fit beside the MoE
    chips, nor qwen2-72b's ~40 GB beside anything)."""
    for arch, path, conf, tpath, tconf, routes, text in paths:
        # what a failed phase left held would not fit beside them
        for queue in ("profile", "profile_cnn", "profile_moe", "profile_rec"):
            stats[queue].clear()
        free(torch)
        ok = phase(path)(serve_path)(torch, K, ops, serve, dev, stats, path,
                                     conf, routes, text, arch, "profile_rec")
        served = dict(stats["profile_rec"]).get(path) if ok else None
        if tpath is not None and served is None:
            failures.append(tpath)
            emit({"phase": tpath, "ok": False,
                  "error": f"no {path} chips to serve"})
        elif tpath is not None:
            phase(tpath)(traffic_path)(torch, K, serve, dev, stats, tpath,
                                       tconf, routes, arch, deployed=served,
                                       full=False)
        del served
        phase("profile-" + path[len("serve-"):])(profile_served)(
            torch, dev, stats, "profile_rec")


@phase("batch-invariance")
def batch_invariance_phase(torch, dev):
    """How many outputs of the float sums that feed a chip input change
    when a row is computed in a batch of 4 rather than alone, on the card:
    RMSNorm's mean of squares (d of gemma2-9b, qwen2-72b and its d_ff) and
    attention's scores and weighted values (one query over 96 keys at
    gemma2-9b's and qwen2-72b's heads), summed in float32 as the reference
    does and as the port does (`transformer.rms_norm`, `_dot`: float64,
    rounded once). A measurement, not a check: the pool-vs-alone checks of
    the engine phases hold the served logits."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(dev).manual_seed(3)
    moved = lambda f, *a: int(sum(
        (f(*(t[i:i + 1] for t in a))[0] != f(*a)[i]).sum()
        for i in range(a[0].shape[0])))
    out = {}
    for d in (3584, 8192, 29568):
        x = torch.randn((4, 1, d), generator=gen, device=dev)
        out[f"rms d {d}"] = {
            "float32": moved(lambda t: torch.mean(torch.square(t), -1), x),
            "port": moved(lambda t: T.rms_norm(t, 1.0), x)}
    for name, h, hkv, hd in (("gemma2-9b", 16, 8, 256),
                             ("qwen2-72b", 64, 8, 128)):
        q = torch.randn((4, 1, h, hd), generator=gen, device=dev)
        k = torch.repeat_interleave(
            torch.randn((4, 96, hkv, hd), generator=gen, device=dev),
            h // hkv, dim=2)
        p = torch.softmax(torch.randn((4, h, 1, 96), generator=gen,
                                      device=dev), -1)
        f32 = lambda eq: lambda a, b: torch.einsum(eq, a, b)
        out[name] = {
            "scores float32": moved(f32("bqhd,bkhd->bhqk"), q, k),
            "scores port": moved(lambda a, b: T._dot("bqhd,bkhd->bhqk",
                                                     a, b), q, k),
            "values float32": moved(f32("bhqk,bkhd->bqhd"), p, k),
            "values port": moved(lambda a, b: T._dot("bhqk,bkhd->bqhd",
                                                     a, b), p, k),
            "outputs": {"scores": 4 * h * 96, "values": q.numel()}}
    return out


def dense_attention64(torch, q, k, v, q_pos, kv_pos, window):
    """The dense causal (windowed) attention formula in float64, one batch
    row at a time: the reference the chunked path is held to."""
    rep = q.shape[2] // k.shape[2]
    dist = q_pos[:, None] - kv_pos[None, :]
    keep = (dist >= 0) & ((dist < window) if window > 0 else True)
    out = []
    for b in range(q.shape[0]):
        kb = torch.repeat_interleave(k[b].double(), rep, dim=1)
        vb = torch.repeat_interleave(v[b].double(), rep, dim=1)
        logits = torch.einsum("qhd,khd->hqk", q[b].double(), kb) \
            / q.shape[-1] ** 0.5
        probs = torch.softmax(logits.masked_fill(~keep, -torch.inf), -1)
        out.append(torch.einsum("hqk,khd->qhd", probs, vb))
        del kb, vb, logits, probs
    return torch.stack(out)


@phase("attention-long")
def attention_long_phase(torch, dev):
    """`transformer.attention` above 2 * ATTN_CHUNK keys (the chunked
    online-softmax path) at ATTN_LONG's shapes against the dense formula in
    float64 (max |diff| within ATTN_ATOL); its CUDA-event time beside one
    `scaled_dot_product_attention` call on the same inputs (keys and
    values repeated to the query heads first, a boolean mask)."""
    import torch.nn.functional as F
    from repro_torch.models import transformer as T
    c = ATTN_LONG
    b, h, hkv, d, n = (c["batch"], c["heads"], c["kv_heads"], c["head_dim"],
                       c["kv"])
    if n <= 2 * T.ATTN_CHUNK:
        raise AssertionError(f"KV {n} does not reach the chunked path")
    gen = torch.Generator(dev).manual_seed(17)
    k = torch.randn((b, n, hkv, d), generator=gen, device=dev)
    v = torch.randn((b, n, hkv, d), generator=gen, device=dev)
    pos = torch.arange(n, device=dev)
    out = {}
    for sq, window in c["cases"]:
        q = torch.randn((b, sq, h, d), generator=gen, device=dev)
        q_pos = pos[-sq:]
        run = lambda: T.attention(q, k, v, causal=True, q_pos=q_pos,
                                  kv_pos=pos, window=window)
        got = run()
        want = dense_attention64(torch, q, k, v, q_pos, pos, window)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"Sq {sq}: non-finite output")
        err = float((got.double() - want).abs().max())
        if err > ATTN_ATOL:
            raise AssertionError(f"Sq {sq}, window {window}: chunked vs "
                                 f"dense float64 {err} > {ATTN_ATOL}")
        del want
        ms = median_ms(torch, run, 10)
        kr, vr = (torch.repeat_interleave(t, h // hkv, dim=2).transpose(1, 2)
                  for t in (k, v))
        dist = q_pos[:, None] - pos[None, :]
        mask = (dist >= 0) & ((dist < window) if window > 0 else True)
        qt = q.transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(qt, kr, vr,
                                                     attn_mask=mask)
        lib_ms = median_ms(torch, lib, 10)
        out[f"sq {sq}"] = {"batch": b, "heads": h, "kv_heads": hkv,
                           "head_dim": d, "kv": n, "window": window,
                           "chunks": n // T.ATTN_CHUNK,
                           "max_abs_err_vs_float64": err,
                           "atol": ATTN_ATOL, "ms": ms, "sdpa_ms": lib_ms}
        del q, got, kr, vr, mask, qt
        free(torch)
    return out


def attention_bound_ms(torch, AK, q_pos, kv_len, b, h, hkv, d, sk,
                       window, elem):
    """The least time of one attention call on the card: each (slot, KV
    head)'s K and V up to its rows' last key and q and the output read or
    written once, at 3.35 TB/s, or the two FP64 dot products of every row
    over its keys, 4 D flops a key, at 67 TFLOP/s; the larger."""
    lo, hi = AK.row_ranges(q_pos, sk, causal=True, window=window,
                           kv_len=kv_len)
    lo, hi = lo.expand(b, -1), hi.expand(b, -1)
    keys = int((hi.amax(1) - lo.amin(1)).sum()) * hkv
    sq = q_pos.shape[-1]
    nbytes = (2 * keys * d + 2 * b * sq * h * d) * elem
    flops = 4 * d * int((hi - lo).sum()) * h
    return max(nbytes / 3.35e12, flops / 67e12) * 1e3, nbytes, flops


@phase("attention")
def attention_phase(torch, dev, stats):
    """The attention kernel (`kernels/attention`) at ATTN_SHAPES in f32:
    against the plain path (ATTN_TOL), its median of 20 launches with L2
    flushed beside its bound (`attention_bound_ms`), the plain path's ms
    (median of 5) and one `scaled_dot_product_attention` call on the
    repeated KV with a boolean mask (`library_ms`, which the port never
    calls); each call one launch; on DMMA also the values pass's other
    mode (`other_mode_ms`: split or whole, not the one `whole_splits`
    picks). The ATTN_ROW shape's times, and the
    worst max |err|, go to the kernels line's row."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.models import transformer as T
    flush = torch.empty(64 * 1024 * 1024, device=dev)   # 256 MB > L2
    gen = torch.Generator(dev).manual_seed(29)
    out = {}
    for name, (b, sq, h, hkv, d, sk, fill, window, cap) in \
            ATTN_SHAPES.items():
        q = torch.randn((b, sq, h, d), generator=gen, device=dev)
        k = torch.randn((b, sk, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, sk, hkv, d), generator=gen, device=dev)
        kv_len = torch.full((b,), fill, dtype=torch.int32, device=dev)
        q_pos = (kv_len - sq).long()[:, None] + torch.arange(sq, device=dev)
        kv_pos = torch.arange(sk, device=dev)
        kw = dict(causal=True, q_pos=q_pos, window=window, softcap=cap,
                  kv_len=kv_len)
        before = AK.LAUNCHES[ATTN]
        got = AK.gqa_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if AK.LAUNCHES[ATTN] != before + 1:
            raise AssertionError(f"{name}: {AK.LAUNCHES[ATTN] - before} "
                                 "launches, not 1")
        plain = lambda: T._dense_attention(q, k, v, kv_pos=kv_pos, **kw)
        want = plain()
        mag = T._dense_attention(q, k, v.abs(), kv_pos=kv_pos, **kw)
        err = float(((got - want).abs() / mag.clamp_min(1e-30)).max())
        equal = float((got == want).float().mean())
        stats["err"][ATTN] = max(stats["err"].get(ATTN, 0.0),
                                 float((got - want).abs().max()))
        if err > ATTN_TOL:
            raise AssertionError(f"{name}: kernel vs plain {err} > "
                                 f"{ATTN_TOL}")
        del want, mag
        ms = median_ms(torch, lambda: AK.gqa_attention(q, k, v, **kw), 20,
                       flush)
        rep = h // hkv
        whole = AK.whole_splits(b * hkv, rep * sq, torch.cuda
                                .get_device_properties(dev)
                                .multi_processor_count)
        other_ms = None
        if AK.mma_route(rep * sq):       # the values pass's other mode
            other = lambda: AK._attention(q, k, v, True, q_pos, window, cap,
                                          kv_len, mma=True, whole=not whole)
            if not torch.equal(other(), got):
                raise AssertionError(f"{name}: the values pass's modes "
                                     "differ")
            other_ms = median_ms(torch, other, 20, flush)
        plain_ms = median_ms(torch, plain, 5, flush)
        bound, nbytes, flops = attention_bound_ms(
            torch, AK, q_pos, kv_len, b, h, hkv, d, sk, window, 4)
        free(torch)
        kr, vr = (torch.repeat_interleave(t, rep, dim=2).transpose(1, 2)
                  for t in (k, v))
        dist = q_pos[:, :, None] - kv_pos[None, None, :]
        mask = (dist >= 0) & (kv_pos[None, None, :] < kv_len[:, None, None])
        if window > 0:
            mask &= dist < window
        qt = q.transpose(1, 2)
        lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kr, vr, attn_mask=mask[:, None]), 5, flush)
        out[name] = {"shape": {"batch": b, "sq": sq, "heads": h,
                               "kv_heads": hkv, "head_dim": d, "kv": sk,
                               "fill": fill, "window": window,
                               "softcap": cap},
                     "route": "dmma" if AK.mma_route(rep * sq) else "fma",
                     "whole_splits": whole, "other_mode_ms": other_ms,
                     "ms": ms, "bound_ms": bound,
                     "bound_share": bound / ms,
                     "bound_by": "bytes" if nbytes / 3.35e12 >= flops / 67e12
                     else "operations",
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "max_rel_err_vs_plain": err,
                     "equal_share_vs_plain": equal}
        del q, k, v, kr, vr, mask, qt, got
        free(torch)
    stats["time"][ATTN] = {k: out[ATTN_ROW][k] for k in
                           ("ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms")}
    return out


NOISY_SEEDS = {"wq": 1, "wk": 2, "wv": 3, "wo": 4, "w_g": 5, "w_i": 6,
               "w_o": 7}                 # cim_linear's call-site seeds


def lm_matmul_weights(params, cfg):
    """N_eff: the matmul weights a token meets (each layer's 2-D
    projections and the unembedding; the embedding is a lookup)."""
    per_layer = sum(v[0].numel() for v in params["layers"].values()
                    if v.dim() == 3)
    unembed = params["embed" if cfg.tie_embeddings else "unembed"].numel()
    return cfg.n_layers * per_layer + unembed


def lm_step_split(torch, cfg, params, opt, batch, lr):
    """One more train step, timed piece by piece (CUDA events, host
    included): the forward that builds the loss's graph, the backward
    (autograd), the optimizer (clip and AdamW in place). Returns ms."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    leaves = tree_leaves(params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    req = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = T.lm_loss(tree_unflatten(params, req), batch, cfg)
    ev[1].record()
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = tree_unflatten(params, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, grads)])
    ev[2].record()
    del req, loss
    steps.clip_grads_(grads, 1.0)
    steps.adamw_apply(grads, opt, params, lr)
    ev[3].record()
    ev[3].synchronize()
    return {k: ev[i].elapsed_time(ev[i + 1])
            for i, k in enumerate(("forward_ms", "backward_ms",
                                   "optimizer_ms"))}


def noise_draw_ms(torch, cfg, params):
    """CUDA-event ms of the noise draws one noisy forward makes: eps of
    each layer's seven projections (`transformer.weight_noise`)."""
    from repro_torch.models import transformer as T
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for li in range(cfg.n_layers):
        for name, seed in NOISY_SEEDS.items():
            T.weight_noise(params["layers"][name][li], seed)
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


@phase("train-lm")
def train_lm_phase(torch, K, dev, stats):
    """`launch/train.py` at qwen2-72b's full width, 2 of 80 layers, bf16
    params and f32 moments, batch 8 x 128 tokens, 6 steps, under --cim
    off and then noisy (no checkpoint: --ckpt-every past --steps). Every
    loss finite, the two modes' step-0 losses different, no CIM kernel
    launched (the reference's training reaches none), the attention
    kernel once a layer and step (its backward is the plain path's), every
    leaf of the state on the card after the last step. Then TRAIN_LM_SPLIT_REPS more
    steps timed piece by piece (`lm_step_split`) and, under noisy, the
    forward's noise draws alone."""
    import math
    from repro_torch.launch import train
    from repro_torch.train.optimizer import tree_leaves
    out, first = {}, {}
    for mode in ("off", "noisy"):
        with tempfile.TemporaryDirectory() as ckpt:
            args = train.parse_args(TRAIN_LM + ["--cim", mode, "--device",
                                                str(dev), "--ckpt-dir", ckpt])
            free(torch)
            torch.cuda.reset_peak_memory_stats()
            reset_launches(K)            # the path's run starts here
            res = train.run(args)
            torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)  # ... and ends here
            peak = torch.cuda.max_memory_allocated() / 1e9
        stats["launches"][f"train-lm-{mode}"] = launches
        cfg = train.train_config(args)
        want = dict.fromkeys(K.LAUNCHES, 0)
        want[ATTN] = attention_calls(cfg) * args.steps
        if launches != want:
            raise AssertionError(f"train-lm {mode}: launches {launches}, "
                                 f"the path needs {want} (no CIM kernel; "
                                 "the attention kernel's forward)")
        if len(res.losses) != args.steps or not all(
                math.isfinite(x) for x in res.losses):
            raise AssertionError(f"train-lm {mode}: losses {res.losses}")
        state = tree_leaves((res.params, res.opt))
        off = sum(t.device.type != dev.type for t in state)
        if off:
            raise AssertionError(f"train-lm {mode}: {off} state leaves "
                                 "off the card")
        batch = next(train.data_iter(cfg, args.batch, args.seq, dev))
        split = [lm_step_split(torch, cfg, res.params, res.opt, batch,
                               args.lr) for _ in range(TRAIN_LM_SPLIT_REPS)]
        med = {k: statistics.median(x[k] for x in split) for k in split[0]}
        if mode == "noisy":
            med["noise_draw_ms"] = statistics.median(
                noise_draw_ms(torch, cfg, res.params)
                for _ in range(TRAIN_LM_SPLIT_REPS))
        step_ms = statistics.median(res.step_s) * 1e3
        tokens = args.batch * args.seq
        n_eff = lm_matmul_weights(res.params, cfg)
        tflops = 6 * n_eff * tokens / (step_ms / 1e3) / 1e12
        first[mode] = res.losses[0]
        out[mode] = {
            "losses": res.losses, "step_ms": [t * 1e3 for t in res.step_s],
            "median_step_ms": step_ms, **med,
            "peak_gb": peak, "tokens_per_s": tokens / (step_ms / 1e3),
            "params": sum(t.numel() for t in tree_leaves(res.params)),
            "matmul_weights": n_eff, "model_tflop_per_step":
                6 * n_eff * tokens / 1e12,
            "model_tflops": tflops, "bf16_peak_share":
                tflops * 1e12 / BF16_FLOPS_PER_S, "launches": launches}
        del res, state, batch, split
        free(torch)
    if first["off"] == first["noisy"]:
        raise AssertionError(f"the step-0 loss is {first['off']} under off "
                             "and noisy alike: the noise is not on")
    return out


@phase("train-lm-parity")
def train_lm_parity_phase(torch, dev):
    """One `make_train_step` on the card against the same step on the CPU,
    qwen2-72b --smoke in float32 (off and noisy), from the same params
    (seed 0) and batch 0: loss and gnorm within TRAIN_RTOL, every param
    within TRAIN_PARAM_ATOL where each gradient entry is above 1e-4 of the
    global norm or zero (the CPU's gradient), else within 2 lr."""
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import tree_leaves, tree_map
    cpu, c = torch.device("cpu"), TRAIN_PARITY
    out = {}
    for mode in ("off", "noisy"):
        cfg = train.train_config(train.parse_args(
            ["--arch", "qwen2-72b", "--smoke", "--cim", mode]))
        params = T.init_params(cfg, seed=0, device="cpu")
        batch = next(train.data_iter(cfg, c["batch"], c["seq"], cpu))
        _, g = steps.loss_and_grads(params, batch, cfg)
        gl = tree_leaves(g)
        gnorm = float(torch.sqrt(sum(torch.sum(x.double() ** 2) for x in gl)))
        big = [(x.abs() > 1e-4 * gnorm) | (x == 0) for x in gl]
        card = tree_map(lambda t: t.to(dev, copy=True), params)
        card_batch = {k: v.to(dev) for k, v in batch.items()}
        step = steps.make_train_step(cfg, lr=c["lr"])
        _, _, l_cpu, n_cpu = step(params, steps.adamw_init_f32(params), batch)
        _, _, l_card, n_card = step(card, steps.adamw_init_f32(card),
                                    card_batch)
        for what, a, b in (("loss", l_card, l_cpu), ("gnorm", n_card, n_cpu)):
            if abs(float(a) - float(b)) > TRAIN_RTOL * abs(float(b)):
                raise AssertionError(f"{mode} {what}: card {float(a)} vs "
                                     f"CPU {float(b)}")
        err, n_cmp, n_all = 0.0, 0, 0
        for a, b, m in zip(tree_leaves(card), tree_leaves(params), big):
            d = (a.cpu() - b).abs()
            if bool((d[~m] > 2 * c["lr"]).any()):
                raise AssertionError(f"{mode}: a param moved by more than "
                                     "2 lr off the compared set")
            if m.any():
                err = max(err, float(d[m].max()))
            n_cmp += int(m.sum())
            n_all += m.numel()
        if err > TRAIN_PARAM_ATOL:
            raise AssertionError(f"{mode}: params off by {err} > "
                                 f"{TRAIN_PARAM_ATOL}")
        out[mode] = {"loss_card": float(l_card), "loss_cpu": float(l_cpu),
                     "gnorm_card": float(n_card), "gnorm_cpu": float(n_cpu),
                     "max_abs_param_err": err,
                     "share_compared": n_cmp / n_all,
                     "rtol": TRAIN_RTOL, "param_atol": TRAIN_PARAM_ATOL}
        del card, card_batch
    free(torch)
    return out


def resume_child(ckpt_dir: str, device: str = "cuda") -> int:
    """The train-resume phase's child process (CUBLAS_WORKSPACE_CONFIG set
    by the parent before CUDA starts): deterministic algorithms on, an
    uninterrupted TRAIN_RESUME run and one with a fault injected at
    `fault_at`, resumed from its latest checkpoint (the data stream
    resumed at that step), both through `FaultTolerantTrainer`; prints a
    JSON line and exits 0 when the two final states are equal bit for
    bit."""
    import warnings
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)
    from repro_torch.distributed import FaultTolerantTrainer
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import tree_leaves
    c = TRAIN_RESUME
    dev = torch.device(device)
    cfg = train.train_config(train.parse_args(["--arch", "qwen2-72b",
                                               "--smoke"]))
    step = steps.make_train_step(cfg, lr=3e-4)

    def step_fn(state, batch):
        p, o, _, _ = step(state[0], state[1], batch)
        return (p, o)

    def fresh():
        p = T.init_params(cfg, seed=0, device=dev)
        return (p, steps.adamw_init_f32(p))

    data = lambda start=0: train.data_iter(cfg, c["batch"], c["seq"], dev,
                                           start=start)
    straight_dir = os.path.join(ckpt_dir, "straight")
    resumed_dir = os.path.join(ckpt_dir, "resumed")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        straight, _ = FaultTolerantTrainer(
            step_fn, straight_dir, ckpt_every=c["ckpt_every"]).run(
            fresh(), data(), c["steps"])
        tr = FaultTolerantTrainer(step_fn, resumed_dir,
                                  ckpt_every=c["ckpt_every"],
                                  fault_injector=lambda s: s == c["fault_at"])
        try:
            tr.run(fresh(), data(), c["steps"])
            raise AssertionError("the injected fault did not fire")
        except RuntimeError as e:
            if "injected fault" not in str(e):
                raise
        tr2 = FaultTolerantTrainer(step_fn, resumed_dir,
                                   ckpt_every=c["ckpt_every"])
        state, start = tr2.resume(fresh())
        resumed, end = tr2.run(state, data(start), c["steps"],
                               start_step=start)
    pairs = list(zip(tree_leaves(straight), tree_leaves(resumed)))
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    diff = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
    print(json.dumps({"resumed_at": start, "end": end, "bitwise": bitwise,
                      "max_abs_diff": diff, "leaves": len(pairs),
                      "events": tr.events + tr2.events,
                      "nondeterministic": sorted({str(w.message)[:200]
                                                  for w in caught})}))
    return 0 if bitwise and end == c["steps"] else 1


@phase("train-resume")
def train_resume_phase(torch, dev):
    """`FaultTolerantTrainer` on the card at qwen2-72b smoke size
    (TRAIN_RESUME: checkpoints every 2 steps, a fault injected at step 5,
    resumed from step 4) equal bit for bit to an uninterrupted 8-step run,
    in a child process with deterministic algorithms (the embedding's
    backward accumulates with atomics otherwise); then both step-8
    checkpoints restored here onto the card, leaf for leaf equal."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import tree_leaves
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                f"import chip_smoke; "
                f"sys.exit(chip_smoke.resume_child({d!r}, {str(dev)!r}))")
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=600,
                              cwd=str(ROOT))
        lines = proc.stdout.strip().splitlines()
        child = json.loads(lines[-1]) if lines else {}
        if proc.returncode:
            raise AssertionError(f"child exited {proc.returncode}: {child} "
                                 f"{proc.stderr[-1500:]}")
        cfg = train.train_config(train.parse_args(["--arch", "qwen2-72b",
                                                   "--smoke"]))
        p = T.init_params(cfg, seed=1, device=dev)
        like = (p, steps.adamw_init_f32(p))
        a, sa = restore_checkpoint(os.path.join(d, "straight"), like)
        b, sb = restore_checkpoint(os.path.join(d, "resumed"), like)
    if sa != TRAIN_RESUME["steps"] or sb != sa:
        raise AssertionError(f"restored steps {sa} and {sb}")
    la, lb = tree_leaves(a), tree_leaves(b)
    for x, y, z in zip(la, lb, tree_leaves(like)):
        if x.device.type != dev.type or x.dtype != z.dtype \
                or not torch.equal(x, y):
            raise AssertionError("a restored leaf differs between the "
                                 "uninterrupted and the resumed run")
    return {**child, "restored_step": sa, "restored_leaves": len(la)}


def tp_mesh(dev):
    """The 'model'-width-TP mesh over one card: `dev` repeated."""
    from repro_torch.launch.mesh import Mesh
    return Mesh([[dev] * TP])


def tp_conf(conf, dev):
    return dict(conf, mesh_shape={"model": TP}, mesh=tp_mesh(dev))


def tp_layer_times(torch, K, lay, dev, stats):
    """Layer 0's 7 x TP packed launches at each of TP_ROWS: the sum over
    all 7 x TP launches of each one's own time (each shard's chip on its
    own input; flush and spin before each, median of 10), and the 7 x TP
    launches in one window (flush, a spin covering their host time, then
    every launch; median of 10); with the bound, the sum of each
    launch's."""
    gen = torch.Generator(dev).manual_seed(13)
    flush = torch.empty(64 * 1024 * 1024, device=dev)
    named = [(n, c) for n in PROJ_ORDER for c in chips_of(lay[n + "_cim"][0])]
    chips = [c for _, c in named]
    out = {}
    for m in TP_ROWS:
        xs = [torch.randint(-7, 8, (m, c.packed.n_rows), generator=gen,
                            device=dev).to(torch.float32) for c in chips]

        def launch(c, x):
            p = c.packed
            return K.cim_mvm_packed(x, *packed_args(p), activation="none",
                                    n_row_blocks=p.n_row_blocks,
                                    n_ranks=p.n_ranks, v_read=0.5, seed=SEED)
        per_launch = dict.fromkeys(PROJ_ORDER, 0.0)
        for (n, c), x in zip(named, xs):
            launch(c, x)
            per_launch[n] += median_ms(torch, lambda: launch(c, x), 10,
                                       flush)

        def layer():
            for c, x in zip(chips, xs):
                launch(c, x)
        layer()
        times = []
        for _ in range(10):
            flush.zero_()
            torch.cuda._sleep(8 * SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            layer()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        bounds = [bound(c.packed, m, "cim_mvm_packed") for c in chips]
        unsharded = stats["time"].get("cim_mvm_packed", {})
        out[m] = {"launches": len(chips), "route": route_name(K, m),
                  "ms": sum(per_launch.values()),
                  "window_ms": statistics.median(times),
                  "bound_ms": sum(b[0] for b in bounds),
                  "bound_by": common_bound({"bound_by": b[1]}
                                           for b in bounds),
                  "ms_by_projection": per_launch,
                  "unsharded_layer_ms": unsharded.get(
                      "ms" if m == 4 else "prefill_ms")}
        del xs
    del flush
    return out


def tp_executor_check(torch, nn, cfg, lay, dev):
    """Layer 0's projections at each of TP_ROWS: the executor equals its
    shards' own launches concatenated in shard order ('col') or added
    left to right from shard 0 ('row'), bit for bit."""
    ccfg = nn.arch_cim_config(cfg)
    gen = torch.Generator(dev).manual_seed(5)
    for n in PROJ_ORDER:
        spl = lay[n + "_cim"][0]
        r = spl.shards[0].packed.n_rows
        row = spl.partition == "row"
        for m in TP_ROWS:
            x = torch.randn(m, r * (spl.n_shards if row else 1),
                            generator=gen, device=dev)
            parts = [nn.cim_api.packed_forward(
                c, x[:, s * r:(s + 1) * r] if row else x, ccfg)
                for s, c in enumerate(spl.shards)]
            want = parts[0]
            for part in parts[1:]:
                want = want + part if row else torch.cat((want, part), -1)
            if not torch.equal(nn.sharded_packed_loop(spl, x, ccfg), want):
                raise AssertionError(f"{n} M={m}: the executor differs from "
                                     "its shards' launches combined in order")


def check_tp_chips(lay, mesh):
    """Each projection's shards: partition and width, tiles per shard, and
    shard s's chips on the mesh's 'model' device s."""
    for n, kind in TP_PARTITIONS.items():
        for li, spl in enumerate(lay[n + "_cim"]):
            if (spl.partition, spl.n_shards) != (kind, TP):
                raise AssertionError(f"{n} layer {li}: {spl.partition} x "
                                     f"{spl.n_shards}, expected {kind} x {TP}")
            tiles = [c.packed.n_tiles for c in spl.shards]
            if any(t != TP_TILES[n] for t in tiles):
                raise AssertionError(f"{n} layer {li}: shard tiles {tiles}, "
                                     f"expected {TP_TILES[n]}")
            if [c.packed.gd_tiles.device for c in spl.shards] != \
                    list(mesh.devices[0]):
                raise AssertionError(f"{n} layer {li}: shards not on the "
                                     "mesh's devices")


def serve_tp_phase(torch, K, ops, serve, dev, stats):
    """serve-tp (module docstring); returns (line, served result)."""
    from repro_torch.models import nn
    torch.cuda.reset_peak_memory_stats(dev)
    conf = tp_conf(SERVE_TP, dev)
    res, launches, err = serve_and_check(torch, K, ops, serve, dev, stats,
                                         "serve-tp", conf, TP_ROUTES)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    lay = res.params["layers"]
    check_tp_chips(lay, conf["mesh"])
    tp_executor_check(torch, nn, res.cfg, lay, dev)
    layer_t = tp_layer_times(torch, K, lay, dev, stats)
    t = stats["time"].setdefault("cim_mvm_packed", {})
    t["tp_layer"] = {m: {k: v for k, v in r.items() if k != "ms_by_projection"}
                     for m, r in layer_t.items()}
    prof = profile_decode(torch, res, dev)
    line = {"config": f"gemma2-9b full width, {SERVE_TP['n_layers']} of 42 "
                      f"layers, 'model' width {TP} on one card, "
                      f"{SERVE_TP['cim_cores']}-core shard chips",
            "nvidia_smi": stats["smi"], **serve_numbers(res, conf),
            "launches": launches, "plain_max_abs_logit_err": err,
            "executor": "equal to its shards combined in order",
            "layer_launch_times": layer_t,
            "decode_profile": {k: prof.get(k) for k in (
                "steps", "device_ms_per_step", "device_busy_share",
                "device_busy_share_of_serve_step", "cim_ms_per_step",
                "host_ms_per_step")},
            "peak_mem_gb": peak, "plans": plan_summary(res.params)}
    return line, res


def serve_tp_merged_phase(torch, K, ops, serve, dev, stats):
    torch.cuda.reset_peak_memory_stats(dev)
    conf = tp_conf(MERGED_TP, dev)
    res, launches, err = serve_and_check(torch, K, ops, serve, dev, stats,
                                         "serve-tp-merged", conf,
                                         MERGED_TP_ROUTES)
    out = {"config": f"gemma2-9b full width, 1 of 42 layers, 'model' width "
                     f"{TP}, {MERGED_TP['cim_cores']}-core shard chips",
           **serve_numbers(res, conf), "launches": launches,
           "plain_max_abs_logit_err": err,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "plans": plan_summary(res.params)}
    del res
    free(torch)
    return out


def serve_tp_moe_phase(torch, K, ops, serve, dev, stats):
    torch.cuda.reset_peak_memory_stats(dev)
    conf = tp_conf(MOE_TP, dev)
    res, launches, err = serve_and_check(torch, K, ops, serve, dev, stats,
                                         "serve-tp-moe", conf, MOE_TP_ROUTES,
                                         MOE)
    p0 = {k: v[0] for k, v in res.params["layers"].items()}
    per = MOE_EXPERTS // TP
    for n in ("ew_g", "ew_i", "ew_o"):
        devs = [c.packed.gd_tiles.device for c in p0[n + "_cim"]]
        if devs != [d for d in conf["mesh"].devices[0] for _ in range(per)]:
            raise AssertionError(f"{n}: experts not placed {per} a shard")
    out = {"config": f"deepseek-moe-16b full width, 1 of 28 layers, 'model' "
                     f"width {TP}, {MOE_TP['cim_cores']}-core chips, "
                     f"{MOE_EXPERTS} experts ({per} a shard)",
           **serve_numbers(res, conf), "launches": launches,
           "plain_max_abs_logit_err": err,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "plans": plan_summary(res.params)}
    del res, p0
    free(torch)
    return out


def replicas_phase(torch, dev):
    """replicas (module docstring)."""
    import threading
    import numpy as np
    from types import SimpleNamespace
    from repro_torch.launch import env
    from repro_torch.launch.distributed import route_requests
    out = Path(tempfile.mkdtemp(prefix="replicas-"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", *REPLICAS]

    def cmd(tag):
        return base + ["--results-out", str(out / f"{tag}_{{rank}}.npz"),
                       "--summary-out", str(out / f"{tag}_summary.json")]
    extra = {"PYTHONPATH": str(ROOT / "src")}
    solo = {}
    th = threading.Thread(target=lambda: solo.update(r=env.launch(
        cmd("solo"), num_processes=1, timeout=600, extra_env=extra)))
    th.start()
    group = env.launch(cmd("group"), num_processes=2, timeout=600,
                       extra_env=extra)
    th.join()
    for tag, rs in (("solo", solo.get("r") or []), ("group", group)):
        for rank, r in enumerate(rs):
            if r.returncode != 0:
                raise AssertionError(f"{tag} rank {rank} exited "
                                     f"{r.returncode}: {r.stderr[-3000:]}")
    if not solo.get("r"):
        raise AssertionError("the solo run did not finish")

    def load(path):
        z = np.load(path)
        return {int(rid): (z[f"tokens_{rid}"], z[f"logits_{rid}"])
                for rid in z["rids"]}
    ref = load(out / "solo_0.npz")
    n_req = len(ref)
    fake = [SimpleNamespace(rid=i) for i in range(n_req)]
    rids = []
    for rank in range(2):
        got = load(out / f"group_{rank}.npz")
        want = [q.rid for q in route_requests(fake, 2, rank)]
        if sorted(got) != want:
            raise AssertionError(f"rank {rank} served {sorted(got)}, the "
                                 f"router assigns {want}")
        rids.append(sorted(got))
        for rid, (toks, lg) in got.items():
            if toks.tolist() != ref[rid][0].tolist():
                raise AssertionError(f"request {rid}: tokens {toks} != solo "
                                     f"{ref[rid][0]}")
            if not np.array_equal(lg, ref[rid][1]):
                raise AssertionError(
                    f"request {rid}: logits differ from the solo run's by "
                    f"{float(np.abs(lg - ref[rid][1]).max())}")
    merged = json.loads((out / "group_summary.json").read_text())
    single = json.loads((out / "solo_summary.json").read_text())
    if merged["requests"] != n_req or merged["ranks"] != 2 or \
            merged["decode_traces"] != 1:
        raise AssertionError(f"merged summary: {merged['requests']} requests"
                             f", {merged['ranks']} ranks, "
                             f"{merged['decode_traces']} decode captures")
    keys = ("requests", "tokens", "wall_s", "tok_per_s", "p50_ms", "p99_ms")
    return {"config": "gemma2-9b full width, 1 of 42 layers, 6144 cores, "
                      f"{n_req} requests; 2 ranks (gloo) and a solo run on "
                      "one card at once",
            "command": REPLICAS, "rids_per_rank": rids,
            "tokens_equal": True, "logits_equal": True,
            "fleet": {k: merged[k] for k in keys},
            "per_rank": merged["per_rank"],
            "solo": {k: single[k] for k in keys}}


def tp_phases(torch, K, ops, serve, dev, stats):
    """The tensor-parallel and replica phases, after the training phases
    have freed the card: serve-tp (its chips kept for pool-tp),
    serve-tp-merged, serve-tp-moe, pool-tp, replicas."""
    held = {}

    def serve_tp(*a):
        line, held["res"] = serve_tp_phase(*a)
        return line
    phase("serve-tp")(serve_tp)(torch, K, ops, serve, dev, stats)
    res = held.pop("res", None)
    if res is None:
        failures.append("pool-tp")
        emit({"phase": "pool-tp", "ok": False,
              "error": "no serve-tp chips to serve"})
    else:
        phase("pool-tp")(traffic_path)(torch, K, serve, dev, stats,
                                       "pool-tp", POOL_TP, TP_ROUTES,
                                       deployed=res, full=False)
    del res
    free(torch)
    phase("serve-tp-merged")(serve_tp_merged_phase)(torch, K, ops, serve,
                                                    dev, stats)
    phase("serve-tp-moe")(serve_tp_moe_phase)(torch, K, ops, serve, dev,
                                              stats)
    free(torch)
    phase("replicas")(replicas_phase)(torch, dev)


def dp_mesh(dev, shape):
    """A (data, model) Mesh of `shape` that repeats `dev`."""
    from repro_torch.launch.mesh import Mesh
    return Mesh.over([dev] * (shape["data"] * shape["model"]), shape)


def check_dp_rows(params, n_layers):
    """Each data row's copy of every projection: 'model'-width shards on
    the packed kernel, shard s on the row's 'model' device s."""
    rows = params["cim_rows"]
    if len(rows) != DP["data"]:
        raise AssertionError(f"{len(rows)} data rows, expected {DP['data']}")
    for r, row in enumerate(rows):
        for (_, n), stack in row["entries"].items():
            if len(stack) != n_layers:
                raise AssertionError(f"row {r} {n}: {len(stack)} layers")
            for spl in stack:
                if spl.n_shards != DP["model"] or any(
                        c.packed.route() != "cim_mvm_packed"
                        for c in spl.shards):
                    raise AssertionError(f"row {r} {n}: {spl.n_shards} "
                                         "shards or a merged chip")


def profile_striped_decode(torch, res, stripes, dev, steps):
    """Device time of `steps` striped decode steps (every row's decode,
    then the argmax), after a prefill and as many unprofiled steps
    (torch.profiler / CUPTI), and the device's busy share of the profiled
    window's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import (arch_serving, make_decode_step,
                                          make_prefill_step)
    from repro_torch.obs.clock import now
    cfg, prompts = res.cfg, res.prompts
    m = prompts.shape[0] // len(stripes)
    caches = [arch_serving(cfg, dev).init_state(
        m, prompts.shape[1] + 2 * steps + 1) for _ in stripes]
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    toks = []
    for r, p in enumerate(stripes):
        lg, caches[r] = prefill(p, caches[r],
                                {"tokens": prompts[r * m:(r + 1) * m]})
        toks.append(torch.argmax(lg, -1)[:, None])

    def step():
        for r, p in enumerate(stripes):
            lg, caches[r] = decode(p, caches[r], {"tokens": toks[r]})
            toks[r] = torch.argmax(lg, -1)[:, None]
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = now()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = now() - t0
    by_name = device_us_by_kernel(prof.events())
    busy = sum(by_name.values())
    if not busy:
        return {"device_ms_per_step": "not measured"}
    cim = sum(v for k, v in by_name.items()
              if "cim_" in k) / 1e3 / steps
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_ms_per_step": busy / 1e3 / steps,
            "cim_ms_per_step": cim,
            "device_busy_share": busy / 1e6 / wall}


def serve_dp_phase(torch, K, serve, dev, stats):
    """serve-dp (module docstring); returns (line, served result)."""
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = dp_mesh(dev, DP)
    c = SERVE_DP
    reset_launches(K)                    # the path's run starts here
    res = serve.serve_static("gemma2-9b", cim=True, device=str(dev),
                             mesh=mesh, **c)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)          # ... and ends here
    stats["launches"]["serve-dp"] = launches
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    check_dp_rows(res.params, c["n_layers"])
    want = dict.fromkeys(K.LAUNCHES, 0)
    want["cim_mvm_packed"] = DP["data"] * DP_PER_LAYER * c["n_layers"] \
        * c["gen"]
    want[ATTN] = DP["data"] * attention_calls(res.cfg) * c["gen"]
    if launches != want:
        raise AssertionError(f"serve-dp: launches {launches}, the path "
                             f"needs {want}")
    stripes = serve.data_stripes(res.params, c["batch"])
    if stripes is None:
        raise AssertionError("serve-dp: the batch did not stripe")
    # the same chips, the whole batch on row 0 (the unstriped serve)
    whole = serve.greedy_decode(res.params, res.cfg, res.prompts, c["gen"],
                                dev)
    if not torch.equal(whole.tokens, res.out.tokens):
        raise AssertionError(f"serve-dp: striped tokens {res.out.tokens} "
                             f"!= unstriped {whole.tokens}")
    err = max(float((a - b).abs().max())
              for a, b in zip(res.out.logits, whole.logits))
    if err > TRAFFIC_ATOL:
        raise AssertionError(f"serve-dp: striped vs unstriped logits "
                             f"{err} > {TRAFFIC_ATOL}")
    prof = profile_striped_decode(torch, res, stripes, dev, c["gen"] - 1)
    line = {"config": f"gemma2-9b full width, {c['n_layers']} of 42 layers, "
                      f"a {DP['data']} x {DP['model']} (data, model) mesh on "
                      f"one card, {c['cim_cores']}-core shard chips, a copy "
                      "per data row",
            "nvidia_smi": stats["smi"], **serve_numbers(res, c),
            "launches": launches,
            "packed_launches_per_token": want["cim_mvm_packed"] // c["gen"],
            "striped_vs_unstriped_max_abs_logit_err": err,
            "decode_profile": prof, "peak_mem_gb": peak,
            "plans": plan_summary(res.params)}
    return line, res


def pool_dp_phase(torch, K, serve, dev, stats, deployed):
    """pool-dp (module docstring)."""
    from repro_torch.launch.scheduler import ContinuousBatchingEngine
    cfg, params, c = deployed.cfg, deployed.params, POOL_DP
    reqs, max_len = serve.traffic_stream(
        cfg, c["requests"], prompt_len=c["prompt_len"], gen=c["gen"],
        chunk=c["chunk"], rate=c["rate"], device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(K)                    # the path's run starts here
    eng = ContinuousBatchingEngine(cfg, params, n_slots=c["slots"],
                                   max_len=max_len, chunk=c["chunk"],
                                   mesh=cfg.cim_mesh, capture_logits=True)
    st = eng.run(reqs)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)          # ... and ends here
    stats["launches"]["pool-dp"] = launches
    if eng.stripe_traces() != [1] * DP["data"]:
        raise AssertionError(f"pool-dp: captures per stripe "
                             f"{eng.stripe_traces()}, the contract is 1")
    per_exec = DP_PER_LAYER * cfg.n_layers
    attn = attention_calls(cfg)
    for s in eng.stripes:
        if sum(s.decode.fun.per_replay.values()) != per_exec + attn:
            raise AssertionError(f"pool-dp: a stripe's capture holds "
                                 f"{s.decode.fun.per_replay}, not "
                                 f"{per_exec} + {attn}")
    runs = eng._prefill.calls + sum(s.decode.calls for s in eng.stripes)
    want = dict.fromkeys(K.LAUNCHES, 0)
    want["cim_mvm_packed"] = per_exec * runs
    want[ATTN] = attn * runs
    if launches != want:
        raise AssertionError(f"pool-dp: launches {launches}, the path needs "
                             f"{want} ({runs} executions)")
    # a replay equals the eager step, every slot live, stripe by stripe
    replay_eq = []
    for s in eng.stripes:
        saved = {k: v.clone() for k, v in s.pool.items()}
        s.pool["active"].fill_(True)
        clone = {k: v.clone() for k, v in s.pool.items()}
        got = s.decode.fun(s.params, s.pool)[0].clone()
        want_l = eng._step(s.params, clone)[0]
        same = torch.equal(got, want_l) and all(
            torch.equal(s.pool[k], clone[k]) for k in clone)
        for k, v in saved.items():
            s.pool[k].copy_(v)
        if not same:
            raise AssertionError("pool-dp: a replay differs from the eager "
                                 "step")
        replay_eq.append(True)
    replay_ms = median_ms(torch, eng._decode_all, 10)
    eager_ms = median_ms(torch, lambda: [eng._step(s.params, s.pool)
                                         for s in eng.stripes], 10)
    # each request alone on the static path (row 0's chips), and the same
    # stream through the unstriped pool
    alone_err = 0.0
    for r in reqs:
        g = serve.greedy_decode(params, eng.cfg,
                                torch.as_tensor(r.prompt[None]).long()
                                .to(dev), r.max_new, dev, max_len=max_len)
        if g.tokens[0].tolist() != r.tokens:
            raise AssertionError(f"pool-dp: request {r.rid} tokens "
                                 f"{r.tokens} != alone {g.tokens[0]}")
        alone_err = max(alone_err, max(
            float((torch.as_tensor(a) - b[0].cpu()).abs().max())
            for a, b in zip(r.logits, g.logits)))
    whole = ContinuousBatchingEngine(cfg, params, n_slots=c["slots"],
                                     max_len=max_len, chunk=c["chunk"],
                                     capture_logits=True)
    copies = [type(r)(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                      arrival=r.arrival) for r in reqs]
    whole.run(copies, realtime=False)
    pool_err = 0.0
    for r, q in zip(reqs, copies):
        if q.tokens != r.tokens:
            raise AssertionError(f"pool-dp: request {r.rid} striped "
                                 f"{r.tokens} != unstriped {q.tokens}")
        pool_err = max(pool_err, max(float(abs(a - b).max())
                                     for a, b in zip(r.logits, q.logits)))
    if max(alone_err, pool_err) > TRAFFIC_ATOL:
        raise AssertionError(f"pool-dp: logits off alone {alone_err}, "
                             f"unstriped {pool_err} > {TRAFFIC_ATOL}")
    del whole
    return {"config": f"gemma2-9b full width, {cfg.n_layers} of 42 layers, "
                      f"serve-dp's chips, slots {c['slots']} in "
                      f"{DP['data']} stripes, chunk {c['chunk']}, "
                      f"{c['requests']} requests",
            "nvidia_smi": stats["smi"],
            **{k: st[k] for k in ("requests", "tokens", "wall_s",
                                  "tok_per_s", "p50_ms", "p99_ms",
                                  "ttft_p50_ms", "decode_traces",
                                  "utilization")},
            "captures_per_stripe": eng.stripe_traces(),
            "launches": launches, "packed_launches_per_replay": per_exec,
            "replay_equals_eager": replay_eq,
            "replay_ms_all_stripes": replay_ms,
            "eager_ms_all_stripes": eager_ms,
            "alone_max_abs_logit_err": alone_err,
            "unstriped_pool_max_abs_logit_err": pool_err,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def train_dp_phase(torch, dev, stats):
    """train-dp (module docstring)."""
    from repro_torch import configs
    from repro_torch.data import lm_tokens
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.obs.clock import timed_call
    from repro_torch.train.optimizer import tree_leaves
    c = TRAIN_DP
    cfg = configs.get("deepseek-moe-16b").replace(
        dtype=torch.float32, n_layers=1, moe_impl="ep", batch_axes=("data",))
    mesh = dp_mesh(dev, c["mesh"])
    gen = torch.Generator(dev).manual_seed(1000)
    batches = [{"tokens": lm_tokens(gen, c["batch"], c["seq"] + 1,
                                    cfg.vocab)} for _ in range(c["steps"])]

    def masks(params, batch):
        """Where the unmeshed step's gradient (the mean over the
        microbatches, before the clip) is above TRAIN_GRAD_FLOOR of its
        norm or zero: the params held at TRAIN_PARAM_ATOL."""
        g = None
        for i in range(c["accum"]):
            _, gi = steps.loss_and_grads(
                params, steps._micro(batch, c["accum"], i), cfg)
            gi = [x.detach() for x in tree_leaves(gi)]
            g = gi if g is None else [a.add_(b) for a, b in zip(g, gi)]
            del gi
        norm = float(torch.sqrt(sum((x.double() ** 2).sum() for x in g)))
        return [((x.abs() > TRAIN_GRAD_FLOOR * norm) | (x == 0)).cpu()
                for x in g]

    def run(with_masks=False, **kw):
        torch.cuda.reset_peak_memory_stats(dev)
        params = T.init_params(cfg, seed=0, device=dev)
        opt = steps.adamw_init_f32(params)
        if "grad_spec" in kw:
            kw["grad_spec"] = sh.zero_pspecs(params, sh.param_pspecs(params),
                                             mesh)
        step = steps.make_train_step(cfg, lr=c["lr"], accum=c["accum"],
                                     **kw)
        out, first, big, trail, peak = [], None, None, [], 0.0
        with moe.ep_mesh(mesh):
            for i, b in enumerate(batches):
                if with_masks:      # every step's so far, outside the time
                    now = masks(params, b)  # and outside the peak
                    big = now if big is None else [
                        x & y for x, y in zip(big, now)]
                    trail.append(big)
                    torch.cuda.reset_peak_memory_stats(dev)
                (params, opt, loss, gnorm), dt = timed_call(
                    step, params, opt, b, device=dev)
                out.append((float(loss), float(gnorm), dt * 1e3))
                peak = max(peak, torch.cuda.max_memory_allocated(dev) / 1e9)
                if i == 0:          # held on the host: peaks are the run's
                    first = [p.cpu() for p in tree_leaves(params)]
        return params, opt, out, first, trail, peak

    def param_err(got, want, big, k):
        """Largest error where `big`; fails past TRAIN_PARAM_ATOL there, 2
        lr a step elsewhere, or where `big` holds under half the params.
        Returns (error, share of params held)."""
        err, n_big, n_all = 0.0, 0, 0
        for a, b, m in zip(got, want, big):
            d = (a.cpu() - b).abs()
            if bool((d[~m] > 2 * c["lr"] * (k + 1)).any()):
                raise AssertionError(f"after step {k + 1} a param moved by "
                                     f"more than {k + 1} x 2 lr off the "
                                     "held set")
            if m.any():
                err = max(err, float(d[m].max()))
            n_big += int(m.sum())
            n_all += m.numel()
        if err > TRAIN_PARAM_ATOL or n_big < 0.5 * n_all:
            raise AssertionError(f"after step {k + 1} params off by {err} "
                                 f"> {TRAIN_PARAM_ATOL}, or fewer than "
                                 f"half held ({n_big} of {n_all})")
        return err, n_big / n_all

    base, base_opt, base_out, base_first, big, base_peak = run(
        with_masks=True)
    base_last = [x.cpu() for x in tree_leaves(base)]
    n_params = sum(x.numel() for x in base_last)
    del base, base_opt
    free(torch)
    line = {"config": "deepseek-moe-16b full width (64 experts of 1408, "
                      "top-6, 2 shared), 1 of 28 layers, f32, moe_impl ep "
                      f"on a {c['mesh']['data']} x {c['mesh']['model']} mesh "
                      f"over one card, batch {c['batch']} x {c['seq']}, "
                      f"accum {c['accum']}, lr {c['lr']}",
            "nvidia_smi": stats["smi"], "params": n_params,
            "unmeshed": {"loss": [o[0] for o in base_out],
                         "gnorm": [o[1] for o in base_out],
                         "ms_per_step": [o[2] for o in base_out],
                         "peak_mem_gb": base_peak}}
    for sync in ("micro", "once"):
        params, opt, out, first, _, peak = run(
            grad_spec=True, data_axes=("data",), mesh=mesh, grad_sync=sync)
        for (l, g, _), (bl, bg, _) in zip(out, base_out):
            if abs(l - bl) > TRAIN_RTOL * abs(bl) or \
                    abs(g - bg) > TRAIN_RTOL * abs(bg):
                raise AssertionError(f"{sync}: loss {l} / gnorm {g} vs "
                                     f"unmeshed {bl} / {bg}")
        d1, held1 = param_err(first, base_first, big[0], 0)
        d2, held2 = param_err(tree_leaves(params), base_last, big[-1],
                              c["steps"] - 1)
        moments = tree_leaves(opt["m"])
        sharded = sum(isinstance(m, sh.Sharded) and any(
            "data" in sh.spec_axes(a) for a in m.spec) for m in moments)
        line[sync] = {"loss": [o[0] for o in out],
                      "gnorm": [o[1] for o in out],
                      "ms_per_step": [o[2] for o in out],
                      "max_abs_param_diff_step1": d1,
                      "max_abs_param_diff_last": d2,
                      "share_held_step1": held1, "share_held_last": held2,
                      "moment_leaves_data_sharded": sharded,
                      "peak_mem_gb": peak}
        del params, opt, first
        free(torch)
    # the expert-parallel FFN alone (layer 0 of the params at seed 0): the
    # card against its CPU run, and at a capacity that drops nothing
    # against moe_ffn
    layers = T.init_params(cfg, seed=0, device=dev)["layers"]
    p = {k: layers[k][0] for k in ("router", "ew_g", "ew_i", "ew_o", "sw_g",
                                   "sw_i", "sw_o")}
    g = torch.Generator(dev).manual_seed(7)
    x = torch.randn((c["batch"] // c["accum"], c["seq"], cfg.d_model),
                    generator=g, device=dev)
    st_card, st_cpu, st_free = {}, {}, {}
    cpu_mesh = dp_mesh(torch.device("cpu"), c["mesh"])
    with torch.no_grad():
        y = moe.moe_ffn_ep_shardmap(p, x, cfg, mesh, data_axes=("data",),
                                    stats=st_card)
        y_cpu = moe.moe_ffn_ep_shardmap(
            {k: v.cpu() for k, v in p.items()}, x.cpu(), cfg, cpu_mesh,
            data_axes=("data",), stats=st_cpu)
        ep = c["mesh"]["model"]
        y_free = moe.moe_ffn_ep_shardmap(p, x, cfg, mesh,
                                         capacity_factor=float(ep),
                                         data_axes=("data",), stats=st_free)
        y_sort = moe.moe_ffn(p, x, cfg.replace(moe_dropless=True))
    scale = float(y.abs().max())
    e_cpu = float((y.cpu() - y_cpu).abs().max())
    e_sort = float((y_free - y_sort).abs().max())
    if st_card != st_cpu or e_cpu > EP_RTOL * scale:
        raise AssertionError(f"EP card vs CPU: {e_cpu} (scale {scale}), "
                             f"drops {st_card} vs {st_cpu}")
    if any(st_free.values()) or e_sort > EP_RTOL * scale:
        raise AssertionError(f"EP at capacity {ep}: drops {st_free}, "
                             f"{e_sort} off moe_ffn")
    line["ep_ffn"] = {"tokens": x.shape[0] * x.shape[1],
                      "drops_at_1.25": st_card,
                      "card_vs_cpu_max_abs_err": e_cpu,
                      "dropless_capacity": float(ep),
                      "vs_moe_ffn_max_abs_err": e_sort, "scale": scale,
                      "rtol": EP_RTOL}
    del base_first, base_last, big, layers, p, x, y, y_cpu, y_free, y_sort
    free(torch)
    return line


def train_production_phase(torch, dev, stats):
    """train-production (module docstring)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import train
    from repro_torch.train.optimizer import tree_leaves
    out = {"command": TRAIN_PROD + ["--production-mesh"],
           "nvidia_smi": stats["smi"]}
    runs = {}
    for tag, extra in (("unmeshed", []),
                       ("production", ["--production-mesh"])):
        torch.cuda.reset_peak_memory_stats(dev)
        ck = tempfile.mkdtemp(prefix=f"train-{tag}-")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            res = train.run(train.parse_args(TRAIN_PROD + extra
                                             + ["--ckpt-dir", ck]))
        runs[tag] = {"printed": [ln for ln in text.getvalue().splitlines()
                                 if ln.startswith(("arch=", "mesh="))],
                     "loss": res.losses,
                     "ms_per_step": [s * 1e3 for s in res.step_s],
                     "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                     / 1e9}
        if tag == "production":
            leaves = tree_leaves((res.params, res.opt))
            mesh = leaves[0].mesh
            for x in leaves:
                if not isinstance(x, sh.Sharded):
                    raise AssertionError("a leaf is not placed on the mesh")
                whole = x.gather()
                for s, at, d in zip(x.shards, sh.spec_indices(mesh, x.spec),
                                    sh.spec_devices(mesh, x.spec)):
                    if s.device != d or s.data_ptr() != sh.shard_slice(
                            whole, x.spec, mesh.shape, at).data_ptr():
                        raise AssertionError(f"a shard of {x} is not where "
                                             "its spec puts it")
            runs[tag].update(
                mesh=dict(mesh.shape), distinct_devices=mesh.n_distinct(),
                leaves=len(leaves),
                shards=sum(len(x.shards) for x in leaves))
        del res
        free(torch)
    for a, b in zip(runs["production"]["loss"], runs["unmeshed"]["loss"]):
        if abs(a - b) > 2.0 ** -8 * abs(b):
            raise AssertionError(f"production-mesh loss {a} vs unmeshed {b}")
    out.update(runs)
    return out


def dp_phases(torch, K, serve, dev, stats):
    """The data-axis phases, last: serve-dp (its chips kept for pool-dp),
    pool-dp, train-dp, train-production."""
    held = {}

    def serve_dp(*a):
        line, held["res"] = serve_dp_phase(*a)
        return line
    phase("serve-dp")(serve_dp)(torch, K, serve, dev, stats)
    res = held.pop("res", None)
    if res is None:
        failures.append("pool-dp")
        emit({"phase": "pool-dp", "ok": False,
              "error": "no serve-dp chips to serve"})
    else:
        phase("pool-dp")(pool_dp_phase)(torch, K, serve, dev, stats, res)
    del res
    free(torch)
    phase("train-dp")(train_dp_phase)(torch, dev, stats)
    free(torch)
    phase("train-production")(train_production_phase)(torch, dev, stats)
    free(torch)


# ----------------------------------------------- slice 16: the last modules

AUTOTUNE_ROWS = (4, 16, 256)      # the packed layer: split route, edge, walk
AUTOTUNE_MERGED_ROWS = (4, 256)
TILING = dict(shape=(3584, 2048), m=16, cores=4096)   # gemma2-9b's wk
UNFUSED_ROWS = (4, 256)
UNFUSED_IRDROP = dict(shape=(3584, 4096), cores=2048, alpha=2e-7)
DRYRUN_CELLS = (("gemma2-9b", "train_4k"), ("gemma2-9b", "prefill_32k"),
                ("gemma2-9b", "decode_32k"), ("rwkv6-7b", "long_500k"))
# the kernels each example must launch (the LM example's chipsim datapath
# is float: no CIM kernel)
EXAMPLE_KERNELS = {"quickstart": ("cim_mvm",), "lm_cim_serving": (),
                   "image_recovery_rbm": ("cim_mvm_packed",
                                          "cim_mvm_transposed"),
                   "train_cnn_noisy": ("cim_mvm",)}


def merged_chip(torch, cim, CIMConfig, CoreSpec, dev, seed):
    """serve-merged's layer chip: full-width gemma2-9b's seven projections
    on 3072 cores (w_g, w_i and w_o merged into passes), as the serving
    deploy plans them (sorted names)."""
    gen = torch.Generator(dev).manual_seed(seed)
    weights = {n: torch.randn(r, c, generator=gen, device=dev) / r ** 0.5
               for n, (r, c) in sorted(FULL_LAYER.items())}
    return cim.compile_chip(weights, CIMConfig(), CoreSpec(n_cores=3072),
                            "ideal", in_alpha=3.0, generator=gen)


@contextlib.contextmanager
def launched_routes(K):
    """Record the route of every packed-family launch made inside: "split"
    or the walk's pinned layout (None: the rule's)."""
    seen = []
    walk, split = K.launch_walk, K.launch_split

    def rec_walk(*a, layout=None, **kw):
        seen.append(("walk", layout))
        return walk(*a, layout=layout, **kw)

    def rec_split(*a, **kw):
        seen.append(("split", None))
        return split(*a, **kw)
    K.launch_walk, K.launch_split = rec_walk, rec_split
    try:
        yield seen
    finally:
        K.launch_walk, K.launch_split = walk, split


def tune_plan(torch, K, ops, autotune, p, x, label, flush, stats):
    """autotune.tune on plan p at x (the default timer: CUDA events, best
    of 3 after a warm-up), every candidate checked bit for bit against the
    default route inside tune; then a serving call with the route left
    open takes the winner (its launch recorded) and equals the default
    route bit for bit; the default and the winner timed after an L2 flush
    each (median of 20)."""
    from repro_torch.core.types import CIMConfig
    cfg = CIMConfig()
    m = x.shape[0]
    want = ops.cim_mvm_packed(x, p, cfg, route=K.RULE)
    check_equal(torch, want, ops.cim_mvm_packed(x, p, cfg, impl="plain"),
                f"{label} M={m} default route", stats, p.route())
    winner, timings = autotune.tune(x, p, activation=cfg.activation,
                                    n_max=cfg.out_mag_levels,
                                    v_read=cfg.v_read, refresh=True)
    before = dict(K.LAUNCHES)
    with launched_routes(K) as seen:
        got = ops.cim_mvm_packed(x, p, cfg)
    torch.cuda.synchronize()
    launches = {k: n - before[k] for k, n in K.LAUNCHES.items()
                if n != before[k]}
    stats["launches"].setdefault("autotune-serve", {})
    for k, n in launches.items():
        stats["launches"]["autotune-serve"][k] = \
            stats["launches"]["autotune-serve"].get(k, 0) + n
    served = seen[0] if len(seen) == 1 else seen
    if served != (winner.kind, winner.layout):
        raise AssertionError(f"{label} M={m}: the serving call took {seen}, "
                             f"the cached winner is {winner}")
    check_equal(torch, got, want, f"{label} M={m} tuned route", stats,
                p.route())
    default_ms = median_ms(torch, lambda: ops.cim_mvm_packed(
        x, p, cfg, route=K.RULE), 20, flush)
    tuned_ms = median_ms(torch, lambda: ops.cim_mvm_packed(x, p, cfg), 20,
                         flush)
    row = {"plan": label, "kernel": p.route(), "m": m,
           "candidates_ms": {str(r): t for r, t in timings.items()},
           "winner": str(winner), "all_bit_equal": True,
           "served_route": str(winner), "launches": launches,
           "default_ms": default_ms, "tuned_ms": tuned_ms}
    emit({"phase": "autotune-shape", **row})
    return row


@phase("autotune")
def autotune_phase(torch, K, ops, cim, CIMConfig, CoreSpec, dev, stats,
                   merged):
    from repro_torch.core.conductance import weights_to_conductances
    from repro_torch.kernels.cim_mvm import autotune
    autotune.clear()
    gen = torch.Generator(dev).manual_seed(21)
    flush = torch.empty(64 * 1024 * 1024, device=dev)   # 256 MB > L2
    r, c = FULL_LAYER["w_g"]
    w = torch.randn(r, c, generator=gen, device=dev) / r ** 0.5
    p = cim.compile_chip({"w_g": w}, CIMConfig(), CoreSpec(n_cores=6144),
                         "ideal", in_alpha=3.0,
                         generator=gen).layers["w_g"].packed
    del w
    if p.route() != "cim_mvm_packed":
        raise AssertionError(f"w_g routes to {p.route()}")
    rows = []
    for m in AUTOTUNE_ROWS:
        x = torch.randint(-7, 8, (m, r), generator=gen,
                          device=dev).to(torch.float32)
        rows.append(tune_plan(torch, K, ops, autotune, p, x,
                              "w_g 6144 cores", flush, stats))
    del p
    pm = merged.layers["w_g"].packed
    if pm.route() != "cim_mvm_scheduled":
        raise AssertionError(f"merged w_g routes to {pm.route()}")
    for m in AUTOTUNE_MERGED_ROWS:
        x = torch.randint(-7, 8, (m, r), generator=gen,
                          device=dev).to(torch.float32)
        rows.append(tune_plan(torch, K, ops, autotune, pm, x,
                              "w_g merged 3072 cores", flush, stats))
    # plan-time re-tiling of one layer, on a chip with cores enough for
    # every halving of the core caps
    tr, tc = TILING["shape"]
    cfg = CIMConfig()
    cond = weights_to_conductances(
        torch.randn(tr, tc, generator=gen, device=dev) / tr ** 0.5,
        cfg.device)
    gd, gs = cond.g_pos - cond.g_neg, cond.g_pos + cond.g_neg
    spec = CoreSpec(n_cores=TILING["cores"])
    x = torch.randint(-7, 8, (TILING["m"], tr), generator=gen,
                      device=dev).to(torch.float32)
    cands = autotune.tiling_candidates(tr, tc, spec)
    if len(cands) < 3:
        raise AssertionError(f"only {len(cands)} tiling candidates")
    winner, timings = autotune.tune_tiling(
        x, gd, gsum=gs, v_decr=0.002, activation=cfg.activation,
        n_max=cfg.out_mag_levels, v_read=cfg.v_read, spec=spec,
        refresh=True)
    for bk, bn in cands:
        rp = autotune.retile(gd, bk, bn, gsum=gs, v_decr=0.002)
        check_equal(torch, ops.cim_mvm_packed(x, rp, cfg),
                    ops.cim_mvm_packed(x, rp, cfg, impl="plain"),
                    f"retile {bk}x{bn} M={TILING['m']}", stats, rp.route())
    tiling = {"layer": [tr, tc], "m": TILING["m"], "cores": spec.n_cores,
              "candidates_ms": {f"{bk}x{bn}": t
                                for (bk, bn), t in timings.items()},
              "winner": f"{winner[0]}x{winner[1]}",
              "each_equal_to_its_plain_version": True}
    emit({"phase": "autotune-tiling", **tiling})
    autotune.clear()
    stats["time"].setdefault("cim_mvm_packed", {})["tuned_ms"] = {
        r_["m"]: r_["tuned_ms"] for r_ in rows if "6144" in r_["plan"]}
    stats["time"].setdefault("cim_mvm_scheduled", {})["tuned_ms"] = {
        r_["m"]: r_["tuned_ms"] for r_ in rows if "merged" in r_["plan"]}
    return {"plans": len(rows), "tiling_candidates": len(cands),
            "winners": {f"{r_['plan']} M={r_['m']}": r_["winner"]
                        for r_ in rows},
            "tiling_winner": tiling["winner"]}


def unfused_plan(torch, ops, p, x, label, flush, stats):
    """fused=False against fused=True on plan p at x: bit for bit with the
    valid-column mask as the weight (integer counts, fold_norm=False) in
    every activation but identity (the raw charge, not a count), each
    against its own plain version with the plan's denorm and with the
    mask in every activation; both timed (median of 20 after an L2
    flush)."""
    import dataclasses
    from repro_torch.core.types import CIMConfig
    kernel = p.route(True)
    mask = dataclasses.replace(
        p, denorm_tiles=(p.inv_norm_tiles > 0).to(torch.float32))
    for plan in (p, mask):
        for act in ALL_ACTIVATIONS:
            cfg = CIMConfig(activation=act)
            kw = dict(seed=SEED, scheduled=True)
            a = ops.cim_mvm_packed(x, plan, cfg, fused=False, **kw)
            check_equal(torch, a, ops.cim_mvm_packed(
                x, plan, cfg, fused=False, impl="plain", **kw),
                f"{label} unfused M={x.shape[0]} {act}", stats, kernel)
            b = ops.cim_mvm_packed(x, plan, cfg, **kw)
            check_equal(torch, b, ops.cim_mvm_packed(
                x, plan, cfg, impl="plain", **kw),
                f"{label} fused M={x.shape[0]} {act}", stats, kernel)
            if plan is mask and act != "identity":
                # counts are integers, so any grouping of their sum is
                # exact; the identity epilogue passes the raw charge on
                check_equal(torch, a, b, f"{label} unfused vs fused "
                            f"M={x.shape[0]} {act}", stats, kernel)
    cfg = CIMConfig()
    t = {}
    for fused in (True, False, False, True):
        run = lambda: ops.cim_mvm_packed(x, p, cfg, scheduled=True,
                                         fused=fused)
        run()
        t.setdefault(fused, []).append(median_ms(torch, run, 20, flush))
    row = {"plan": label, "kernel": kernel, "m": x.shape[0],
           "slots": p.n_tiles, "passes": p.n_passes,
           "fused_runs": sum(1 for c in p.out_col if c >= 0),
           "fused_ms": t[True], "unfused_ms": t[False],
           "bit_equal_on_counts": True}
    emit({"phase": "unfused-shape", **row})
    return row


@phase("packed-unfused")
def packed_unfused_phase(torch, K, ops, cim, CIMConfig, CoreSpec, dev,
                         stats, merged):
    from repro_torch.core.types import NonIdealityConfig
    gen = torch.Generator(dev).manual_seed(22)
    flush = torch.empty(64 * 1024 * 1024, device=dev)   # 256 MB > L2
    ir_r, ir_c = UNFUSED_IRDROP["shape"]
    ir_cfg = CIMConfig(nonideal=NonIdealityConfig(
        ir_drop_alpha=UNFUSED_IRDROP["alpha"]))
    ir = cim.compile_chip(
        {"wq": torch.randn(ir_r, ir_c, generator=gen, device=dev)
         / ir_r ** 0.5}, ir_cfg, CoreSpec(n_cores=UNFUSED_IRDROP["cores"]),
        "ideal", in_alpha=3.0, generator=gen).layers["wq"].packed
    plans = [(f"merged {n}", merged.layers[n].packed)
             for n in ("w_g", "w_i", "w_o")]
    plans += [("ir-drop wq", ir),
              ("rbm bwd 784+10 x 120", rbm_bwd_plan(torch, dev, gen, 794,
                                                    120, False))]
    reset_launches(K)
    rows = []
    for label, p in plans:
        if p.route(True) == "cim_mvm_packed" or (
                p.n_passes < 2 and not p.transpose):
            raise AssertionError(f"{label}: {p.n_passes} passes, route "
                                 f"{p.route()}")
        for m in UNFUSED_ROWS:
            if p.transpose:
                x = torch.randint(0, 2, (m, p.n_rows), generator=gen,
                                  device=dev).to(torch.float32)
            else:
                x = torch.randint(-7, 8, (m, p.n_rows), generator=gen,
                                  device=dev).to(torch.float32)
            rows.append(unfused_plan(torch, ops, p, x, label, flush, stats))
    stats["launches"]["packed-unfused"] = {k: n for k, n in
                                           K.LAUNCHES.items() if n}
    for kernel in ("cim_mvm_scheduled", "cim_mvm_transposed"):
        stats["time"].setdefault(kernel, {})["unfused_ms"] = {
            f"{r_['plan']} M={r_['m']}": r_["unfused_ms"]
            for r_ in rows if r_["kernel"] == kernel}
        stats["time"][kernel]["unfused_fused_ms"] = {
            f"{r_['plan']} M={r_['m']}": r_["fused_ms"]
            for r_ in rows if r_["kernel"] == kernel}
    return {"plans": len(plans), "shapes": len(rows),
            "launches": stats["launches"]["packed-unfused"]}


@phase("dryrun")
def dryrun_phase(torch):
    """launch/dryrun.lower_cell on DRYRUN_CELLS at full config on the
    16 x 16 production mesh of meta devices: each record's roofline terms
    and model_over_hlo; no CUDA memory allocated while they run."""
    from repro_torch.launch import dryrun
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cells = []
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec, _ = dryrun.lower_cell(arch, shape, multi_pod=False)
        roof = rec["roofline"]
        line = {"arch": arch, "shape": shape, "mesh": rec["mesh"],
                "layer_pair": rec["layer_pair"], "accum": rec["accum"],
                "fsdp": rec["fsdp"],
                "hlo_flops_per_dev": rec["hlo_flops_per_dev"],
                "hlo_bytes_per_dev": rec["hlo_bytes_per_dev"],
                "collective_bytes_per_dev": rec["collective_bytes_per_dev"],
                "memory": rec["memory"],
                "model_over_hlo": rec["model_over_hlo"],
                **{k: roof[k] for k in ("compute_s", "memory_s",
                                        "collective_s", "dominant",
                                        "roofline_fraction")},
                "seconds": time.perf_counter() - t0}
        emit({"phase": "dryrun-cell", **line})
        cells.append(line)
        if not all(math.isfinite(roof[k]) for k in
                   ("compute_s", "memory_s", "collective_s")):
            raise AssertionError(f"{arch} {shape}: non-finite roofline")
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    if after != before or peak != before:
        raise AssertionError(f"the dry run allocated CUDA memory: {before} "
                             f"B before, {after} after, peak {peak}")
    return {"cells": len(cells), "cuda_bytes_allocated": peak - before,
            "model_over_hlo": {f"{c['arch']} {c['shape']}":
                               c["model_over_hlo"] for c in cells}}


@phase("examples")
def examples_phase(torch, K, stats):
    """The four example scripts on the card (`python -m
    repro_torch.examples.<name>`'s main, in this process): their printed
    lines forwarded, wall seconds beside the card's name and power limit,
    each one's kernel launches (each example that programs a chip must
    launch its kernels), the RBM's L2 error falling."""
    import importlib
    import re
    out = {}
    for name, kernels in EXAMPLE_KERNELS.items():
        module = importlib.import_module(f"repro_torch.examples.{name}")
        reset_launches(K)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            module.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: n for k, n in K.LAUNCHES.items() if n}
        stats["launches"][f"example-{name}"] = launches
        lines = buf.getvalue().splitlines()
        emit({"phase": "example", "name": name, "lines": lines,
              "wall_s": wall, "launches": launches,
              "nvidia_smi": stats["smi"]})
        missing = [k for k in kernels if not launches.get(k)]
        if missing:
            raise AssertionError(f"{name} launched no {missing}")
        if name == "image_recovery_rbm":
            errs = [re.search(r"L2 error ([0-9.]+) -> ([0-9.]+)", ln)
                    for ln in lines]
            errs = [(float(e[1]), float(e[2])) for e in errs if e]
            if len(errs) != 2 or any(b >= a for a, b in errs):
                raise AssertionError(f"the RBM's L2 error did not fall: "
                                     f"{errs}")
        out[name] = {"wall_s": wall, "lines": len(lines)}
    return {"examples": out}


def module_phases(torch, K, ops, cim, CIMConfig, CoreSpec, dev, stats):
    """The phases of the last modules: autotune and packed-unfused on one
    serve-merged chip, then the dry run and the examples."""
    merged = merged_chip(torch, cim, CIMConfig, CoreSpec, dev, 20)
    autotune_phase(torch, K, ops, cim, CIMConfig, CoreSpec, dev, stats,
                   merged)
    free(torch)
    packed_unfused_phase(torch, K, ops, cim, CIMConfig, CoreSpec, dev,
                         stats, merged)
    del merged
    free(torch)
    dryrun_phase(torch)
    examples_phase(torch, K, stats)
    free(torch)


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
             "profile_cnn": [], "profile_moe": [], "profile_rec": []}
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
    moe_phases(torch, K, ops, serve, dev, stats)
    arch_phases(torch, K, ops, serve, dev, stats, RECURRENT_PATHS)
    batch_invariance_phase(torch, dev)
    arch_phases(torch, K, ops, serve, dev, stats, ARCH_PATHS)
    attention_long_phase(torch, dev)
    attention_phase(torch, dev, stats)
    for queue in ("profile", "profile_cnn", "profile_moe", "profile_rec"):
        stats[queue].clear()
    free(torch)
    train_lm_phase(torch, K, dev, stats)
    train_lm_parity_phase(torch, dev)
    train_resume_phase(torch, dev)
    free(torch)
    tp_phases(torch, K, ops, serve, dev, stats)
    free(torch)
    dp_phases(torch, K, serve, dev, stats)
    free(torch)
    module_phases(torch, K, ops, cim, CIMConfig, CoreSpec, dev, stats)

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
