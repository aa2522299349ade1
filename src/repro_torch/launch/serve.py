"""Serving driver of the port: static-batch and continuous-batching request
serving, optionally with every dense-block projection served by its
compiled NeuRRAM chip (port of `repro/launch/serve.py`, one process).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
      --cim --cim-cores 6144 --layers 4 --batch 4 --prompt-len 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
      --cim --cim-cores 6144 --layers 4 --traffic --requests 16 --slots 4
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-moe-16b --cim --cim-cores 2048 --layers 2 --gen 8

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --cim --cim-cores 8192 --layers 4 --gen 32 [--traffic]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \
      --cim --cim-cores 32768 --layers 2 --gen 16 [--traffic]
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-medium --cim --cim-cores 128 --gen 8

Archs: gemma2-9b, qwen2-72b, codeqwen1.5-7b and granite-20b (dense; the
qwen family with a float QKV bias, granite with one KV head),
internvl2-1b (a vision-prefix VLM), seamless-m4t-medium (an
encoder-decoder), deepseek-moe-16b and llama4-maverick-400b-a17b (MoE;
llama4 only at --smoke: one full-width layer's experts exceed a card),
rwkv6-7b and zamba2-7b (recurrent: `models/rwkv6.py`,
`models/mamba2.py`). Single-pass plans of a full-width layer need 32768
cores for qwen2-72b (26,816 tiles, 878 M weights: a depth cut), 8192 for
codeqwen1.5-7b (7104), 16384 for granite-20b (16,176) and 512 for
internvl2-1b (501); seamless-m4t-medium's 512 tiles a layer merge onto
as few as 128 cores (the scheduled kernel). The encoder-decoder encodes
seeded source embeddings (batch, prompt_len, d) once with its float
encoder and feeds the memory to every prefill and decode call; its
cross-attention, like the QKV bias, stays float. As in the reference,
the static driver does not run a VLM's vision prefix (its cache leaves
room for one): `serve_static(vis_prefix=True)` runs seeded embeddings
through `steps.make_prefill_step` ahead of the prompt. --traffic serves
the decoder-only archs. Under --cim a recurrent arch compiles each layer's
projections onto one chip and zamba2's shared attention block onto one
of its own (`nn.deploy_recurrent_cim`); the S / h recurrences stay float.
Full-width rwkv6-7b needs 6656 cores per layer chip, zamba2-7b 7084 (its
shared block 6272) for single-pass plans. zamba2 scans in chunks of 64:
--traffic serves it with --chunk 64 so the pool's chunks match the static
prefill's. Under --cim an MoE arch compiles each layer's attention and
shared-expert projections onto one chip and each routed expert onto one
of its own (`models/moe.py`); every expert runs one launch per
projection and step. Full-width deepseek-moe-16b needs 1040 cores for
its layer chips and 280 for each expert chip to stay single-pass
(`--cim-cores 2048`), and a depth cut: a layer's 588 M weights take about
10 GB.

Two modes share one compiled chip stack (weight-stationary):

  * default (static batch): one fixed request batch is prefilled once,
    then decoded token by token in lockstep (greedy), the KV cache
    updated in place.
  * --traffic (continuous batching): an open-loop Poisson request stream
    (data/synthetic.traffic_requests: mixed prompt lengths, per-request
    generation budgets) drives launch/scheduler.ContinuousBatchingEngine:
    a slotted KV pool with admission and eviction between decode steps
    and chunked prefill interleaved with decode. Reports p50/p99 token
    latency, TTFT and tokens/sec; the decode step compiles ONCE across
    all occupancy changes (on the card: one captured CUDA graph, replayed
    every step; asserted here).

Both modes meter the modeled chip energy (obs/chipmeter) and write the
reference's observability files on request (--metrics-out, --prom-out,
--trace-out, --summary-out; --strict-jit turns any compilation after
warmup into an error). With --cim each layer's
seven projections are compiled onto one simulated chip first (plan ->
schedule -> program -> calibrate -> pack, `core.cim.compile_chip`), and
prefill and decode run every projection as one kernel launch. Full-width
gemma2-9b needs at least 6048 cores for single-pass plans (one layer is
6048 tiles of 128x256 weights, far above NeuRRAM's 48 cores) and a depth
cut: each layer's weights, conductances and packed tiles take 3.2 GB.

Fewer cores than tiles (`--cim-cores 3072`) merge tiles onto shared cores:
those projections' plans serialize into passes and run on the scheduled
kernel, the others on the packed kernel. `--cim-ir-drop A` plans the
chip's IR drop (alpha A in 1/uS): the planner caps the columns per core
(47 at 2e-7), so a full-width layer needs about 33,000 tiles and, at
`--cim-cores 32768`, every projection merges and runs scheduled.

Tensor parallelism (`--cim-mesh auto|off|DxM`): each projection compiles
one chip per 'model' shard from its local slice (`nn.deploy_cim` with a
`launch/mesh.Mesh`), placed on the mesh's 'model' device s, and every
call launches each shard's kernel where its chips lie
(`nn.sharded_packed_loop`). 'auto' (the default) factors this process's
local devices as the reference does (`launch/mesh.serving_mesh`:
{'data': n // M, 'model': M}, M the largest power of two dividing n, at
most 16; one card gives 1x1, 6 cards 3x2); 'off' deploys at the same
'model' width with every chip on the serving device; 'DxM' asks for that
shape over the local devices. A 'data' width D above 1 gives each data
row its own copy of the chips (`nn.row_params`): the static path stripes
the batch over the rows (the reference's `batch_pspecs` and
`cache_pspecs(data_axes=("data",))`: each row prefills and decodes its
batch / D rows, with its own cache, on its first device; a batch that
does not divide runs whole on row 0, as `fit_pspecs` replicates it), and
--traffic serves the striped slot pool (`launch/scheduler`). The KV
cache's head_dim stays whole on its row: the port's 'model' axis splits
the chips only. Shards and rows on distinct cards are untried (ROADMAP
A13). From Python, `serve_static` / `serve_traffic(mesh_shape=, mesh=)`
take any mesh, one that repeats a device included: gemma2-9b at full
width deploys eight shard chips per layer (`mesh_shape={'model': 8}`,
`mesh=Mesh([['cuda:0'] * 8])`), one packed launch per projection and
shard, and `Mesh([['cuda:0'] * 2] * 2)` serves two data rows of two
shards each.

Multi-process scale-out (`launch/distributed`): launched through
`launch/env` (REPRO_COORDINATOR / REPRO_NUM_PROCESSES / REPRO_PROCESS_ID
set), serve joins the process group (gloo) first and every rank
becomes one data-parallel replica with its own chips, deterministic from
the shared seeds; in --traffic mode it serves the subset of the one seeded
stream that `distributed.route_requests` assigns it. Rank 0 owns the
output files: the per-rank summaries and rank-tagged metrics gather
through the group's store and rank 0 writes the merged ones. The
one-capture contract is asserted per rank before the gather.
--results-out writes each served request's tokens and logits
(`{rank}` in the path becomes the rank).

    PYTHONPATH=src python -m repro_torch.launch.env --procs 2 -- \
        python -m repro_torch.launch.serve --arch gemma2-9b --layers 1 \
        --cim --cim-cores 6144 --traffic --requests 8

Runs on the card unless `--device cpu` is given; without CUDA it raises.
Times are CUDA-event times on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

import torch

from .. import configs
from ..data import lm_tokens, traffic_requests
from ..device import resolve_device
from ..kernels.cim_mvm import kernel as cim_kernel
from ..models import transformer as T
from ..obs import MetricsRegistry, TraceBuffer
from ..obs.chipmeter import ChipMeter
from ..obs.clock import stopwatch, timed_call
from . import distributed as dist
from .scheduler import ContinuousBatchingEngine, Request
from .steps import arch_serving, make_decode_step, make_prefill_step


def serving_config(arch: str = "gemma2-9b", *, smoke: bool = False,
                   cim: bool = False, cim_bits: int = 0,
                   cim_ir_drop: float = 0.0,
                   n_layers: Optional[int] = None):
    """The arch config the driver serves: f32 under --cim (as the
    reference forces), `n_layers` cuts the depth."""
    cfg = configs.get(arch, smoke=smoke)
    cfg = cfg.replace(dtype=torch.float32 if smoke else cfg.dtype)
    if cim:
        cfg = cfg.replace(cim_mode="packed", dtype=torch.float32,
                          cim_ir_drop=cim_ir_drop)
        if cim_bits:
            if not 1 <= cim_bits <= 8:
                raise ValueError(f"cim_bits must be in 1..8, got {cim_bits}")
            cfg = cfg.replace(cim_in_bits=cim_bits)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    return cfg


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor          # (B, gen) greedy tokens
    logits: List[torch.Tensor]    # per generated token, (B, V) f32
    prefill_s: float
    decode_s: List[float]         # per decode step


def greedy_decode(params, cfg, prompts, gen: int, device, *,
                  teacher: Optional[torch.Tensor] = None,
                  max_len: Optional[int] = None,
                  memory: Optional[torch.Tensor] = None,
                  vis_embeds: Optional[torch.Tensor] = None,
                  stripes: Optional[list] = None) -> Generation:
    """Prefill `prompts` (B, S) and decode gen - 1 more tokens greedily.
    teacher: optional (B, >= gen - 1) tokens fed instead of the greedy
    ones (a second run that must follow the first run's path). max_len:
    the cache's length (default S + gen + the arch's vis_patches, as the
    reference sizes it). memory: an encoder-decoder's encoded source, fed
    to the prefill and every decode step; vis_embeds: a VLM's vision
    prefix, prefilled ahead of the prompt. stripes: the data rows' params
    (`nn.row_params`); row r prefills and decodes rows r * B/D .. (r + 1)
    * B/D - 1 of every input with a cache of its own on its params'
    device, each step enqueued on every row before the logits are
    gathered on `device` in row order."""
    b, s = prompts.shape
    rows = stripes or [params]
    n = len(rows)
    if b % n:
        raise ValueError(f"a batch of {b} does not stripe over {n} rows")
    m = b // n
    devs = [p["embed"].device for p in rows] if stripes else [device]
    caches = [arch_serving(cfg, d).init_state(
        m, max_len or s + gen + cfg.vis_patches) for d in devs]
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    def run(step, batch):
        outs = [step(rows[r], caches[r], {
            k: v[r * m:(r + 1) * m].to(devs[r]) for k, v in batch.items()})
            for r in range(n)]
        caches[:] = [c for _, c in outs]
        return torch.cat([lg.to(device) for lg, _ in outs])

    extra = {} if memory is None else {"memory": memory}
    first = dict(extra, tokens=prompts)
    if vis_embeds is not None:
        first["vis_embeds"] = vis_embeds
    logits, t_prefill = timed_call(run, prefill, first, device=device)
    out, all_logits, step_s = [], [logits], []
    tok = torch.argmax(logits, -1)[:, None]
    out.append(tok)
    for i in range(gen - 1):
        feed = tok if teacher is None else teacher[:, i:i + 1]
        logits, dt = timed_call(run, decode, dict(extra, tokens=feed),
                                device=device)
        step_s.append(dt)
        all_logits.append(logits)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
    return Generation(torch.cat(out, dim=1), all_logits, t_prefill, step_s)


@dataclasses.dataclass
class ServeResult:
    cfg: object
    params: dict
    prompts: torch.Tensor
    out: Generation
    deploy_s: float
    memory: Optional[torch.Tensor] = None      # encdec: the encoded source
    vis_embeds: Optional[torch.Tensor] = None  # vlm: the prefix it ran


def deploy(arch: str = "gemma2-9b", *, smoke: bool = False,
           cim: bool = False, cim_mode: str = "ideal", cim_bits: int = 0,
           cim_cores: int = 0, cim_ir_drop: float = 0.0,
           device: Optional[str] = None, n_layers: Optional[int] = None,
           params=None, x_cal=None, mesh_shape=None, mesh=None,
           x_cal_shards=None):
    """(cfg, params, deploy seconds): the served config, its params (drawn
    from a generator seeded 0 unless given, on `device`) and, under
    `cim`, every projection compiled onto its chip (calibration batches
    from a generator seeded 7 unless `x_cal` / `x_cal_shards` are given),
    one per tensor-parallel shard at mesh_shape's 'model' width, placed
    on `mesh` (which the config then serves on: cfg.cim_mesh)."""
    dev = resolve_device(device)
    cfg = serving_config(arch, smoke=smoke, cim=cim, cim_bits=cim_bits,
                         cim_ir_drop=cim_ir_drop, n_layers=n_layers)
    if mesh is not None:
        cfg = cfg.replace(cim_mesh=mesh)
    sv = arch_serving(cfg, dev)
    if params is None:
        params = sv.init_params(0)
    deploy_s = 0.0
    if cim:
        if dev.type == "cuda":
            cim_kernel.load()      # nvcc at first use: set-up, not serving
        from ..core.types import CoreSpec
        spec = CoreSpec(n_cores=cim_cores) if cim_cores else None
        with stopwatch() as sw:
            params = sv.deploy_cim(params, mode=cim_mode, spec=spec,
                                   x_cal=x_cal, mesh_shape=mesh_shape,
                                   mesh=mesh, x_cal_shards=x_cal_shards)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        deploy_s = sw.s
    return cfg, params, deploy_s


def serve_static(arch: str = "gemma2-9b", *, smoke: bool = False,
                 batch: int = 4, prompt_len: int = 64, gen: int = 32,
                 cim: bool = False, cim_mode: str = "ideal",
                 cim_bits: int = 0, cim_cores: int = 0,
                 cim_ir_drop: float = 0.0, device: Optional[str] = None,
                 n_layers: Optional[int] = None,
                 params=None, prompts=None, x_cal=None, src_embeds=None,
                 vis_prefix: bool = False, vis_embeds=None,
                 mesh_shape=None, mesh=None,
                 x_cal_shards=None) -> ServeResult:
    """Build (or take) params, deploy the chip under `cim`, serve one
    static batch. The params, prompts and calibration batches are drawn
    from generators seeded 0, 1 and 7; params / prompts / x_cal, when
    given, replace those draws (params must already be on `device`). An
    encoder-decoder encodes `src_embeds` (default 0.02 * normal (batch,
    prompt_len, d), seeded 2) once; its memory feeds prefill and decode.
    vis_prefix: a VLM's prefill runs `vis_embeds` (default 0.02 * normal
    (batch, vis_patches, d), seeded 3) ahead of the prompt. mesh_shape /
    mesh / x_cal_shards: a tensor-parallel deploy (`deploy`)."""
    dev = resolve_device(device)
    cfg, params, deploy_s = deploy(
        arch, smoke=smoke, cim=cim, cim_mode=cim_mode, cim_bits=cim_bits,
        cim_cores=cim_cores, cim_ir_drop=cim_ir_drop, device=dev,
        n_layers=n_layers, params=params, x_cal=x_cal,
        mesh_shape=mesh_shape, mesh=mesh, x_cal_shards=x_cal_shards)
    if prompts is None:
        prompts = lm_tokens(torch.Generator(dev).manual_seed(1), batch,
                            prompt_len, cfg.vocab)
    prompts = prompts.to(dev)
    memory = None
    if cfg.enc_layers > 0:
        if src_embeds is None:
            src_embeds = _seeded_embeds(2, (batch, prompt_len), cfg, dev)
        memory = T._encode(params, src_embeds.to(dev), cfg)
    if vis_prefix and vis_embeds is None:
        vis_embeds = _seeded_embeds(3, (batch, cfg.vis_patches), cfg, dev)
    if vis_embeds is not None:
        vis_embeds = vis_embeds.to(dev)
    out = greedy_decode(params, cfg, prompts, gen, dev, memory=memory,
                        vis_embeds=vis_embeds,
                        stripes=data_stripes(params, prompts.shape[0]))
    return ServeResult(cfg, params, prompts, out, deploy_s, memory,
                       vis_embeds)


def data_stripes(params, batch: int):
    """The data rows' params a batch of `batch` stripes over
    (`nn.row_params`), or None: no data rows, or a batch the row count
    does not divide (served whole on row 0, as the reference's fit_pspecs
    replicates it)."""
    rows = params.get("cim_rows")
    if rows is None or batch % len(rows):
        return None
    from ..models.nn import row_params
    return [row_params(params, r) for r in range(len(rows))]


def _seeded_embeds(seed: int, lead, cfg, device):
    """0.02 * normal (*lead, d_model) from a generator seeded `seed`: the
    stub frontend's embeddings."""
    gen = torch.Generator(device).manual_seed(seed)
    return (0.02 * torch.randn((*lead, cfg.d_model), generator=gen,
                               device=device)).to(cfg.dtype)


def traffic_stream(cfg, n_requests: int, *, prompt_len: int, gen: int,
                   chunk: int, rate: float, device):
    """(requests, max_len): the open-loop stream --traffic serves, drawn
    by `data.traffic_requests` from a generator seeded 1 on `device`:
    prompts in pages of `chunk` tokens up to prompt_len (rounded down to
    a page), gen // 2 .. gen tokens each, Poisson arrivals at `rate`
    req/s; max_len is a slot's length."""
    page = chunk
    max_prompt = max(prompt_len - prompt_len % page, page)
    gen_hi = max(gen, 2)
    tr = traffic_requests(torch.Generator(device).manual_seed(1),
                          n_requests, cfg.vocab, min_len=page,
                          max_len=max_prompt, page=page, rate=rate,
                          min_gen=max(gen // 2, 1), max_gen=gen_hi)
    toks, lens = tr.tokens.cpu().numpy(), tr.lengths.cpu().numpy()
    gens, arrivals = tr.gen.cpu().tolist(), tr.arrivals.cpu().tolist()
    reqs = [Request(rid=i, prompt=toks[i, :lens[i]], max_new=gens[i],
                    arrival=arrivals[i]) for i in range(n_requests)]
    return reqs, max_prompt + gen_hi


@dataclasses.dataclass
class TrafficResult:
    cfg: object
    params: dict
    requests: list                # scheduler.Request, results filled in
    stats: dict                   # ContinuousBatchingEngine.run's summary
    engine: object
    deploy_s: float


def serve_traffic(arch: str = "gemma2-9b", *, smoke: bool = False,
                  requests: int = 16, slots: int = 4, chunk: int = 32,
                  rate: float = 50.0, prompt_len: int = 64, gen: int = 32,
                  cim: bool = False, cim_mode: str = "ideal",
                  cim_bits: int = 0, cim_cores: int = 0,
                  cim_ir_drop: float = 0.0, device: Optional[str] = None,
                  n_layers: Optional[int] = None,
                  capture_logits: bool = False, metrics=None, trace=None,
                  strict_jit: bool = False, mesh_shape=None, mesh=None,
                  rank: int = 0, n_ranks: int = 1) -> TrafficResult:
    """Deploy as `serve_static` does, then serve `traffic_stream`'s
    requests in real time through a `slots`-slot continuous-batching
    engine with `chunk`-token prefill chunks: all of them, or replica
    `rank`'s share of `n_ranks` (`distributed.route_requests`).
    Encoder-decoder and VLM archs are refused, as the reference refuses
    them."""
    dev = resolve_device(device)
    arch_cfg = configs.get(arch, smoke=smoke)
    if arch_cfg.enc_layers > 0 or arch_cfg.vis_patches > 0:
        raise SystemExit("--traffic serves decoder-only archs (enc-dec / "
                         "vlm prefixes need per-slot memory plumbing)")
    cfg, params, deploy_s = deploy(
        arch, smoke=smoke, cim=cim, cim_mode=cim_mode, cim_bits=cim_bits,
        cim_cores=cim_cores, cim_ir_drop=cim_ir_drop, device=dev,
        n_layers=n_layers, mesh_shape=mesh_shape, mesh=mesh)
    reqs, max_len = traffic_stream(cfg, requests, prompt_len=prompt_len,
                                   gen=gen, chunk=chunk, rate=rate,
                                   device=dev)
    reqs = dist.route_requests(reqs, n_ranks, rank)
    eng = ContinuousBatchingEngine(cfg, params, n_slots=slots,
                                   max_len=max_len, chunk=chunk, mesh=mesh,
                                   capture_logits=capture_logits,
                                   metrics=metrics, trace=trace,
                                   strict_jit=strict_jit)
    stats = eng.run(reqs)
    return TrafficResult(cfg, params, reqs, stats, eng, deploy_s)


def _add_obs_flags(ap):
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics registry as JSON at exit")
    ap.add_argument("--prom-out", default="",
                    help="write the metrics registry in Prometheus text "
                         "exposition format at exit")
    ap.add_argument("--trace-out", default="",
                    help="write per-request span timelines and the "
                         "engine's host spans (per call, per layer, the "
                         "MoE FFN's phases) as Chrome trace-event JSON at "
                         "exit, ts on the Unix clock: it overlays a "
                         "torch.profiler Chrome export in Perfetto")
    ap.add_argument("--summary-out", default="",
                    help="write the run's summary stats as JSON")
    ap.add_argument("--strict-jit", action="store_true",
                    help="make the one-compilation contract a hard "
                         "assertion: any compilation after warmup raises")


def _write_obs(args, metrics, trace=None, summary=None, extra_labels=None):
    """Flush whichever observability outputs were requested. `metrics` is
    a MetricsRegistry, or an already merged `to_dict` document (the
    multi-rank path: rank 0 holds the fleet's series, no live registry
    exists for them)."""
    if isinstance(metrics, dict):
        from ..obs import dict_to_prometheus
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump(metrics, f, indent=2, sort_keys=True)
                f.write("\n")
            print(f"metrics: wrote {args.metrics_out}")
        if args.prom_out:
            with open(args.prom_out, "w") as f:
                f.write(dict_to_prometheus(metrics))
            print(f"metrics: wrote {args.prom_out}")
    else:
        if args.metrics_out:
            metrics.write_json(args.metrics_out, extra_labels)
            print(f"metrics: wrote {args.metrics_out}")
        if args.prom_out:
            metrics.write_prometheus(args.prom_out, extra_labels)
            print(f"metrics: wrote {args.prom_out}")
    if args.trace_out and trace is not None:
        trace.write(args.trace_out)
        print(f"trace: wrote {args.trace_out} ({len(trace.events)} events)")
    if args.summary_out and summary is not None:
        with open(args.summary_out, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"summary: wrote {args.summary_out}")


def _first_chip(v):
    """Layer 0's first chip of a '<name>_cim' entry (a per-layer list of
    PackedCIMLayers, ShardedPackedLayers or per-expert lists)."""
    c = v[0][0] if isinstance(v[0], list) else v[0]
    return c.shards[0] if hasattr(c, "shards") else c


def _print_chip(args, cfg, params, deploy_s, tp: int, rtag: str = ""):
    stacks = {k[:-4]: v for k, v in params["layers"].items()
              if k.endswith("_cim")}
    passes = {k: _first_chip(v).packed.n_passes for k, v in stacks.items()}
    experts = sum(1 for v in stacks.values() if isinstance(v[0], list))
    per_expert = f" ({experts} of them one chip per expert, " \
        f"{cfg.n_experts} experts)" if experts else ""
    n_shared = sum(1 for k in params.get("shared_attn", {})
                   if k.endswith("_cim"))
    shared = f" + {n_shared} shared-attn projections" if n_shared else ""
    mesh_s = "off" if cfg.cim_mesh is None else \
        "{data}x{model}".format(**cfg.cim_mesh.shape)
    print(f"{rtag}cim: compiled {len(stacks)} projection stacks{per_expert} "
          f"x {len(next(iter(stacks.values())))} layers{shared} "
          f"({args.cim_mode}, "
          f"bits={cfg.cim_in_bits}/{cfg.cim_out_bits}, "
          f"ir_drop={cfg.cim_ir_drop}, tp={tp}, mesh={mesh_s}) in "
          f"{deploy_s:.1f}s; passes per projection {passes}")


def _cli_mesh(ap, args):
    """(mesh, mesh_shape) of --cim-mesh over this process's distinct local
    devices: 'auto' the reference's factoring (`mesh.serving_mesh`), 'off'
    no mesh at its 'model' width, 'DxM' that shape (it must use every
    local device)."""
    import re
    from . import mesh as mesh_mod
    kind = torch.device(args.device).type
    if args.cim_mesh == "auto":
        return mesh_mod.serving_mesh(device_type=kind), None
    if args.cim_mesh == "off":
        return None, {"model": mesh_mod.serving_mesh_shape(
            device_type=kind)["model"]}
    m = re.fullmatch(r"(\d+)x(\d+)", args.cim_mesh)
    if not m:
        ap.error(f"--cim-mesh must be 'auto', 'off' or 'DxM' (e.g. '1x8'), "
                 f"got {args.cim_mesh!r}")
    try:
        return mesh_mod.serving_mesh(device_type=kind, shape={
            "data": int(m.group(1)), "model": int(m.group(2))}), None
    except ValueError as e:
        ap.error(f"--cim-mesh {args.cim_mesh}: {e}")


def _write_results(path: str, requests, rank: int, n_ranks: int):
    """--results-out: every served request's tokens and logits rows as
    numpy arrays (`tokens_<rid>`, `logits_<rid>`), with the rank and the
    rank count, to `path` ('{rank}' in it becomes the rank)."""
    import numpy as np
    path = path.format(rank=rank)
    arrs = {"rank": np.array(rank), "n_ranks": np.array(n_ranks),
            "rids": np.array([r.rid for r in requests], dtype=np.int64)}
    for r in requests:
        arrs[f"tokens_{r.rid}"] = np.array(r.tokens, dtype=np.int64)
        arrs[f"logits_{r.rid}"] = np.stack(r.logits)
    with open(path, "wb") as f:
        np.savez(f, **arrs)
    print(f"results: wrote {path} ({len(requests)} requests)")


def _serve_traffic(args, kw, tp: int = 1, rank: int = 0, n_ranks: int = 1):
    """--traffic: the seeded open-loop stream (this replica's share of it)
    through the slotted pool; the one-compilation contract is asserted
    per rank before anything is written or gathered. Under a process
    group, rank 0 gathers every rank's summary and rank-tagged metrics
    and writes the merged files."""
    metrics = MetricsRegistry()
    trace = TraceBuffer() if args.trace_out else None
    slots = args.slots or args.batch
    res = serve_traffic(requests=args.requests, slots=slots,
                        chunk=args.chunk, rate=args.rate,
                        prompt_len=args.prompt_len, gen=args.gen,
                        metrics=metrics, trace=trace,
                        strict_jit=args.strict_jit,
                        capture_logits=bool(args.results_out),
                        rank=rank, n_ranks=n_ranks, **kw)
    cfg, stats = res.cfg, res.stats
    dist_on = n_ranks > 1
    rtag = f"[rank {rank}/{n_ranks}] " if dist_on else ""
    if args.cim:
        _print_chip(args, cfg, res.params, res.deploy_s, tp, rtag)
    assert stats["decode_traces"] == 1, \
        f"decode recompiled across occupancy changes: {stats['decode_traces']}"
    tag = " cim=packed" if args.cim else ""
    print(f"{rtag}arch={cfg.name}{tag} traffic: {stats['requests']} reqs "
          f"slots={slots} chunk={args.chunk} rate={args.rate}/s -> "
          f"{stats['tokens']} tokens in {stats['wall_s']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s) "
          f"p50={stats['p50_ms']:.1f}ms p99={stats['p99_ms']:.1f}ms "
          f"ttft_p50={stats['ttft_p50_ms']:.1f}ms "
          f"decode_traces={stats['decode_traces']}")
    if stats["energy_pj"] > 0:
        print(f"{rtag}chip energy: {stats['energy_pj']/1e6:.2f} uJ "
              f"({stats['pj_per_token']/1e3:.1f} nJ/token, "
              f"{stats['tops_per_w']:.2f} TOPS/W, "
              f"utilization={stats['utilization']:.2f})")
    if args.results_out:
        _write_results(args.results_out, res.requests, rank, n_ranks)
    summary = dict(stats)
    summary.update({"mode": "traffic", "arch": cfg.name,
                    "cim": bool(args.cim), "slots": slots,
                    "chunk": args.chunk, "rate": args.rate})
    if not dist_on:
        _write_obs(args, metrics, trace=trace, summary=summary)
        return stats

    # the rank-0 reporting contract: gather, merge, write once
    from ..obs import merge_registries
    summary.update({"rank": rank, "ranks": n_ranks,
                    "rids": [r.rid for r in res.requests]})
    docs = dist.gather_json("serve_traffic", {
        "summary": summary,
        "metrics": metrics.to_dict(extra_labels={"rank": str(rank)})})
    if rank != 0:
        return stats
    merged = dist.merge_summaries([d["summary"] for d in docs])
    merged.update({"mode": "traffic", "arch": cfg.name,
                   "cim": bool(args.cim), "slots": slots,
                   "chunk": args.chunk, "rate": args.rate,
                   "mesh_shape": dist.global_mesh_shape(
                       device_type=torch.device(args.device).type),
                   "routing": "round_robin",
                   "rids_per_rank": [d["summary"]["rids"] for d in docs]})
    print(f"fleet[{n_ranks} replicas]: {merged['requests']} reqs -> "
          f"{merged['tokens']} tokens, aggregate "
          f"{merged['tok_per_s']:.1f} tok/s "
          f"(slowest replica wall {merged['wall_s']:.2f}s), "
          f"p99={merged['p99_ms']:.1f}ms, "
          f"decode_traces(max)={merged['decode_traces']}")
    _write_obs(args, merge_registries([d["metrics"] for d in docs]),
               trace=trace, summary=merged)
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--layers", type=int, default=0,
                    help="serve only the first N layers (0 = all)")
    ap.add_argument("--cim", action="store_true",
                    help="serve dense-block projections through the packed "
                         "CIM engine (programs the chip before serving)")
    ap.add_argument("--cim-mode", default="ideal",
                    choices=["ideal", "relaxed", "writeverify"],
                    help="conductance programming fidelity for --cim")
    ap.add_argument("--cim-bits", type=int, default=0,
                    help="bit-serial input precision for --cim (1..8; 0 = "
                         "the arch default)")
    ap.add_argument("--cim-cores", type=int, default=0,
                    help="cores per chip for --cim (0 = NeuRRAM's 48); "
                         "fewer cores than tiles force merged-core "
                         "scheduled plans")
    ap.add_argument("--cim-ir-drop", type=float, default=0.0,
                    help="ir_drop_alpha for --cim: > 0 plans IR-drop-bounded "
                         "vertical column splits")
    ap.add_argument("--cim-mesh", default="auto",
                    help="mesh placement for --cim: 'auto' factors the "
                         "local devices into (data, model) as the reference "
                         "does and places each shard's chips on its own "
                         "device, one copy per data row; 'off' keeps every "
                         "chip on the serving device; 'DxM' (e.g. '2x4') "
                         "asks for that (data, model) shape")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--traffic", action="store_true",
                    help="continuous-batching mode: serve an open-loop "
                         "Poisson request stream through the slotted pool "
                         "(launch/scheduler) instead of one static batch")
    ap.add_argument("--requests", type=int, default=16,
                    help="--traffic: number of requests in the stream")
    ap.add_argument("--slots", type=int, default=0,
                    help="--traffic: pool slots (0 = --batch)")
    ap.add_argument("--chunk", type=int, default=32,
                    help="--traffic: prefill chunk size (and prompt page)")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="--traffic: Poisson arrival rate (req/s)")
    ap.add_argument("--results-out", default="",
                    help="--traffic: write each served request's tokens and "
                         "logits (.npz; '{rank}' in the path becomes the "
                         "rank)")
    _add_obs_flags(ap)
    args = ap.parse_args(argv)

    # join the process group (if any) before the first device query
    dist_on = dist.initialize()
    rank, n_ranks = dist.process_info()
    rtag = f"[rank {rank}/{n_ranks}] " if dist_on else ""
    mesh, mesh_shape = _cli_mesh(ap, args) if args.cim else (None, None)
    tp = (mesh.shape["model"] if mesh is not None
          else (mesh_shape or {}).get("model", 1))
    kw = dict(smoke=args.smoke, cim=args.cim, cim_mode=args.cim_mode,
              cim_bits=args.cim_bits, cim_cores=args.cim_cores,
              cim_ir_drop=args.cim_ir_drop, device=args.device,
              n_layers=args.layers or None, mesh_shape=mesh_shape,
              mesh=mesh)
    if args.traffic:
        return _serve_traffic(args, dict(kw, arch=args.arch), tp, rank,
                              n_ranks)
    res = serve_static(args.arch, batch=args.batch,
                       prompt_len=args.prompt_len, gen=args.gen, **kw)
    cfg, g = res.cfg, res.out
    if args.cim:
        _print_chip(args, cfg, res.params, res.deploy_s, tp, rtag)
    t_decode = sum(g.decode_s) / len(g.decode_s) if g.decode_s else 0.0
    thr = (args.batch / t_decode) if t_decode else float("nan")
    dev = torch.device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    tag = " cim=packed" if args.cim else ""
    if dist_on:
        tag += f" rank={rank}/{n_ranks}"
    print(f"arch={cfg.name}{tag} device={where} batch={args.batch} "
          f"prefill={g.prefill_s * 1e3:.1f}ms "
          f"decode={t_decode * 1e3:.1f}ms/tok throughput={thr:.1f} tok/s")
    print("sample token ids:", g.tokens[0, :16].tolist())
    # the reference's metering of the static path: prefill pushes batch x
    # prompt rows through every chip, each decode step batch rows
    metrics = MetricsRegistry()
    meter = ChipMeter.from_params(res.params, cfg.cim_in_bits,
                                  cfg.cim_out_bits)
    metrics.histogram("static_prefill_s",
                      "static batch prefill seconds").observe(g.prefill_s)
    meter.count_rows(args.batch * args.prompt_len)
    h_dec = metrics.histogram("static_decode_step_s",
                              "static decode step seconds")
    for dt in g.decode_s:
        meter.count_rows(args.batch)
        h_dec.observe(dt)
    meter.export(metrics)
    n_tok = args.batch * args.gen
    energy_pj = meter.energy_pj()
    summary = {
        "mode": "static", "arch": cfg.name, "cim": bool(args.cim),
        "batch": args.batch, "prompt_len": args.prompt_len,
        "gen": args.gen, "tokens": n_tok,
        "prefill_ms": g.prefill_s * 1e3,
        "decode_ms_per_tok": t_decode * 1e3,
        "tok_per_s": (args.batch / t_decode) if t_decode else 0.0,
        "mvm_dispatches": meter.mvm_dispatches(),
        "energy_pj": energy_pj,
        "pj_per_token": energy_pj / n_tok if n_tok else 0.0,
        "sample_tokens": g.tokens[0, :16].tolist(),
    }
    if dist_on:
        # static mode replicates the same batch on every rank (a group
        # smoke, not a routed workload); rank 0 owns the output files
        summary.update({"rank": rank, "ranks": n_ranks})
        if rank == 0:
            _write_obs(args, metrics, summary=summary,
                       extra_labels={"rank": str(rank)})
    else:
        _write_obs(args, metrics, summary=summary)
    return g.tokens


if __name__ == "__main__":
    main()
