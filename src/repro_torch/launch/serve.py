"""Serving driver of the port: static-batch greedy decode, optionally with
every dense-block projection served by its compiled NeuRRAM chip (port of
the static path of `repro/launch/serve.py`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
      --cim --cim-cores 6144 --layers 4 --batch 4 --prompt-len 64 --gen 32

One fixed request batch is prefilled once, then decoded token by token in
lockstep (greedy), the KV cache updated in place. With --cim each layer's
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

Runs on the card unless `--device cpu` is given; without CUDA it raises.
Times are CUDA-event times on the card. The continuous-batching mode
(--traffic), mesh flags and observability outputs are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import torch

from .. import configs
from ..data import lm_tokens
from ..device import resolve_device
from ..kernels.cim_mvm import kernel as cim_kernel
from ..obs.clock import stopwatch, timed_call
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
                  teacher: Optional[torch.Tensor] = None) -> Generation:
    """Prefill `prompts` (B, S) and decode gen - 1 more tokens greedily.
    teacher: optional (B, >= gen - 1) tokens fed instead of the greedy
    ones (a second run that must follow the first run's path)."""
    b, s = prompts.shape
    cache = arch_serving(cfg, device).init_state(b, s + gen)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    (logits, cache), t_prefill = timed_call(
        prefill, params, cache, {"tokens": prompts}, device=device)
    out, all_logits, step_s = [], [logits], []
    tok = torch.argmax(logits, -1)[:, None]
    out.append(tok)
    for i in range(gen - 1):
        feed = tok if teacher is None else teacher[:, i:i + 1]
        (logits, cache), dt = timed_call(decode, params, cache,
                                         {"tokens": feed}, device=device)
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


def serve_static(arch: str = "gemma2-9b", *, smoke: bool = False,
                 batch: int = 4, prompt_len: int = 64, gen: int = 32,
                 cim: bool = False, cim_mode: str = "ideal",
                 cim_bits: int = 0, cim_cores: int = 0,
                 cim_ir_drop: float = 0.0, device: Optional[str] = None,
                 n_layers: Optional[int] = None,
                 params=None, prompts=None, x_cal=None) -> ServeResult:
    """Build (or take) params, deploy the chip under `cim`, serve one
    static batch. The params, prompts and calibration batches are drawn
    from generators seeded 0, 1 and 7; params / prompts / x_cal, when
    given, replace those draws (params must already be on `device`)."""
    dev = resolve_device(device)
    cfg = serving_config(arch, smoke=smoke, cim=cim, cim_bits=cim_bits,
                         cim_ir_drop=cim_ir_drop, n_layers=n_layers)
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
                                   x_cal=x_cal)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        deploy_s = sw.s
    if prompts is None:
        prompts = lm_tokens(torch.Generator(dev).manual_seed(1), batch,
                            prompt_len, cfg.vocab)
    prompts = prompts.to(dev)
    out = greedy_decode(params, cfg, prompts, gen, dev)
    return ServeResult(cfg, params, prompts, out, deploy_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
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
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    res = serve_static(args.arch, smoke=args.smoke, batch=args.batch,
                       prompt_len=args.prompt_len, gen=args.gen,
                       cim=args.cim, cim_mode=args.cim_mode,
                       cim_bits=args.cim_bits, cim_cores=args.cim_cores,
                       cim_ir_drop=args.cim_ir_drop, device=args.device,
                       n_layers=args.layers or None)
    cfg, g = res.cfg, res.out
    if args.cim:
        n_packed = sum(1 for k in res.params["layers"] if k.endswith("_cim"))
        passes = {k[:-4]: v[0].packed.n_passes
                  for k, v in res.params["layers"].items()
                  if k.endswith("_cim")}
        print(f"cim: compiled {n_packed} projection stacks x "
              f"{cfg.n_layers} layers ({args.cim_mode}, "
              f"bits={cfg.cim_in_bits}/{cfg.cim_out_bits}, "
              f"ir_drop={cfg.cim_ir_drop}, tp=1) in {res.deploy_s:.1f}s; "
              f"passes per projection {passes}")
    t_decode = sum(g.decode_s) / len(g.decode_s) if g.decode_s else 0.0
    thr = (args.batch / t_decode) if t_decode else float("nan")
    dev = torch.device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    tag = " cim=packed" if args.cim else ""
    print(f"arch={cfg.name}{tag} device={where} batch={args.batch} "
          f"prefill={g.prefill_s * 1e3:.1f}ms "
          f"decode={t_decode * 1e3:.1f}ms/tok throughput={thr:.1f} tok/s")
    print("sample token ids:", g.tokens[0, :16].tolist())
    return g.tokens


if __name__ == "__main__":
    main()
