"""Serve a (reduced) assigned-architecture LM with the NeuRRAM technique
on: every linear layer routed through the CIM chip-sim path (quantized
bit-serial MVM surrogate + conductance noise). Port of
`examples/lm_cim_serving.py`.

  PYTHONPATH=src python -m repro_torch.examples.lm_cim_serving --arch gemma2-9b [--device cpu]
"""
import argparse

import torch

import repro_torch.configs as configs
import repro_torch.models.transformer as T
from repro_torch.data import lm_tokens
from repro_torch.device import resolve_device
from repro_torch.obs.clock import now


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get(args.arch, smoke=True).replace(dtype=torch.float32)
    params = T.init_params(cfg, seed=0, device=dev)
    prompts = lm_tokens(torch.Generator(dev).manual_seed(1), 2, 12,
                        cfg.vocab)

    with torch.no_grad():
        for mode in ("off", "chipsim"):
            c = cfg.replace(cim_mode=mode)
            cache = T.init_cache(c, 2, 12 + args.gen, device=dev)
            t0 = now()
            logits, cache = T.prefill(params, prompts, cache, c)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out = [tok]
            for _ in range(args.gen - 1):
                logits, cache = T.decode_step(params, cache, tok, c)
                tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
                out.append(tok)
            ids = torch.cat(out, 1)
            print(f"cim_mode={mode:8s} {now()-t0:5.1f}s  "
                  f"tokens: {ids[0, :10].tolist()}")
    print("(chipsim: every matmul quantized to 4-bit-in/8-bit-out with 10% "
          "conductance noise — the paper's datapath as an LM serving "
          "feature)")


if __name__ == "__main__":
    main()
