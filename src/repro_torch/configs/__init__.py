"""Architecture registry, the assigned input shapes and their input specs
(port of `repro/configs`): the reference's ten archs under its names, its
four shapes and its 40 (arch x shape) dry-run cells; long_500k runs only
for the sub-quadratic-state families (rwkv6, zamba2).

`input_specs` and `cache_specs` give tensors on the `meta` device, the
port's stand-ins for the reference's ShapeDtypeStructs: a shape and a
dtype, nothing allocated (`launch/dryrun.py` runs the steps on them)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from . import (codeqwen15_7b, deepseek_moe_16b, gemma2_9b, granite_20b,
               internvl2_1b, llama4_maverick, qwen2_72b, rwkv6_7b,
               seamless_m4t_medium, zamba2_7b)
from ..models.transformer import ArchConfig

_MODULES = {
    "qwen2-72b": qwen2_72b,
    "codeqwen1.5-7b": codeqwen15_7b,
    "granite-20b": granite_20b,
    "gemma2-9b": gemma2_9b,
    "rwkv6-7b": rwkv6_7b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "seamless-m4t-medium": seamless_m4t_medium,
    "internvl2-1b": internvl2_1b,
    "zamba2-7b": zamba2_7b,
}

ARCH_NAMES = list(_MODULES)

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k requires sub-quadratic decode state
LONG_CONTEXT_OK = {"rwkv6-7b", "zamba2-7b"}


def get(name: str, smoke: bool = False) -> ArchConfig:
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells. Skipped cells carry a reason."""
    out = []
    for a in ARCH_NAMES:
        for s in SHAPES.values():
            skip = None
            if s.name == "long_500k" and a not in LONG_CONTEXT_OK:
                skip = "full-attention arch at 524k decode (quadratic-class)"
            if include_skipped or skip is None:
                out.append((a, s.name, skip))
    return out


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, dtype=torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    b = shape.global_batch
    if shape.kind in ("train", "prefill"):
        n_tok = shape.seq_len + (1 if shape.kind == "train" else 0)
        batch = {"tokens": _spec((b, n_tok), torch.int32)}
        if cfg.vis_patches > 0:
            batch["vis_embeds"] = _spec((b, cfg.vis_patches, cfg.d_model),
                                        dtype)
        if cfg.enc_layers > 0:
            batch["src_embeds"] = _spec((b, shape.seq_len, cfg.d_model),
                                        dtype)
        return batch
    # decode: one new token against a seq_len-deep cache
    batch = {"tokens": _spec((b, 1), torch.int32)}
    if cfg.enc_layers > 0:
        batch["memory"] = _spec((b, 4096, cfg.d_model), dtype)
    return batch


def cache_specs(cfg: ArchConfig, shape: ShapeSpec, dtype=torch.bfloat16):
    """The decode cache on the meta device (`models.transformer.init_cache`
    built there: shapes and dtypes, nothing allocated)."""
    from ..models import transformer as T
    return T.init_cache(cfg, shape.global_batch, shape.seq_len, dtype=dtype,
                        device=META)
