"""internvl2-1b [vlm]: 24L d896 14H (GQA kv=2) d_ff 4864 vocab 151655 —
InternViT frontend (STUB: precomputed patch embeddings) + Qwen2-0.5B-style LM
backbone with QKV bias [arXiv:2404.16821]."""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896, n_heads=14,
    n_kv_heads=2, d_ff=4864, vocab=151655, qkv_bias=True, vis_patches=256)

SMOKE = CONFIG.replace(n_layers=2, d_model=112, n_heads=7, n_kv_heads=1,
                       d_ff=224, vocab=512, vis_patches=16)
