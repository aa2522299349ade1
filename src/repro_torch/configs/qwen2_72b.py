"""qwen2-72b [dense]: 80L d8192 64H (GQA kv=8) d_ff 29568 vocab 152064,
GQA + QKV bias [arXiv:2407.10671; hf]."""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b", family="dense", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=29568, vocab=152064, qkv_bias=True, rope_theta=1e6)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                       d_ff=256, vocab=512)
