"""codeqwen1.5-7b [dense]: 32L d4096 32H (GQA kv=32 = MHA) d_ff 13440
vocab 92416, qwen1.5 arch (QKV bias) [hf:Qwen/CodeQwen1.5-7B]."""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=13440, vocab=92416, qkv_bias=True,
    rope_theta=1e6)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=8,
                       d_ff=256, vocab=512)
