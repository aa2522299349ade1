"""granite-20b [dense]: 52L d6144 48H (MQA kv=1) d_ff 24576 vocab 49152,
code model [arXiv:2405.04324]. Expressed on the unified llama-style backbone
(MQA = n_kv_heads 1); the original is GPT-BigCode-style, as in the reference."""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense", n_layers=52, d_model=6144, n_heads=48,
    n_kv_heads=1, d_ff=24576, vocab=49152)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=1,
                       d_ff=256, vocab=512)
