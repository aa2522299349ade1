"""rwkv6-7b [ssm]: Finch — 32L d4096 (attn-free, data-dependent decay)
d_ff 14336 vocab 65536 [arXiv:2404.05892]. O(1) decode state."""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="rwkv", rwkv=True, n_layers=32, d_model=4096,
    n_heads=64, n_kv_heads=64, d_ff=14336, vocab=65536)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
                       d_ff=256, vocab=512)
