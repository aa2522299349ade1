"""gemma2-9b [dense]: 42L d3584 16H (GQA kv=8, head_dim 256) d_ff 14336
vocab 256000 — alternating local(4096)/global attention, attn softcap 50,
final softcap 30, tied embeddings [arXiv:2408.00118]."""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b", n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_head=256, d_ff=14336, vocab=256000, attn_softcap=50.0,
    final_softcap=30.0, local_window=4096, alt_local_global=True,
    tie_embeddings=True, rope_theta=1e4)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                       d_head=32, d_ff=256, vocab=512, local_window=8)
