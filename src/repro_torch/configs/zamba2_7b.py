"""zamba2-7b [hybrid]: 81L d3584 d_ff 14336 vocab 32000, ssm_state 64 —
Mamba2 blocks + ONE shared attention block (32H, weight-shared) invoked every
6 layers [arXiv:2411.15242; unverified]. O(1)-ish decode state."""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584, n_heads=32,
    n_kv_heads=32, d_head=112, d_ff=14336, vocab=32000,
    ssm_state=64, ssm_head=64, hybrid_attn_every=6)

SMOKE = CONFIG.replace(n_layers=6, d_model=128, n_heads=4, n_kv_heads=4,
                       d_head=32, d_ff=256, vocab=512, ssm_state=16,
                       ssm_head=32, hybrid_attn_every=3)
