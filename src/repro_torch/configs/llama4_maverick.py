"""llama4-maverick-400b-a17b [moe]: 48L d5120 40H (GQA kv=8) d_ff 8192
vocab 202048, 128 routed experts top-1 + shared expert, MoE on every 2nd
layer (1:1 interleave), early fusion [hf:meta-llama; unverified]. One
layer's routed experts alone are 128 x 3 x 5120 x 8192 weights: it does
not fit one card at any depth, so the port runs it at smoke size only."""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
    n_experts=128, top_k=1, n_shared_experts=1, d_expert=8192, moe_every=2)

SMOKE = CONFIG.replace(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=512, n_experts=8, top_k=1,
                       n_shared_experts=1, d_expert=128)
