"""deepseek-moe-16b [moe]: 28L d2048 16H (kv=16) vocab 102400 — fine-grained
MoE: 64 routed experts (d_expert 1408) top-6 + 2 shared experts
[arXiv:2401.06066]. NeuRRAM mapping: routed experts = power-gated CIM cores."""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                       d_ff=64, vocab=512, n_experts=8, top_k=2,
                       n_shared_experts=1, d_expert=64)
