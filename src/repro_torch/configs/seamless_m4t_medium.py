"""seamless-m4t-medium [audio]: enc-dec, 12+12L d1024 16H (kv=16) d_ff 4096
vocab 256206, multimodal [arXiv:2308.11596]. The modality frontend is a STUB:
the caller passes precomputed frame embeddings (B, S_src, d)."""
from ..models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=12, enc_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206)

SMOKE = CONFIG.replace(n_layers=2, enc_layers=2, d_model=128, n_heads=4,
                       n_kv_heads=4, d_ff=256, vocab=512)
