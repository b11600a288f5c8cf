"""Zamba2-1.2B [arXiv:2411.15242] — Mamba2 backbone + one shared attention
block applied every 6 layers (hybrid)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", arch_type="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=64,
    shared_attn_every=6,
    mlp="swiglu", tie_embeddings=True,
)

REDUCED = CONFIG.with_(
    n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=1024, ssm_state=16, ssm_head_dim=32,
    shared_attn_every=2, ssm_chunk=16,
)
