"""Mixtral 8x22B [arXiv:2401.04088] — 8 experts top-2 MoE, GQA kv=8,
sliding-window attention (per assignment card)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", arch_type="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    n_experts=8, experts_per_token=2, sliding_window=4096,
    mlp="swiglu", tie_embeddings=False,
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=1024, n_experts=4, experts_per_token=2,
    sliding_window=64,
)
