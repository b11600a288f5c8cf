"""Llama-4 Scout 17B-active/16E [hf:meta-llama/Llama-4-Scout-17B-16E] —
MoE 16 experts top-1, GQA kv=8, early-fusion multimodal (text path here)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", arch_type="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    n_experts=16, experts_per_token=1,
    mlp="swiglu", tie_embeddings=False,
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=1024, n_experts=4, experts_per_token=1,
)
