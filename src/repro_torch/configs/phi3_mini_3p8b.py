"""Phi-3-mini 3.8B [arXiv:2404.14219] — dense, RoPE + SwiGLU + GQA(32)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", arch_type="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    mlp="swiglu", tie_embeddings=False,
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=384, n_heads=4, n_kv_heads=4, head_dim=96,
    d_ff=1024, vocab_size=1024,
)
