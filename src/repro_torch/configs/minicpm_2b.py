"""MiniCPM-2B [arXiv:2404.06395] — dense llama-like, WSD LR schedule."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", arch_type="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab_size=122753, head_dim=64,
    mlp="swiglu", tie_embeddings=True, lr_schedule="wsd",
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=288, n_heads=4, n_kv_heads=4, head_dim=72,
    d_ff=768, vocab_size=1024,
)
