"""Minitron-8B [arXiv:2407.14679] — width-pruned Nemotron-4, GQA kv=8."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab_size=256000, head_dim=128,
    mlp="swiglu", tie_embeddings=False,
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=512, n_heads=4, n_kv_heads=2, head_dim=128,
    d_ff=1024, vocab_size=2048,
)
