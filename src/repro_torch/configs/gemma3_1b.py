"""Gemma-3 1B [hf:google/gemma-3-1b-pt] — 5:1 local:global attention,
sliding window 512, kv=1, 262k vocab, 128k context."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", arch_type="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab_size=262144, head_dim=256,
    local_ratio=5, local_window=512, rope_theta=1_000_000.0,
    mlp="swiglu", tie_embeddings=True,
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=256, n_heads=2, n_kv_heads=1, head_dim=128,
    d_ff=512, vocab_size=2048, local_ratio=1, local_window=64,
)
