"""Mamba2-370M [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", arch_type="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=64,
    tie_embeddings=True,
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=256, vocab_size=1024, ssm_state=32,
    ssm_head_dim=32, ssm_chunk=16,
)
