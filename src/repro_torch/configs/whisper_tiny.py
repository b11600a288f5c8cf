"""Whisper-tiny [arXiv:2212.04356] — enc-dec; conv/mel frontend is a STUB
(``input_specs`` supplies 1500 precomputed frame embeddings)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", arch_type="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    n_enc_layers=4, n_enc_tokens=1500,
    frontend="audio", n_frontend_tokens=1500,
    mlp="gelu", tie_embeddings=True,
)

REDUCED = CONFIG.with_(
    n_layers=2, n_enc_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
    head_dim=64, d_ff=512, vocab_size=512, n_enc_tokens=64,
    n_frontend_tokens=64,
)
