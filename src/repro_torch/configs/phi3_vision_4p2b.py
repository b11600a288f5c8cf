"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct] — phi3-mini
backbone + CLIP ViT frontend.  The vision encoder/projector is a STUB:
``input_specs`` supplies 576 precomputed patch embeddings."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", arch_type="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    frontend="vision", n_frontend_tokens=576,
    mlp="swiglu", tie_embeddings=False,
)

REDUCED = CONFIG.with_(
    n_layers=2, d_model=384, n_heads=4, n_kv_heads=4, head_dim=96,
    d_ff=1024, vocab_size=1024, n_frontend_tokens=16,
)
