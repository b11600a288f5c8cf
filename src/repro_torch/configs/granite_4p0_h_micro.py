"""Granite-4.0-H-Micro (ibm-granite/granite-4.0-h-micro, ``config.json``,
``model_type`` granitemoehybrid with no experts) — a Mamba2 + attention
hybrid: 40 layers, attention at layers 5, 15, 25 and 35 (0-based), Mamba2
at the other 36; every layer a mixer and then its own SwiGLU MLP
(``shared_intermediate_size`` 8192), each branch scaled by the residual
multiplier 0.22.  Mamba2: d 2048, 64 heads x P 64, N 128, one B/C group,
conv 4 with bias, no projection bias.  Attention: GQA 32 / 8 at hd 64,
NoPE, softmax scale ``attention_multiplier`` 1/64.  Embedding x 12, logits
/ 8, tied; RMSNorm eps 1e-5; vocabulary 100352.

This config has no twin in the JAX package (``configs.PORT_ONLY_IDS``):
the JAX package's ``ModelConfig`` has no per-layer pattern, NoPE or muP
multipliers, and it is not edited.  The port's ``ModelConfig`` carries
them as fields of its own (``models.config.PORT_ONLY``).

Departures from the published model, each forced by the program:

* ``mamba_chunk_size`` 256 -> 64: ``ssd_scan`` takes chunks of 16, 32 or
  64 (the result does not depend on the chunk but for rounding);
* RMSNorm scales by ``1 + w`` where the source scales by ``w``: the same
  function of the weights, parameterised from zero.

No part of the mathematics is left out, and no size is cut.
"""
from ..models.config import ModelConfig

LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                    for i in range(40))

CONFIG = ModelConfig(
    name="granite-4.0-h-micro", arch_type="hybrid",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=100352, rope_theta=10000.0,
    ssm_state=128, ssm_heads=64, ssm_head_dim=64, ssm_expand=2,
    ssm_conv=4, ssm_chunk=64,
    layer_types=LAYER_TYPES, nope=True, attention_multiplier=0.015625,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    logits_scaling=8.0, norm_eps=1e-5,
    mlp="swiglu", tie_embeddings=True,
)

# every kind of layer (Mamba runs of one and of two layers, attention
# groups of one), GQA at G 2, the published multipliers and hd 64
REDUCED = CONFIG.with_(
    n_layers=6, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=1024, ssm_state=32, ssm_heads=16, ssm_head_dim=32,
    ssm_chunk=16,
    layer_types=("mamba", "attention", "mamba", "mamba", "attention",
                 "mamba"),
)
