"""Model configuration: one dataclass drives every architecture family.

Port of ``src/repro/models/config.py``.  Every field is kept except
``kernels``: in this package the device of the tensors picks the
implementation of a hot spot (a CPU tensor runs the plain PyTorch version, a
CUDA tensor the hand-written kernel), so there is nothing to select.

A model is a stack of *layer groups*.  Each group is homogeneous (same kind,
same shapes), and its parameters are stacked on a leading layer axis when it
has more than one layer, exactly as in the JAX package, so parameter trees
cross between the two packages without restacking.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclass(frozen=True)
class LayerGroup:
    """A run of identical layers executed as one loop over stacked params."""

    kind: str                   # "attn" | "mamba" | "shared_attn"
    count: int
    window: int = 0             # 0 = full causal attention; >0 = sliding window
    cross_attn: bool = False    # decoder layers attending to encoder output
    moe: bool = False           # FFN is a mixture of experts


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str              # dense|moe|ssm|hybrid|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # -- attention ---------------------------------------------------------
    rope_theta: float = 10_000.0
    sliding_window: int = 0     # uniform SWA width (mixtral-style); 0 = full
    local_window: int = 0       # local:global pattern (gemma3-style)
    local_ratio: int = 0        # local layers per global layer (5 for gemma3)

    # -- MoE -----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # -- SSM (mamba2 / zamba2) ----------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0          # 0 -> d_model // ssm_head_dim
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2

    # -- hybrid (zamba2): one shared attention block every k mamba layers ----
    shared_attn_every: int = 0

    # -- encoder-decoder (whisper) -------------------------------------------
    n_enc_layers: int = 0
    n_enc_tokens: int = 0       # encoder sequence length (1500 audio frames)

    # -- modality frontend stubs (vlm / audio) --------------------------------
    frontend: str = ""          # "" | "vision" | "audio"
    n_frontend_tokens: int = 0  # patch/frame embeddings prepended to the seq

    # -- misc ------------------------------------------------------------------
    mlp: str = "swiglu"         # "swiglu" | "gelu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # training schedule tag (minicpm's WSD)
    lr_schedule: str = "cosine"

    # roofline probes: explicit layer-group override
    override_groups: Optional[Tuple[LayerGroup, ...]] = None
    # kept for field parity with the JAX config (scan unrolling / remat are
    # XLA concerns; the eager PyTorch loop ignores them)
    scan_unroll: bool = False
    remat: bool = True

    # ------------------------------------------------------------------ derived
    @property
    def vocab_padded(self) -> int:
        """Embedding/unembedding allocation size: vocab rounded up to a
        multiple of 256 (logit columns beyond vocab_size are never valid
        targets)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return (self.d_model * self.ssm_expand) // self.ssm_head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    # -- layer-group derivation ------------------------------------------------
    def groups(self) -> Tuple[LayerGroup, ...]:
        """Decoder layer groups in execution order."""
        if self.override_groups is not None:
            return self.override_groups
        moe = self.n_experts > 0
        if self.arch_type == "ssm":
            return (LayerGroup("mamba", self.n_layers),)
        if self.arch_type == "hybrid":
            # zamba2: mamba backbone, shared attention block every k layers
            k = self.shared_attn_every or 6
            gs = []
            remaining = self.n_layers
            while remaining > 0:
                c = min(k, remaining)
                gs.append(LayerGroup("mamba", c))
                remaining -= c
                if remaining >= 0 and c == k:
                    gs.append(LayerGroup("shared_attn", 1))
            return tuple(gs)
        if self.local_ratio > 0:
            # gemma3: r local layers per global layer (grouped)
            n_global = max(1, self.n_layers // (self.local_ratio + 1))
            n_local = self.n_layers - n_global
            return (LayerGroup("attn", n_local, window=self.local_window,
                               moe=moe),
                    LayerGroup("attn", n_global, moe=moe))
        w = self.sliding_window
        cross = self.arch_type == "encdec"
        return (LayerGroup("attn", self.n_layers, window=w, moe=moe,
                           cross_attn=cross),)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # -- sizes ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count."""
        d, v = self.d_model, self.vocab_size
        total = v * d                      # embedding
        if not self.tie_embeddings:
            total += v * d
        for g in self.groups():
            for _ in range(g.count):
                if g.kind in ("attn", "shared_attn"):
                    qkv = d * (self.n_heads * self.hd) \
                        + 2 * d * (self.n_kv_heads * self.hd) \
                        + (self.n_heads * self.hd) * d
                    total += qkv
                    if g.cross_attn:
                        total += qkv
                    ff_in = 2 * d * self.d_ff if self.mlp == "swiglu" \
                        else d * self.d_ff
                    ff = ff_in + self.d_ff * d
                    if g.moe:
                        total += self.n_experts * ff + d * self.n_experts
                    else:
                        total += ff
                    total += 2 * d        # norms
                elif g.kind == "mamba":
                    di, ns, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
                    total += d * (2 * di + 2 * ns + nh)   # in_proj
                    total += self.ssm_conv * (di + 2 * ns)  # conv
                    total += di * d                      # out_proj
                    total += 3 * nh                      # A, dt_bias, D
                    total += d                           # norm
        # encoder stack
        if self.n_enc_layers:
            qkv = 4 * d * (self.n_heads * self.hd)
            ff = 2 * d * self.d_ff
            total += self.n_enc_layers * (qkv + ff + 2 * d)
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        ff_in = 2 * d * self.d_ff if self.mlp == "swiglu" else d * self.d_ff
        ff = ff_in + self.d_ff * d
        dead_experts = self.n_experts - self.experts_per_token
        n_moe_layers = sum(g.count for g in self.groups() if g.moe)
        return self.param_count() - n_moe_layers * dead_experts * ff
