"""Model configuration: one dataclass drives every architecture family.

Port of ``src/repro/models/config.py``.  Every field is kept except
``kernels``: in this package the device of the tensors picks the
implementation of a hot spot (a CPU tensor runs the plain PyTorch version, a
CUDA tensor the hand-written kernel), so there is nothing to select.

A model is a stack of *layer groups*.  Each group is homogeneous (same kind,
same shapes), and its parameters are stacked on a leading layer axis when it
has more than one layer, exactly as in the JAX package, so parameter trees
cross between the two packages without restacking.

Fields the JAX package's config lacks (``PORT_ONLY``), for the configs that
have no JAX twin (``configs.PORT_ONLY_IDS``): a published per-layer pattern
(``layer_types``, a Mamba2 + attention hybrid whose every layer carries its
own weights and MLP), NoPE attention and the muP multipliers.  At their
defaults they add no operation, so every config with a JAX twin runs as it
did.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
# the fields of ModelConfig and LayerGroup that the JAX package's lack
PORT_ONLY = ("layer_types", "nope", "attention_multiplier",
             "embedding_multiplier", "residual_multiplier", "logits_scaling")
PORT_ONLY_GROUP = ("mlp",)


@dataclass(frozen=True)
class LayerGroup:
    """A run of identical layers executed as one loop over stacked params."""

    kind: str                   # "attn" | "mamba" | "shared_attn"
    count: int
    window: int = 0             # 0 = full causal attention; >0 = sliding window
    cross_attn: bool = False    # decoder layers attending to encoder output
    moe: bool = False           # FFN is a mixture of experts
    mlp: bool = False           # mamba: the layer has a norm + MLP after
                                # its mixer (granite-4.0-h); attn always has


def _pattern_groups(layer_types: Tuple[str, ...]) -> Tuple[LayerGroup, ...]:
    """One group per run of a kind in a published pattern: a run of Mamba
    layers is one group (each layer its own weights and MLP), and each
    attention layer a group of one, with its own weights."""
    gs = []
    for kind in layer_types:
        if kind == "mamba":
            if gs and gs[-1].kind == "mamba":
                gs[-1] = replace(gs[-1], count=gs[-1].count + 1)
            else:
                gs.append(LayerGroup("mamba", 1, mlp=True))
        elif kind == "attention":
            gs.append(LayerGroup("attn", 1))
        else:
            raise ValueError(f"unknown layer type {kind!r}")
    return tuple(gs)


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

    # -- hybrid with a published per-layer pattern (granite-4.0-h) -----------
    # "mamba" | "attention" per layer; each run of one kind is a group, every
    # layer with its own weights and a SwiGLU MLP after its mixer
    layer_types: Tuple[str, ...] = ()

    # -- attention and muP scalars (0 / 1 / False: the default path) ---------
    nope: bool = False              # no rotary embedding (NoPE)
    attention_multiplier: float = 0.0   # softmax scale; 0 -> 1/sqrt(hd)
    embedding_multiplier: float = 0.0   # embedding scale; 0 -> sqrt(d)
    residual_multiplier: float = 1.0    # each mixer / MLP branch's scale
    logits_scaling: float = 1.0         # logits divided by it

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
    # scan_unroll is kept for field parity with the JAX config and ignored
    # (the layers run in an eager Python loop); remat is honoured: layer-
    # boundary torch.utils.checkpoint when a gradient is carried
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

    @property
    def layer_type_list(self) -> list:
        """``layer_types`` as a list, as a published ``config.json`` has
        it."""
        return list(self.layer_types)

    @property
    def position_embedding_type(self) -> str:
        """As a published ``config.json`` names it: ``nope`` or ``rope``."""
        return "nope" if self.nope else "rope"

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
        if self.layer_types:
            return _pattern_groups(self.layer_types)
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

    def pad_heads(self, multiple: int = 16) -> "ModelConfig":
        """Round head counts up to a multiple so they shard evenly on the
        ``model`` mesh axis (beyond-paper perf variant).

        Padding is *exact*: padded heads have zero wk/wv/wo weights, so their
        keys/values/outputs are identically zero and contribute nothing —
        semantics are preserved while the KV cache becomes head-shardable
        (avoiding GSPMD's head-dim sharding + RoPE-split full
        rematerialization).  Costs (multiple/heads)x extra attention FLOPs.
        """
        if not self.n_heads:
            return self
        def up(x: int) -> int:
            return -(-x // multiple) * multiple
        return self.with_(n_heads=up(self.n_heads),
                          n_kv_heads=up(self.n_kv_heads))

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
                    if g.mlp:
                        total += 3 * d * self.d_ff + d   # swiglu, norm
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
