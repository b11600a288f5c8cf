"""Neural building blocks, plain functions on tensors over parameter dicts.

Port of ``src/repro/models/layers.py:26-140`` (norms, MLPs, rotary
embeddings, attention).  Attention hot spots go through ``kernels.ops``,
whose implementation the tensors' device picks.  Mixture of experts and
Mamba2 are not ported yet (ROADMAP, Queue 1).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops

Params = Dict[str, torch.Tensor]
f32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in float32, scaled by ``1 + w`` (zero-initialised weights)."""
    dt = x.dtype
    x = x.to(f32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.to(f32))).to(dt)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ w_gate)
    return (g * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    # tanh approximation: jax.nn.gelu's default
    return F.gelu(x @ w_up, approximate="tanh") @ w_down


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=f32, device=device)
                            / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S).  Split-halves convention,
    computed in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    ang = positions[..., None].to(f32) * freqs             # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(f32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B,Sq,Hq,hd)  k,v: (B,Sk,Hkv,hd)  mask: broadcastable to
    (B,Hkv,G,Sq,Sk).  Returns (B,Sq,Hq,hd)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(f32),
                          k.to(f32)) / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(f32))
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def attention_block(x: torch.Tensor, p: Params, *, n_heads: int,
                    n_kv_heads: int, hd: int, positions: torch.Tensor,
                    rope_theta: float, causal: bool = True, window: int = 0,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention sublayer body (no residual / norm).  Returns
    (out, k, v) so callers can stash K/V into a cache.  The attention itself
    is ``kernels.ops.attention`` with the structural causal/window
    description, as the JAX package's kernel path passes it."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, n_kv_heads, hd)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    out = kernel_ops.attention(q, k, v, causal=causal, window=window)
    out = out.reshape(B, S, n_heads * hd) @ p["wo"]
    return out, k, v
