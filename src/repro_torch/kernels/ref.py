"""Plain PyTorch oracles for the attention kernels.

Port of ``src/repro/kernels/ref.py:17-55``: the same contracts, computed in
float32 and cast back to the query's dtype.  ``decode_attention_ref`` keeps
the JAX oracle's behaviour for ``valid_len = 0`` (every key is masked, so the
softmax is uniform and the result is the mean of V); the kernel, and its
plain version in ``kernels/decode_attention.py``, return zeros there instead.
"""
from __future__ import annotations

import math

import torch

f32 = torch.float32
NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q: (B,Sq,Hq,hd), k/v: (B,Sk,Hkv,hd) -> (B,Sq,Hq,hd).  GQA-aware;
    queries are aligned to the end of K (``q_pos = i + Sk - Sq``)."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd).to(f32)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(f32)) / math.sqrt(hd)
    qp = torch.arange(Sq, device=q.device) + (Sk - Sq)
    kp = torch.arange(Sk, device=q.device)
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= qp[:, None] >= kp[None, :]
    if window > 0:
        m &= (qp[:, None] - kp[None, :]) < window
    scores = torch.where(m, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(f32))
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len: torch.Tensor) -> torch.Tensor:
    """One-token attention over a KV cache in prefix layout.

    q: (B,Hq,hd); k/v: (B,L,Hkv,hd); valid_len: (B,) number of valid cache
    slots.  Returns (B,Hq,hd)."""
    B, Hq, hd = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).to(f32)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.to(f32)) / math.sqrt(hd)
    mask = torch.arange(L, device=q.device)[None, :] < valid_len[:, None]
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.to(f32))
    return out.reshape(B, Hq, hd).to(q.dtype)
