"""Plain PyTorch oracles for every kernel.

Port of ``src/repro/kernels/ref.py``: the same contracts, computed in
float32 and cast back to the input's dtype.  ``decode_attention_ref`` keeps
the JAX oracle's behaviour for ``valid_len = 0`` (every key is masked, so the
softmax is uniform and the result is the mean of V); the kernel, and its
plain version in ``kernels/decode_attention.py``, return zeros there instead.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

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


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 init_state: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (Mamba2): delegates to the model-layer reference.
    x: (B,S,H,P), dt: (B,S,H), A: (H,), Bm/Cm: (B,S,N)."""
    # lazy: models.layers imports kernels.ops, which imports this module
    from ..models.layers import ssd_chunked
    return ssd_chunked(x, dt, A, Bm, Cm, chunk, init_state=init_state)


def ssd_scan_sequential_ref(x: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, Bm: torch.Tensor,
                            Cm: torch.Tensor,
                            init_state: Optional[torch.Tensor] = None,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The token-by-token SSM recurrence: the independent oracle of the
    chunked math."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    state = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    A = A.to(f32)
    ys = []
    for t in range(S):
        dtt = dt[:, t].to(f32)                                  # (B,H)
        dA = torch.exp(dtt * A[None, :])
        dBx = torch.einsum("bn,bhp,bh->bhpn", Bm[:, t].to(f32),
                           x[:, t].to(f32), dtt)
        state = state * dA[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t].to(f32)))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, H, P), dtype=f32, device=x.device))
    return y.to(x.dtype), state
