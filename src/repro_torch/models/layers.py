"""Neural building blocks, plain functions on tensors over parameter dicts.

Port of ``src/repro/models/layers.py:26-140, 209-361`` (norms, MLPs,
rotary embeddings, attention, Mamba2).  The hot spots (attention and the
SSD scan) go through ``kernels.ops``, whose implementation the tensors'
device picks.  Mixture of experts is not ported yet (ROADMAP, Queue 1).
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


# ---------------------------------------------------------------------------
# Mamba2 (SSD: state-space duality, chunked scan)  [arXiv:2405.21060]
# ---------------------------------------------------------------------------


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{j < t <= i} x[..., t],
    -inf above the diagonal, so exp(_segsum(dA)) is the decay matrix."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD core over a whole sequence, the JAX package's chunked
    reference (its rounding too: x·dt is formed in the input dtype).

    xh: (B,S,H,P)  dt: (B,S,H)  A: (H,) negative  Bm,Cm: (B,S,N)
    Returns (y: (B,S,H,P), final_state: (B,H,P,N) float32)."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    S0 = S
    pad = (-S) % chunk
    if pad:
        # dt = 0 on padded steps: decay exp(0) = 1 and no input, so the
        # padding never perturbs the state
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // chunk
    x_c = xh.reshape(Bsz, nc, chunk, H, P)
    dt_c = dt.reshape(Bsz, nc, chunk, H)
    B_c = Bm.reshape(Bsz, nc, chunk, N).to(f32)
    C_c = Cm.reshape(Bsz, nc, chunk, N).to(f32)

    dA = dt_c * A[None, None, None, :]                       # (B,nc,Q,H)
    dA_hbt = dA.movedim(-1, 2)                               # (B,nc,H,Q)
    L = torch.exp(_segsum(dA_hbt.to(f32)))                   # (B,nc,H,Q,Q)
    xdt = (x_c * dt_c[..., None]).to(f32)
    scores = torch.einsum("bcqn,bckn->bcqk", C_c, B_c)
    y_diag = torch.einsum("bchqk,bcqk,bckhp->bcqhp", L, scores, xdt)

    dA_cum = torch.cumsum(dA_hbt, dim=-1)                    # (B,nc,H,Q)
    decay_out = torch.exp((dA_cum[..., -1:] - dA_cum).to(f32))
    states = torch.einsum("bchq,bcqn,bcqhp->bchpn", decay_out, B_c, xdt)

    chunk_decay = torch.exp(dA_cum[..., -1].to(f32))         # (B,nc,H)
    carry = (torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):          # emit the state entering each chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (B,nc,H,P,N)

    decay_in = torch.exp(dA_cum.to(f32))                     # (B,nc,H,Q)
    y_off = torch.einsum("bcqn,bchq,bchpn->bcqhp", C_c, decay_in,
                         prev_states)
    y = (y_diag + y_off).reshape(Bsz, S, H, P)[:, :S0].to(xh.dtype)
    return y, carry


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent update.
    state: (B,H,P,N)  x: (B,H,P)  dt: (B,H)  Bm,Cm: (B,N)."""
    dA = torch.exp((dt * A[None, :]).to(f32))                # (B,H)
    dBx = torch.einsum("bn,bhp,bh->bhpn", Bm.to(f32), x.to(f32),
                       dt.to(f32))
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.to(f32))
    return y.to(x.dtype), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) = logaddexp(x, 0) everywhere
    (``F.softplus`` turns linear above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba2_block(x: torch.Tensor, p: Params, *, n_heads: int, head_dim: int,
                 d_state: int, d_conv: int, chunk: int,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full Mamba2 mixer (in_proj -> conv -> SSD -> gated norm -> out_proj).

    x: (B,S,d).  With ``cache`` ('conv' (B,d_conv-1,d_xBC) and 'state'
    (B,H,P,N)) the conv continues from the cached inputs and the scan from
    the cached state; a one-token call is the recurrent step.  Without it
    the conv starts from zeros and the scan from a zero state.  Returns
    (out (B,S,d), new cache {'conv', 'state'})."""
    B, S, _ = x.shape
    H, P, N = n_heads, head_dim, d_state
    di = H * P
    z, xBC, dt = torch.split(x @ p["in_proj"], [di, di + 2 * N, H], dim=-1)
    # causal depthwise conv over the sequence, as the JAX package writes
    # it: products and their sum in the compute dtype, then the float32 bias
    if cache is not None:
        conv_in = torch.cat([cache["conv"], xBC], dim=1)
    else:
        conv_in = F.pad(xBC, (0, 0, d_conv - 1, 0))
    new_conv = conv_in[:, -(d_conv - 1):, :]
    w = p["conv_w"]                                          # (d_conv, d_xBC)
    acc = conv_in[:, 0:S] * w[0]
    for i in range(1, d_conv):
        acc = acc + conv_in[:, i:i + S] * w[i]
    xBC = F.silu(acc + p["conv_b"]).to(x.dtype)
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    xh = xs.reshape(B, S, H, P)
    dt = _softplus(dt.to(f32) + p["dt_bias"].to(f32))      # (B,S,H)
    A = -torch.exp(p["A_log"].to(f32))                       # (H,)

    if cache is not None and S == 1:
        y1, new_state = kernel_ops.ssd_step(cache["state"], xh[:, 0],
                                            dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = y1[:, None]
    else:
        init = cache["state"] if cache is not None else None
        y, new_state = kernel_ops.ssd(
            xh.contiguous(), dt.to(xh.dtype), A, Bm.contiguous(),
            Cm.contiguous(), chunk=chunk, init_state=init)
    y = y + xh * p["D"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    # gated RMSNorm (mamba2 style), at rms_norm's default eps as in JAX
    y = rms_norm(y * F.silu(z), p["norm_w"])
    return y @ p["out_proj"], {"conv": new_conv, "state": new_state}
