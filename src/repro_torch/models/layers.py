"""Neural building blocks, plain functions on tensors over parameter dicts.

Port of ``src/repro/models/layers.py`` (norms, MLPs, rotary embeddings,
attention, mixture of experts, Mamba2).  The hot spots (attention and the
SSD scan) go through ``kernels.ops``, whose implementation the tensors'
device picks.  ``moe_block`` is plain PyTorch on every device, as it is
plain jnp on every backend of the JAX package (no Pallas kernel was
written for it).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops
from .spmd import (evenly, per_head, per_row, replicated, rows_and_heads,
                   settled, shard_as, whole)

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
    return settled((g * (x @ w_up)) @ w_down)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    # tanh approximation: jax.nn.gelu's default
    return settled(F.gelu(x @ w_up, approximate="tanh") @ w_down)


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
                    rope_theta: float,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    causal: bool = True, window: int = 0,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self- (or cross-) attention sublayer body (no residual / norm).
    Returns (out, k, v) so callers can stash K/V into a cache.
    ``kv_override`` supplies externally computed K/V (cross-attention): then
    RoPE rotates q alone, as in the JAX package.  The attention itself is
    ``kernels.ops.attention`` with the structural causal/window
    description, as the JAX package's kernel path passes it."""
    B, S, _ = x.shape
    q = evenly(x @ p["wq"], n_heads).reshape(B, S, n_heads, hd)
    if kv_override is None:
        k = evenly(x @ p["wk"], n_kv_heads).reshape(B, S, n_kv_heads, hd)
        v = evenly(x @ p["wv"], n_kv_heads).reshape(B, S, n_kv_heads, hd)
        k = apply_rope(k, positions, rope_theta)
    else:
        k, v = kv_override
    q = apply_rope(q, positions, rope_theta)
    out = rows_and_heads(kernel_ops.attention, (q, k, v), ((0, 2),) * 3,
                         ((0, 2),), (q.shape,), (k.shape[2],),
                         causal=causal, window=window)
    out = evenly(out, n_heads, dim=2).reshape(B, S, n_heads * hd) @ p["wo"]
    return settled(out), k, v


# ---------------------------------------------------------------------------
# Mixture of experts (sort-based dispatch with capacity, Switch-style drops)
# ---------------------------------------------------------------------------


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, largest first, the lower index first among equal values
    (``torch.topk`` promises no order for ties)."""
    idx = torch.argsort(-probs, dim=-1, stable=True)[..., :k]
    return probs.gather(-1, idx), idx


def _route(eidx: torch.Tensor, T: int, E: int, C: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dispatch plan of (T, k) expert ids: each (token, choice)'s slot
    in the (E*C,) buffer (``E*C``, the drop bucket, past an expert's
    capacity), each slot's source token (``T``, the zero row, when empty)
    and the permutation that undoes the stable sort by expert."""
    dev = eidx.device
    k = eidx.shape[-1]
    flat_e = eidx.reshape(-1)                                  # (T*k,)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    seg_start = torch.searchsorted(sorted_e,
                                   torch.arange(E, device=dev))  # (E,)
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    dest = torch.where(pos_in_e < C, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))       # drop bucket
    # scatter 8-byte source indices
    slot_src = torch.full((E * C + 1,), T, dtype=torch.long, device=dev)
    slot_src[dest] = sort_idx // k
    return dest, slot_src, torch.argsort(sort_idx)


def moe_block(x: torch.Tensor, p: Params, *, n_experts: int, k: int,
              capacity_factor: float, mlp: str = "swiglu",
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (y, aux_loss).  Port of the JAX package's
    ``moe_block`` (``src/repro/models/layers.py:148-206``).

    Tokens go to their top-k experts, are sorted by expert id (stably, so
    an expert's tokens keep their order and the last ones past its
    capacity C are dropped) and gathered into a dense (E, C, d) buffer
    through a slot -> source-token index; the expert FFNs run as batched
    einsums over the expert axis, and one gather through the composed
    permutation brings each token's k outputs back, weighted by its
    renormalised gates.  A dropped token's expert output is zero.  The
    auxiliary loss is the Switch load-balance term ``E * sum(me * ce)``."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    logits = (xt @ p["router"]).to(f32)                        # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = top_k(probs, k)                              # (T,k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    E = n_experts
    C = max(1, int(math.ceil(k * T / E * capacity_factor)))
    # the routing's index bookkeeping runs on whole (T*k,) id vectors on
    # every rank of a mesh (searchsorted has no sharding strategy)
    dest, slot_src, inv = replicated(
        lambda e: _route(e, T, E, C), eidx)

    # dispatch: one row gather through the slot -> source-token index; on a
    # mesh each rank then runs its share of the capacity slots
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])
    h = shard_as(xt_pad[slot_src[:E * C]].reshape(E, C, d), 1, x, 0)
    if mlp == "swiglu":
        g = F.silu(torch.einsum("ecd,edf->ecf", h, p["w_gate"]))
        u = torch.einsum("ecd,edf->ecf", h, p["w_up"])
        out_e = torch.einsum("ecf,efd->ecd", g * u, p["w_down"])
    else:
        hmid = F.gelu(torch.einsum("ecd,edf->ecf", h, p["w_up"]),
                      approximate="tanh")
        out_e = torch.einsum("ecf,efd->ecd", hmid, p["w_down"])

    # combine: the two permutations (sorted -> slot, unsort) composed into
    # one row gather, which on a mesh reads every rank's slots
    out_e = whole(whole(out_e, 1), 0)
    out_flat = torch.cat([out_e.reshape(E * C, d), out_e.new_zeros((1, d))])
    out_tk = out_flat[dest[inv]].reshape(T, k, d)
    y = (out_tk * gates.to(x.dtype)[..., None]).sum(dim=1)

    me = probs.mean(dim=0)                                     # (E,)
    ce = F.one_hot(eidx[:, 0], E).to(f32).mean(dim=0)
    aux = E * torch.sum(me * ce)
    return y.reshape(B, S, d), aux


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
    The rest is float32, float64 for float64 inputs (gradient checks).

    xh: (B,S,H,P)  dt: (B,S,H)  A: (H,) negative  Bm,Cm: (B,S,N)
    Returns (y: (B,S,H,P), final_state: (B,H,P,N) float32)."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    S0 = S
    acc = torch.promote_types(xh.dtype, f32)
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
    B_c = Bm.reshape(Bsz, nc, chunk, N).to(acc)
    C_c = Cm.reshape(Bsz, nc, chunk, N).to(acc)

    dA = dt_c * A[None, None, None, :]                       # (B,nc,Q,H)
    dA_hbt = dA.movedim(-1, 2)                               # (B,nc,H,Q)
    L = torch.exp(_segsum(dA_hbt.to(acc)))                   # (B,nc,H,Q,Q)
    xdt = (x_c * dt_c[..., None]).to(acc)
    scores = torch.einsum("bcqn,bckn->bcqk", C_c, B_c)
    y_diag = torch.einsum("bchqk,bcqk,bckhp->bcqhp", L, scores, xdt)

    dA_cum = torch.cumsum(dA_hbt, dim=-1)                    # (B,nc,H,Q)
    decay_out = torch.exp((dA_cum[..., -1:] - dA_cum).to(acc))
    states = torch.einsum("bchq,bcqn,bcqhp->bchpn", decay_out, B_c, xdt)

    chunk_decay = torch.exp(dA_cum[..., -1].to(acc))         # (B,nc,H)
    carry = (torch.zeros((Bsz, H, P, N), dtype=acc, device=xh.device)
             if init_state is None else init_state.to(acc))
    prev = []
    for c in range(nc):          # emit the state entering each chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (B,nc,H,P,N)

    decay_in = torch.exp(dA_cum.to(acc))                     # (B,nc,H,Q)
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
    z, xBC, dt = torch.split(whole(x @ p["in_proj"]), [di, di + 2 * N, H],
                             dim=-1)
    # causal depthwise conv over the sequence, as the JAX package writes
    # it: products and their sum in the compute dtype, then the float32 bias
    if cache is not None:
        conv_in = torch.cat([cache["conv"], xBC], dim=1)
    else:
        conv_in = per_row(lambda t: F.pad(t, (0, 0, d_conv - 1, 0)), xBC,
                          (B, S + d_conv - 1, xBC.shape[-1]))
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
        y1, new_state = rows_and_heads(
            kernel_ops.ssd_step,
            (cache["state"], xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0]),
            ((0, 1), (0, 1), (0, 1), (None, 0), (0, None), (0, None)),
            ((0, 1), (0, 1)), (xh[:, 0].shape, cache["state"].shape), (H,))
        y = y1[:, None]
    else:
        init = cache["state"] if cache is not None else None
        y, new_state = per_head(
            kernel_ops.ssd, xh.contiguous(), dt.to(xh.dtype), A,
            Bm.contiguous(), Cm.contiguous(), chunk=chunk, init_state=init)
    y = y + xh * p["D"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    # gated RMSNorm (mamba2 style), at rms_norm's default eps as in JAX
    y = rms_norm(y * F.silu(z), p["norm_w"])
    return settled(y @ p["out_proj"]), {"conv": new_conv,
                                        "state": new_state}
