"""The Mamba2 decoder as the program runs it, in plain PyTorch.

Embedding scaled by sqrt(d); per layer RMSNorm (scale ``1 + w``), then the
Mamba2 mixer: one input projection to (z, xBC, dt), a causal depthwise
convolution of width ``ssm_conv`` over xBC with its bias and SiLU, dt =
softplus(dt + dt_bias), A = -exp(A_log), the state-space recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t, plus D x, a gated
RMSNorm (``norm_w``, eps 1e-6, gate SiLU(z)), the output projection, a
residual; a final RMSNorm and logits through the tied embedding.  The
recurrence is evaluated as its quadratic form over the whole sequence
(the decay between two positions from a float64 cumulative sum), not the
chunked scan the program's kernel runs.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from . import exact_float32, layer, mm, rms_norm, vocab_padded

f32 = torch.float32
HEAD_BLOCK = 8          # heads whose (T, T) decay matrices are held at once


def _sizes(d: Dict[str, Any]):
    di = d["ssm_expand"] * d["d_model"]
    H = di // d["ssm_head_dim"]
    return di, H, d["ssm_head_dim"], d["ssm_state"]


def leaves(d: Dict[str, Any]) -> List[tuple]:
    D, L = d["d_model"], d["n_layers"]
    di, H, P, N = _sizes(d)
    dxbc = di + 2 * N

    def st(*shape):
        return (L,) + shape if L > 1 else shape

    norm = ("normal", 0.1)
    g = ("groups", 0)
    return [
        (("embed",), (vocab_padded(d["vocab_size"]), D), "bfloat16",
         ("normal", 0.02)),
        (("final_norm",), (D,), "bfloat16", norm),
        (g + ("A_log",), st(H), "float32", ("log_uniform", 1.0, 16.0)),
        (g + ("D",), st(H), "float32", ("uniform", 0.5, 1.5)),
        (g + ("conv_b",), st(dxbc), "float32", ("normal", 0.02)),
        (g + ("conv_w",), st(d["ssm_conv"], dxbc), "bfloat16",
         ("normal", d["ssm_conv"] ** -0.5)),
        (g + ("dt_bias",), st(H), "float32", ("dt_bias", 1e-3, 1e-1)),
        (g + ("in_proj",), st(D, 2 * di + 2 * N + H), "bfloat16",
         ("normal", D ** -0.5)),
        (g + ("ln",), st(D), "bfloat16", norm),
        (g + ("norm_w",), st(di), "bfloat16", norm),
        (g + ("out_proj",), st(di, D), "bfloat16", ("normal", di ** -0.5)),
    ]


def ssd(x, dt, A, Bm, Cm) -> torch.Tensor:
    """y (T, H, P) of the recurrence from a zero state, one sequence:
    x (T, H, P), dt (T, H), A (H,), Bm and Cm (T, N)."""
    T, H, P = x.shape
    cs = torch.cumsum((dt * A).to(torch.float64), dim=0)       # (T, H)
    scores = Cm @ Bm.t()                                       # (T, T)
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    y = torch.empty_like(x)
    for h0 in range(0, H, HEAD_BLOCK):
        c = cs[:, h0:h0 + HEAD_BLOCK].t()                      # (h, T)
        seg = (c[:, :, None] - c[:, None, :]).masked_fill(~causal, -math.inf)
        m = torch.exp(seg).to(f32) * scores * dt[:, h0:h0 + HEAD_BLOCK].t(
            )[:, None, :]
        y[:, h0:h0 + HEAD_BLOCK] = torch.einsum(
            "hts,shp->thp", m, x[:, h0:h0 + HEAD_BLOCK])
    return y


def _mixer(d, p, x, quant):
    """One Mamba2 mixer over x (T, d) of one sequence."""
    di, H, P, N = _sizes(d)
    T = x.shape[0]
    z, xbc, dt = torch.split(mm(x, p["in_proj"], quant), [di, di + 2 * N, H],
                             dim=-1)
    w = p["conv_w"].to(f32)
    K = w.shape[0]
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    acc = sum(xp[i:i + T] * w[i] for i in range(K))
    xbc = F.silu(acc + p["conv_b"].to(f32))
    xs, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].to(f32), threshold=1e30)
    A = -torch.exp(p["A_log"].to(f32))
    xh = xs.reshape(T, H, P)
    y = ssd(xh, dt, A, Bm, Cm) + xh * p["D"].to(f32)[None, :, None]
    y = rms_norm(y.reshape(T, di) * F.silu(z), p["norm_w"], 1e-6)
    return mm(y, p["out_proj"], quant)


def logits(d: Dict[str, Any], w: Dict[tuple, torch.Tensor],
           tokens: torch.Tensor, last: int, quant: str = "") -> torch.Tensor:
    """Logits (B, last, vocab_padded) at the last ``last`` positions of
    ``tokens`` (B, T), computed from the whole sequence."""
    with exact_float32():
        L, eps = d["n_layers"], d["norm_eps"]
        E = w[("embed",)]
        out = []
        g = ("groups", 0)
        for row in tokens:
            h = E[row].to(f32) * math.sqrt(d["d_model"])
            for i in range(L):
                p = {k[-1]: layer(t, i, L) for k, t in w.items()
                     if k[:2] == g}
                h = h + _mixer(d, p, rms_norm(h, p["ln"], eps), quant)
            x = rms_norm(h[-last:], w[("final_norm",)], eps)
            out.append(mm(x, E.t(), quant))
        return torch.stack(out)
