"""granite-4.0-h-micro (a Mamba2 + NoPE-GQA hybrid) as the program runs
it, in plain PyTorch.

    h_0       = 12 · E[tokens]                      (embedding_multiplier)
    layer l:  x = RMSNorm(h, ln)                    (scale 1 + w, eps 1e-5)
              h = h + 0.22 · mixer_l(x)             (residual_multiplier)
              x = RMSNorm(h, ln2)
              h = h + 0.22 · W_down (SiLU(x W_gate) ⊙ x W_up)
    logits    = RMSNorm(h, final_norm) · Eᵀ / 8     (tied; logits_scaling)

``layer_type_list`` says which mixer each layer has.  A Mamba2 mixer
(as in ``mamba2.py``): one input projection to (z, xBC, dt), a causal
depthwise convolution of width ``ssm_conv`` over xBC with its bias and
SiLU, dt = softplus(dt + dt_bias), A = -exp(A_log), the recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t + D x_t over one
B/C group, evaluated as ``mamba2.ssd``'s quadratic form; then the gated
RMSNorm RMSNorm(y ⊙ SiLU(z), norm_w) at the model's eps 1e-5, and the
output projection.  An attention mixer: q = x Wq, k = x Wk, v = x Wv with
no bias and no rotary embedding (NoPE), grouped-query (``n_heads`` query
heads share ``n_kv_heads`` K/V heads), causal softmax(q kᵀ · 1/64) v
(``attention_multiplier``), then Wo.  Every layer has its own weights.

The departures from the published model are the program's and are
followed here: the RMSNorm's ``1 + w`` parameterisation; the program's
scan in chunks of 64 (published 256) changes nothing here, as the
quadratic form has no chunks.  The configuration file lists them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import exact_float32, layer, mm, rms_norm, vocab_padded
from .mamba2 import ssd

f32 = torch.float32
# The embedding enters scaled by 12 and leaves tied (divided by 8): a
# token's own row lifts its logit by about 12 · std² · d / (|h| · 8), the
# other rows spread by std · sqrt(d) / 8; at 0.005 the own row sits about
# two spreads up, short of the largest of 100352 others.
EMBED_STD = 0.005


def runs(d: Dict[str, Any]) -> List[Tuple[str, int]]:
    """The layer groups the program makes of ``layer_type_list``: each run
    of Mamba layers one group, each attention layer one."""
    out: List[Tuple[str, int]] = []
    for kind in d["layer_type_list"]:
        if kind == "mamba" and out and out[-1][0] == "mamba":
            out[-1] = ("mamba", out[-1][1] + 1)
        else:
            out.append((kind, 1))
    return out


def _sizes(d: Dict[str, Any]):
    di = d["ssm_expand"] * d["d_model"]
    return di, d["n_ssm_heads"], d["ssm_head_dim"], d["ssm_state"]


def leaves(d: Dict[str, Any]) -> List[tuple]:
    D, ff, hd = d["d_model"], d["d_ff"], d["head_dim"]
    hq, hkv = d["n_heads"], d["n_kv_heads"]
    di, H, P, N = _sizes(d)
    dxbc = di + 2 * N
    norm = ("normal", 0.1)
    out = [
        (("embed",), (vocab_padded(d["vocab_size"]), D), "bfloat16",
         ("normal", EMBED_STD)),
        (("final_norm",), (D,), "bfloat16", norm),
    ]
    for gi, (kind, count) in enumerate(runs(d)):
        g = ("groups", gi)

        def st(*shape):
            return (count,) + shape if count > 1 else shape

        mlp = [
            (g + ("ln2",), st(D), "bfloat16", norm),
            (g + ("w_down",), st(ff, D), "bfloat16", ("normal", ff ** -0.5)),
            (g + ("w_gate",), st(D, ff), "bfloat16", ("normal", D ** -0.5)),
            (g + ("w_up",), st(D, ff), "bfloat16", ("normal", D ** -0.5)),
        ]
        if kind == "mamba":
            out += [
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
                (g + ("out_proj",), st(di, D), "bfloat16",
                 ("normal", di ** -0.5)),
            ] + mlp
        else:
            out += [
                (g + ("ln1",), st(D), "bfloat16", norm),
                (g + ("wk",), st(D, hkv * hd), "bfloat16",
                 ("normal", D ** -0.5)),
                (g + ("wo",), st(hq * hd, D), "bfloat16",
                 ("normal", (hq * hd) ** -0.5)),
                (g + ("wq",), st(D, hq * hd), "bfloat16",
                 ("normal", D ** -0.5)),
                (g + ("wv",), st(D, hkv * hd), "bfloat16",
                 ("normal", D ** -0.5)),
            ] + mlp
    return out


def _mamba(d, p, x, quant):
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
    y = rms_norm(y.reshape(T, di) * F.silu(z), p["norm_w"], d["norm_eps"])
    return mm(y, p["out_proj"], quant)


def _attention(d, p, x, quant):
    """One NoPE grouped-query attention mixer over x (T, d) of one
    sequence, causal, scores scaled by ``attention_multiplier``; a K/V
    head's query heads at a time (their (G, T, T) scores)."""
    T = x.shape[0]
    hq, hkv, hd = d["n_heads"], d["n_kv_heads"], d["head_dim"]
    G = hq // hkv
    q = mm(x, p["wq"], quant).view(T, hkv, G, hd)
    k = mm(x, p["wk"], quant).view(T, hkv, hd)
    v = mm(x, p["wv"], quant).view(T, hkv, hd)
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    out = torch.empty((T, hkv, G, hd), dtype=f32, device=x.device)
    for j in range(hkv):
        s = torch.einsum("qgd,kd->gqk", q[:, j], k[:, j]) \
            * d["attention_multiplier"]
        s = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
        out[:, j] = torch.einsum("gqk,kd->qgd", s, v[:, j])
        del s
    return mm(out.reshape(T, hq * hd), p["wo"], quant)


def logits(d: Dict[str, Any], w: Dict[tuple, torch.Tensor],
           tokens: torch.Tensor, last: int, quant: str = "") -> torch.Tensor:
    """Logits (B, last, vocab_padded) at the last ``last`` positions of
    ``tokens`` (B, T), computed from the whole sequence."""
    with exact_float32():
        eps, rm = d["norm_eps"], d["residual_multiplier"]
        E = w[("embed",)]
        groups = runs(d)
        out = []
        for row in tokens:
            h = E[row].to(f32) * d["embedding_multiplier"]
            for gi, (kind, count) in enumerate(groups):
                g = ("groups", gi)
                gw = {k[-1]: t for k, t in w.items() if k[:2] == g}
                for i in range(count):
                    p = {k: layer(t, i, count) for k, t in gw.items()}
                    if kind == "mamba":
                        x = rms_norm(h, p["ln"], eps)
                        h = h + rm * _mamba(d, p, x, quant)
                    else:
                        x = rms_norm(h, p["ln1"], eps)
                        h = h + rm * _attention(d, p, x, quant)
                    x = rms_norm(h, p["ln2"], eps)
                    f = F.silu(mm(x, p["w_gate"], quant)) \
                        * mm(x, p["w_up"], quant)
                    h = h + rm * mm(f, p["w_down"], quant)
            x = rms_norm(h[-last:], w[("final_norm",)], eps)
            out.append(mm(x, E.t(), quant) / d["logits_scaling"])
        return torch.stack(out)
