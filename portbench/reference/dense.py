"""The dense decoder as the program runs it, in plain PyTorch.

A pre-norm transformer: embedding scaled by sqrt(d); per layer RMSNorm
(scale ``1 + w``), multi-head attention with rotary embeddings (split
halves) under a causal mask, a residual, RMSNorm and a SwiGLU MLP, a
residual; a final RMSNorm and logits through the tied embedding over all
``vocab_padded`` rows.  Departures from MiniCPM's published architecture
(its muP scales ``scale_emb``, ``scale_depth`` and ``dim_model_base``)
are the program's and are followed here; the configuration file lists
them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from . import exact_float32, layer, mm, rms_norm, vocab_padded

f32 = torch.float32
# The embedding enters scaled by sqrt(d) and leaves tied, so a token's own
# row pulls its logit up: at 0.02 every served token repeated the one
# before it, at 0.005 98 % did, which no comparison of logits could tell
# from a model that ignores its context; at 0.001 about a third do
# (minicpm-2b at full size on the chip).
EMBED_STD = 0.001


def leaves(d: Dict[str, Any]) -> List[tuple]:
    D, L, hd = d["d_model"], d["n_layers"], d["head_dim"]
    hq, hkv, ff = d["n_heads"], d["n_kv_heads"], d["d_ff"]

    def st(*shape):
        return (L,) + shape if L > 1 else shape

    norm = ("normal", 0.1)
    g = ("groups", 0)
    return [
        (("embed",), (vocab_padded(d["vocab_size"]), D), "bfloat16",
         ("normal", EMBED_STD)),
        (("final_norm",), (D,), "bfloat16", norm),
        (g + ("ln1",), st(D), "bfloat16", norm),
        (g + ("ln2",), st(D), "bfloat16", norm),
        (g + ("w_down",), st(ff, D), "bfloat16", ("normal", ff ** -0.5)),
        (g + ("w_gate",), st(D, ff), "bfloat16", ("normal", D ** -0.5)),
        (g + ("w_up",), st(D, ff), "bfloat16", ("normal", D ** -0.5)),
        (g + ("wk",), st(D, hkv * hd), "bfloat16", ("normal", D ** -0.5)),
        (g + ("wo",), st(hq * hd, D), "bfloat16",
         ("normal", (hq * hd) ** -0.5)),
        (g + ("wq",), st(D, hq * hd), "bfloat16", ("normal", D ** -0.5)),
        (g + ("wv",), st(D, hkv * hd), "bfloat16", ("normal", D ** -0.5)),
    ]


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, hd) at positions 0..T-1, split-halves convention."""
    T, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=f32,
                                          device=x.device) / hd))
    ang = torch.arange(T, dtype=f32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention, (B, T, H, hd) each; grouped heads share
    their K/V head."""
    B, T, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def logits(d: Dict[str, Any], w: Dict[tuple, torch.Tensor],
           tokens: torch.Tensor, last: int, quant: str = "") -> torch.Tensor:
    """Logits (B, last, vocab_padded) at the last ``last`` positions of
    ``tokens`` (B, T), computed from the whole sequence."""
    with exact_float32():
        L, hd, eps = d["n_layers"], d["head_dim"], d["norm_eps"]
        hq, hkv = d["n_heads"], d["n_kv_heads"]
        B, T = tokens.shape
        E = w[("embed",)]
        h = E[tokens].to(f32) * math.sqrt(d["d_model"])
        g = ("groups", 0)
        for i in range(L):
            p = {k[-1]: layer(t, i, L) for k, t in w.items() if k[:2] == g}
            x = rms_norm(h, p["ln1"], eps)
            q = _rope(mm(x, p["wq"], quant).view(B, T, hq, hd),
                      d["rope_theta"])
            k = _rope(mm(x, p["wk"], quant).view(B, T, hkv, hd),
                      d["rope_theta"])
            v = mm(x, p["wv"], quant).view(B, T, hkv, hd)
            a = _attention(q, k, v).reshape(B, T, hq * hd)
            h = h + mm(a, p["wo"], quant)
            x = rms_norm(h, p["ln2"], eps)
            f = torch.nn.functional.silu(mm(x, p["w_gate"], quant)) \
                * mm(x, p["w_up"], quant)
            h = h + mm(f, p["w_down"], quant)
        x = rms_norm(h[:, -last:], w[("final_norm",)], eps)
        return mm(x, E.t(), quant)
