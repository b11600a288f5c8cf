"""granite-4.0-h-micro's operations and kernel launches: Mamba2 layers
(``ssd_scan`` in joins) and NoPE grouped-query attention layers
(``flash_attention`` in joins, ``decode_attention`` in steps), each with
its SwiGLU MLP, as ``layer_type_list`` orders them."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from . import kernels


def _shapes(d):
    D, ff, hd = d["d_model"], d["d_ff"], d["head_dim"]
    di = d["ssm_expand"] * D
    kinds = d["layer_type_list"]
    return dict(
        D=D, ff=ff, hd=hd, hq=d["n_heads"], hkv=d["n_kv_heads"], di=di,
        H=d["n_ssm_heads"], P=d["ssm_head_dim"], N=d["ssm_state"],
        Q=d["ssm_chunk"], V=-(-d["vocab_size"] // 256) * 256,
        n_mamba=sum(k == "mamba" for k in kinds),
        n_attn=sum(k == "attention" for k in kinds))


def _linear(s) -> Tuple[int, int]:
    """Operations of one token's products in one Mamba layer and in one
    attention layer, each with its MLP."""
    D, di, H, N = s["D"], s["di"], s["H"], s["N"]
    mlp = 2 * 3 * D * s["ff"]
    mamba = 2 * D * (2 * di + 2 * N + H) + 2 * di * D + mlp
    hq, hkv, hd = s["hq"], s["hkv"], s["hd"]
    attn = 2 * (D * hq * hd + 2 * D * hkv * hd + hq * hd * D) + mlp
    return mamba, attn


def join_flops(d, rows: int, S: int) -> float:
    s = _shapes(d)
    lin_m, lin_a = _linear(s)
    scan = kernels.ssd_scan(1, S, s["H"], s["P"], s["N"], s["Q"])[0]
    attn = 2 * s["hq"] * s["hd"] * S * (S + 1)
    return float(rows * (s["n_mamba"] * (S * lin_m + scan)
                         + s["n_attn"] * (S * lin_a + attn)
                         + 2 * s["D"] * s["V"]))


def step_flops(d, keys: Sequence[int]) -> float:
    """A Mamba layer's recurrence: the state's update (an outer product)
    and its read-out, 2·H·P·N operations each; an attention layer's two
    products over the row's keys."""
    s = _shapes(d)
    lin_m, lin_a = _linear(s)
    rec = 4 * s["H"] * s["P"] * s["N"]
    return float(sum(s["n_mamba"] * (lin_m + rec)
                     + s["n_attn"] * (lin_a + 4 * s["hq"] * s["hd"] * k)
                     + 2 * s["D"] * s["V"] for k in keys))


def join_launches(d, rows: int, S: int) -> Dict[str, List[Tuple]]:
    s = _shapes(d)
    return {
        "ssd_scan": [kernels.ssd_scan(rows, S, s["H"], s["P"], s["N"],
                                      s["Q"])] * s["n_mamba"],
        "flash_attention": [kernels.flash_attention(
            rows, S, s["hq"], s["hkv"], s["hd"])] * s["n_attn"]}


def step_launches(d, keys: Sequence[int]) -> Dict[str, List[Tuple]]:
    s = _shapes(d)
    return {"decode_attention": [kernels.decode_attention(
        keys, s["hq"], s["hkv"], s["hd"])] * s["n_attn"]}
