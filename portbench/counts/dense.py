"""The dense decoder's operations and kernel launches."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from . import kernels


def _shapes(d):
    return (d["d_model"], d["n_layers"], d["n_heads"], d["n_kv_heads"],
            d["head_dim"], d["d_ff"], -(-d["vocab_size"] // 256) * 256)


def _linear(d) -> int:
    """Operations of one token's products in one layer."""
    D, _, hq, hkv, hd, ff, _ = _shapes(d)
    return 2 * (D * hq * hd + 2 * D * hkv * hd + hq * hd * D + 3 * D * ff)


def join_flops(d, rows: int, S: int) -> float:
    D, L, hq, _, hd, _, V = _shapes(d)
    attn = 2 * hq * hd * S * (S + 1)
    return float(rows * (L * (S * _linear(d) + attn) + 2 * D * V))


def step_flops(d, keys: Sequence[int]) -> float:
    D, L, hq, _, hd, _, V = _shapes(d)
    return float(sum(L * (_linear(d) + 4 * hq * hd * k) + 2 * D * V
                     for k in keys))


def join_launches(d, rows: int, S: int) -> Dict[str, List[Tuple]]:
    _, L, hq, hkv, hd, _, _ = _shapes(d)
    return {"flash_attention":
            [kernels.flash_attention(rows, S, hq, hkv, hd)] * L}


def step_launches(d, keys: Sequence[int]) -> Dict[str, List[Tuple]]:
    _, L, hq, hkv, hd, _, _ = _shapes(d)
    return {"decode_attention":
            [kernels.decode_attention(keys, hq, hkv, hd)] * L}
