"""The Mamba2 decoder's operations and kernel launches."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from . import kernels


def _shapes(d):
    D = d["d_model"]
    di = d["ssm_expand"] * D
    P, N = d["ssm_head_dim"], d["ssm_state"]
    return (D, d["n_layers"], di, di // P, P, N, d["ssm_chunk"],
            -(-d["vocab_size"] // 256) * 256)


def _linear(d) -> int:
    """Operations of one token's input and output projections, one layer."""
    D, _, di, H, _, N, _, _ = _shapes(d)
    return 2 * D * (2 * di + 2 * N + H) + 2 * di * D


def join_flops(d, rows: int, S: int) -> float:
    D, L, _, H, P, N, Q, V = _shapes(d)
    scan = kernels.ssd_scan(1, S, H, P, N, Q)[0]
    return float(rows * (L * (S * _linear(d) + scan) + 2 * D * V))


def step_flops(d, keys: Sequence[int]) -> float:
    """The recurrence of one token: the state's update (an outer product)
    and its read-out, 2·H·P·N operations each."""
    D, L, _, H, P, N, _, V = _shapes(d)
    return float(len(keys) * (L * (_linear(d) + 4 * H * P * N) + 2 * D * V))


def join_launches(d, rows: int, S: int) -> Dict[str, List[Tuple]]:
    _, L, _, H, P, N, Q, _ = _shapes(d)
    return {"ssd_scan": [kernels.ssd_scan(rows, S, H, P, N, Q)] * L}


def step_launches(d, keys: Sequence[int]) -> Dict[str, List[Tuple]]:
    return {}
