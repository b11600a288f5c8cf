"""One launch of each of the program's kernels, from its problem's shapes
(bf16 operands, as the serving path passes them)."""
from __future__ import annotations

from typing import Sequence, Tuple

BF16 = 2
F32 = 4


def flash_attention(rows: int, S: int, Hq: int, Hkv: int,
                    hd: int) -> Tuple[float, float]:
    """Causal attention of ``rows`` sequences of ``S`` tokens: query i sees
    i + 1 keys, so each head does S(S+1)/2 query-key pairs, two products
    of 2·hd operations each."""
    flops = rows * Hq * 2 * hd * S * (S + 1)
    nbytes = rows * S * hd * (2 * Hq + 2 * Hkv) * BF16
    return float(flops), float(nbytes)


def decode_attention(keys: Sequence[int], Hq: int, Hkv: int,
                     hd: int) -> Tuple[float, float]:
    """One query a row over ``keys[r]`` cached positions (valid_len)."""
    n = sum(keys)
    flops = 4 * Hq * hd * n
    nbytes = (2 * Hkv * hd * n + 2 * Hq * hd * len(keys)) * BF16 \
        + 4 * len(keys)
    return float(flops), float(nbytes)


def ssd_scan(rows: int, S: int, H: int, P: int, N: int,
             Q: int) -> Tuple[float, float]:
    """The state-space scan of ``rows`` sequences from a null state, in
    chunks of ``Q`` (the configuration's chunk): per chunk C·Bᵀ (shared by
    the heads), and per head the masked product with x·dt, the chunk's
    state, the output from the entering state and the state's carry."""
    nc = -(-S // Q)
    per_chunk = 2 * Q * Q * N + H * (2 * Q * Q * P + 4 * Q * N * P
                                     + 2 * N * P)
    flops = rows * nc * per_chunk
    nbytes = rows * ((2 * S * H * P + S * H + 2 * S * N) * BF16
                     + H * P * N * F32) + H * F32
    return float(flops), float(nbytes)
