"""Flash-decoding: the hand-written CUDA kernel ``csrc/decode_attention.cu``
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py``
(``decode_attention``, body ``_dec_kernel``).  :func:`decode_attention`
picks the implementation from the device of its inputs: CPU and meta
tensors go to :func:`decode_attention_plain`, CUDA tensors launch the
kernel or raise.
``decode_attention.launches`` counts kernel launches.

A row with ``valid_len = 0`` attends to nothing and comes out as zeros, as
the Pallas kernel's does; the JAX oracle ``ref.decode_attention_ref``
returns the mean of V there instead, and the plain version here follows the
kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from ..device import sm_count
from .ref import PLAIN_DEVICES, decode_attention_ref

HEAD_DIMS = (32, 64, 72, 96, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)
# pointers, then ints, then the stream: the C launcher's parameters
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
MAX_GROUP_WIDTH = 1024      # G * hd: the kernel's per-lane registers
SPLIT_TILE = 32             # the kernel's keys per tile: splits are multiples
MAX_SPLIT = 8               # CTAs per cluster that every Hopper card takes
CTAS_PER_SM = 4             # the plan aims at this many CTAs per SM


def split_plan(B: int, Hkv: int, L: int, sm_count: int) -> Tuple[int, int]:
    """How the kernel splits the cache: ``(n_split, chunk)``.  Split ``s`` of
    every (b, KV head) covers keys ``[s * chunk, min((s + 1) * chunk, L))``;
    the ranges are contiguous, cover ``[0, L)`` and are none of them empty.
    ``chunk`` is a whole number of the kernel's 32-key tiles and
    ``n_split <= 8`` (one thread-block cluster per (b, KV head)).  The plan
    aims at ``CTAS_PER_SM`` CTAs per SM over the ``B * Hkv * n_split``
    CTAs, so that batch 1 fills the card as batch 8 does."""
    tiles = max(1, -(-L // SPLIT_TILE))
    want = -(-CTAS_PER_SM * sm_count // max(1, B * Hkv))
    n = max(1, min(MAX_SPLIT, want, tiles))
    chunk = -(-tiles // n) * SPLIT_TILE
    return max(1, -(-L // chunk)), chunk


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: q (B,Hq,hd), k/v (B,L,Hkv,hd),
    valid_len (B,) -> (B,Hq,hd); rows with valid_len <= 0 are zeros."""
    out = decode_attention_ref(q, k, v, valid_len)
    return torch.where((valid_len > 0)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid_len: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention wants q (B,Hq,hd) and k/v "
                         f"(B,L,Hkv,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, hd = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"decode_attention: incompatible q "
                         f"{tuple(q.shape)} and k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if (Hq // Hkv) * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention kernel takes (Hq/Hkv)*hd <= "
                         f"{MAX_GROUP_WIDTH}, got {(Hq // Hkv) * hd}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("decode_attention: q, k, v must share device "
                             "and dtype")
        if t.dtype not in DTYPES:
            raise ValueError(f"decode_attention kernel takes {DTYPES}, "
                             f"got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("decode_attention kernel needs contiguous, "
                             "16-byte aligned tensors")
    if valid_len.shape != (B,) or valid_len.dtype != torch.int32 \
            or valid_len.device != q.device or not valid_len.is_contiguous():
        raise ValueError(f"decode_attention: valid_len must be a contiguous "
                         f"int32 ({B},) tensor on {q.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor) -> torch.Tensor:
    """q (B,Hq,hd), k/v (B,L,Hkv,hd), valid_len (B,) -> (B,Hq,hd).  CPU
    and meta tensors: the plain version; CUDA tensors: the kernel."""
    if q.device.type in PLAIN_DEVICES:
        return decode_attention_plain(q, k, v, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu, meta or cuda "
                         f"tensors, got {q.device}")
    _check(q, k, v, valid_len)
    B, Hq, hd = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    n_split, chunk = split_plan(B, Hkv, L, sm_count(q.device))
    fn = _build.launcher("decode_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 valid_len.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, L, Hq, Hkv, hd, n_split,
                 chunk, stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed "
                           f"(error {err}) at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype}, {n_split} "
                           f"splits of {chunk} keys")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
