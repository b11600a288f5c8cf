"""Flash attention (prefill / forward): the hand-written CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``, body ``_fa_kernel``).  :func:`flash_attention` picks
the implementation from the device of its inputs: CPU and meta tensors go to
:func:`flash_attention_plain`, CUDA tensors launch the kernel or raise.
``flash_attention.launches`` counts kernel launches.

On the card the kernel has three bodies, and :func:`flash_body` alone
picks one from the head dim and the dtype: bf16 at hd 32 to 128 runs
``persistent`` (at most one CTA an SM, :func:`flash_ctas` of them, each
walking many 128-row work tiles in :func:`flash_order`'s order, so that one
tile's loads and store overlap another's products), bf16 at hd 256
``hd256`` (64 or 128 q rows a CTA, :func:`flash_block_q`), and float32
``f32`` (the CUDA cores).  The C
launcher takes the body as it is given and refuses one it was not built
for at that head dim; there is no other route for a CUDA tensor.

Training: when grad is enabled and q, k or v requires it, a CUDA call goes
through :class:`FlashAttentionFn`, whose forward is the same kernel launch
and whose backward recomputes ``ref.flash_attention_ref`` under autograd.
The JAX package has no backward kernel to port (``src/repro/kernels`` holds
no ``custom_vjp``; its training differentiates the reference ops).  Without
a gradient to carry (serving) the kernel is called directly, with no
``autograd.Function`` in the way.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List

import torch

from . import _build
from ..device import l2_bytes, sm_count
from .ref import PLAIN_DEVICES, flash_attention_ref

HEAD_DIMS = (32, 64, 72, 96, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)
# pointers, then ints, then the stream: the C launcher's parameters
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
# the C launcher's bodies, in its numbering (csrc/flash_attention.cu, Body)
BODIES = ("persistent", "hd256", "f32")
# q rows of a persistent work tile and keys of its K/V tiles; at hd 256
# the wrapper picks the rows from both
BLOCK_Q = 128
KEYS = 128
BLOCK_Q_HD256 = (64, 128)
# the persistent body's head dims, and its CTAs an SM (its 384 threads of
# 168 registers fill the register file; 193 KB of shared memory at hd 128)
PERSISTENT_HEAD_DIMS = (32, 64, 72, 96, 128)
PERSISTENT_CTAS_PER_SM = 1


def flash_body(hd: int, dtype: torch.dtype) -> str:
    """The kernel body that runs ``hd`` and ``dtype`` on the card: ``"f32"``
    for float32, ``"hd256"`` at hd 256, ``"persistent"`` at hd 32 to 128,
    where one CTA fills an SM and so walks many work tiles."""
    if dtype == torch.float32:
        return "f32"
    return "hd256" if hd == 256 else "persistent"


def flash_ctas(B: int, Sq: int, Hq: int, hd: int, sm_count: int) -> int:
    """The persistent body's grid: one CTA a work tile (128 q rows of one
    head and batch row) up to ``PERSISTENT_CTAS_PER_SM`` an SM; past that
    each CTA takes every ``grid``-th tile, heaviest first."""
    if hd not in PERSISTENT_HEAD_DIMS:
        raise ValueError(f"the persistent flash body takes hd "
                         f"{PERSISTENT_HEAD_DIMS}, got {hd}")
    tiles = B * Hq * -(-Sq // BLOCK_Q)
    return max(1, min(tiles, PERSISTENT_CTAS_PER_SM * sm_count))


def walk_loads(order: str, B: int, Sq: int, Sk: int, Hq: int, Hkv: int,
               ctas: int, causal: bool = True, window: int = 0
               ) -> List[int]:
    """The live K/V tiles of 128 keys that each of the persistent body's
    ``ctas`` CTAs runs when it walks the work tiles in ``order``: work tile
    w (the kernel's ``tile_of``) goes to CTA ``w % ctas`` in even rounds of
    the grid and to ``ctas - 1 - w % ctas`` in odd ones (``work``), and
    holds the live tiles of its 128 q rows (``TileRange``)."""
    nq, nk, G = -(-Sq // BLOCK_Q), -(-Sk // KEYS), Hq // Hkv
    live = []
    for iq in range(nq):
        first_q = iq * BLOCK_Q + Sk - Sq
        last_q = first_q + BLOCK_Q - 1
        hi = nk if not causal else (0 if last_q < 0 else
                                    min(nk, last_q // KEYS + 1))
        lo = 0
        while window > 0 and lo < hi and \
                first_q - (lo * KEYS + KEYS - 1) >= window:
            lo += 1
        live.append(hi - lo)
    loads = [0] * ctas
    for w in range(B * Hq * nq):
        iq = (nq - 1 - (w // G) % nq if order == "groups"
              else nq - 1 - w // (Hq * B))
        c = w % ctas
        loads[ctas - 1 - c if (w // ctas) % 2 else c] += live[iq]
    return loads


@functools.lru_cache(maxsize=256)
def flash_order(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, hd: int,
                ctas: int, l2_bytes: int, causal: bool = True,
                window: int = 0) -> str:
    """The order in which the persistent body's CTAs walk the work tiles.
    ``"heads"``: the q heads fastest, then the batch rows, then the q tile
    from the heaviest down, so that the G heads of a KV head share its K/V
    in L2 within a round of the grid and the longest tiles run first.
    ``"groups"``: each KV head's G x ceil(Sq / 128) tiles together (heads
    fastest, then the q tile, heaviest first), where the launch's K/V
    (``2 * B * Sk * Hkv * hd`` bf16 values) exceeds half the L2 and would
    be read again from memory by each round of the first order, unless
    that order loads some CTA with more live K/V tiles than the first
    (:func:`walk_loads`): over a long prompt a head's q tiles, of
    ``ceil(Sq / 128)`` different weights, fall unevenly on the rounds.  On
    an H100, minicpm-2b's 36 heads at hd 64 took 0.0532 ms by groups and
    0.0593 by heads at bucket 8 over 512 tokens (both orders at most 24
    tiles a CTA), and 0.2228 by groups and 0.2101 by heads at batch 1 over
    4096 tokens (164 and 146 tiles; PERF.md, section 6)."""
    kv = 2 * B * Sk * Hkv * hd * 2
    if 2 * kv <= l2_bytes:
        return "heads"
    loads = {order: max(walk_loads(order, B, Sq, Sk, Hq, Hkv, ctas, causal,
                                   window))
             for order in ("heads", "groups")}
    return "groups" if loads["groups"] <= loads["heads"] else "heads"


def flash_block_q(B: int, Sq: int, Hq: int, hd: int, sm_count: int) -> int:
    """q rows per CTA of the ``hd256`` body (the persistent one's work
    tiles are ``BLOCK_Q`` rows, which other head dims return).  At hd 256
    a CTA holds one SM: there 64 (one warpgroup) where the 64-row
    grid of ``B * Hq * ceil(Sq / 64)`` CTAs fits one CTA per SM, which
    halves the heaviest CTA's work at batch 1, and 128 where it does not,
    which halves the K/V tiles read per q row."""
    if hd != 256:
        return BLOCK_Q
    small = B * Hq * -(-Sq // 64) <= sm_count
    return BLOCK_Q_HD256[0] if small else BLOCK_Q_HD256[1]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the oracle of
    ``kernels/ref.py``): q (B,Sq,Hq,hd), k/v (B,Sk,Hkv,hd) -> (B,Sq,Hq,hd)."""
    return flash_attention_ref(q, k, v, causal=causal, window=window)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (B,Sq,Hq,hd) and k/v "
                         f"(B,Sk,Hkv,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[2] == 0 \
            or Hq % k.shape[2]:
        raise ValueError(f"flash_attention: incompatible q {tuple(q.shape)} "
                         f"and k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_attention: q, k, v must share device "
                             "and dtype")
        if t.dtype not in DTYPES:
            raise ValueError(f"flash_attention kernel takes {DTYPES}, "
                             f"got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention kernel needs contiguous, "
                             "16-byte aligned tensors")


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient: ``forward(q, k, v, causal, window)``
    (the kernel launch on the card) and a backward that recomputes
    ``flash_attention_ref`` on the saved inputs under autograd.  The
    tests' gradient checks pass the plain version as ``forward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, forward):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return forward(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = flash_attention_ref(*inputs, causal=ctx.causal,
                                      window=ctx.window)
            got = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(got) if t.requires_grad else None
                     for t in inputs) + (None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,Sq,Hq,hd), k/v (B,Sk,Hkv,hd) -> (B,Sq,Hq,hd), queries aligned
    to the end of K.  CPU and meta tensors: the plain version; CUDA
    tensors: the kernel, inside :class:`FlashAttentionFn` when a gradient
    is to be carried."""
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, _launch)
    return _launch(q, k, v, causal=causal, window=window)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int) -> torch.Tensor:
    """The kernel on CUDA tensors; counts the launch."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu, meta or cuda tensors, "
                         f"got {q.device}")
    _check(q, k, v)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    body = flash_body(hd, q.dtype)
    sms = sm_count(q.device)
    block_q = flash_block_q(B, Sq, Hq, hd, sms)
    ctas = groups = 0
    if body == "persistent":
        ctas = flash_ctas(B, Sq, Hq, hd, sms)
        groups = int(flash_order(B, Sq, Sk, Hq, Hkv, hd, ctas,
                                 l2_bytes(q.device), causal, window)
                     == "groups")
    fn = _build.launcher("flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 BODIES.index(body), B, Sq, Sk, Hq, Hkv, hd, int(causal),
                 int(window), block_q, ctas, groups, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(error {err}) at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype}, body {body}, "
                           + (f"{ctas} CTAs" if ctas else
                              f"{block_q} q rows a CTA"))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
