"""Flash attention (prefill / forward): the hand-written CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``, body ``_fa_kernel``).  :func:`flash_attention` picks
the implementation from the device of its inputs: CPU and meta tensors go to
:func:`flash_attention_plain`, CUDA tensors launch the kernel or raise.
``flash_attention.launches`` counts kernel launches.

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

import torch

from . import _build
from .ref import PLAIN_DEVICES, flash_attention_ref

HEAD_DIMS = (32, 64, 72, 96, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)
# pointers, then ints, then the stream: the C launcher's parameters
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


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
    fn = _build.launcher("flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, Sq, Sk, Hq, Hkv, hd,
                 int(causal), int(window), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(error {err}) at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
