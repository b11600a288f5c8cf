"""Plain PyTorch references, one module per model family.

Each family module gives ``leaves(dims)`` (the weights the benchmark draws,
in the program's parameter layout) and ``logits(dims, weights, tokens,
last, quant)`` (a whole-sequence forward in float32 with TF32 off, or with
every matrix product's inputs rounded to fp8 for the control).  The
modules import torch alone: nothing of ``repro_torch``, ``repro`` or
``jax``, and nothing the program made besides the tokens it served, which
they only judge.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import Any, Iterator

import torch

F8 = getattr(torch, "float8_e4m3fn", None)
F8_MAX = 448.0


def family(name: str) -> Any:
    return importlib.import_module(f"{__name__}.{name}")


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """float32 products in float32: TF32 off for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with one scale per slice along ``dim``'s
    complement (amax over ``dim``), back in float32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / F8_MAX
    return (t / s).to(F8).to(torch.float32) * s


def mm(x: torch.Tensor, w: torch.Tensor, quant: str = "") -> torch.Tensor:
    """``x @ w`` in float32; with ``quant="fp8"`` both inputs are rounded
    to e4m3 first (a scale per row of ``x``, per column of ``w``), the
    precision below the bfloat16 the configurations state."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    if quant == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    elif quant:
        raise ValueError(f"unknown quantisation {quant!r}")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm scaled by ``1 + w``, as the program parameterises it."""
    x = x.to(torch.float32)
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + w.to(torch.float32))


def layer(t: torch.Tensor, i: int, count: int) -> torch.Tensor:
    """Layer ``i`` of a stacked leaf (a group of one layer is unstacked)."""
    return t[i] if count > 1 else t


def vocab_padded(vocab: int) -> int:
    return -(-vocab // 256) * 256
