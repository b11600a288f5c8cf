"""Mamba2 SSD chunked scan: the hand-written CUDA kernel
``csrc/ssd_scan.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py``
(``ssd_scan``, body ``_ssd_kernel``).  :func:`ssd_scan` picks the
implementation from the device of its inputs: CPU and meta tensors go to
:func:`ssd_scan_plain`, CUDA tensors launch the kernel or raise.
``ssd_scan.launches`` counts kernel launches.  For bf16 inputs the kernel
splits the chunks of each (b, h) across a thread-block cluster:
:func:`ssd_plan` says how.

Training: when grad is enabled and an input requires it, a CUDA call goes
through :class:`SSDScanFn`, whose forward is the same kernel launch and
whose backward recomputes ``ref.ssd_scan_ref`` (the chunked reference the
JAX package's training differentiates; it has no backward kernel) under
autograd.  Without a gradient to carry (serving) the kernel is called
directly.

Contract (``ops.ssd`` in the JAX package): x (B,S,H,P), dt (B,S,H) after
softplus, A (H,) float32 and <= 0, Bm and Cm (B,S,N) shared by every head,
an optional ``init_state`` (B,H,P,N) float32 -> y (B,S,H,P) in x's dtype
and the final state (B,H,P,N) in float32.  S need not be a multiple of
``chunk``: both versions pad it with dt = 0 steps, which decay the state by
exp(0) = 1 and add nothing to it, and cut y back to S.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .ref import PLAIN_DEVICES, ssd_scan_ref
from ..device import sm_count

f32 = torch.float32
HEAD_DIMS = (32, 64)              # P
STATE_DIMS = (16, 32, 64, 128)    # N
CHUNKS = (16, 32, 64)             # Q
DTYPES = (torch.bfloat16, torch.float32)
# pointers, then ints, then the stream: the C launcher's parameters
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
KERNEL_CHUNK = 64           # rows of one step of the bf16 kernel (wgmma M)
MAX_RANKS = 8               # CTAs per cluster that every Hopper card takes
CTAS_PER_SM = 1             # the plan aims at this many CTAs per SM


def ssd_plan(B: int, H: int, S: int, chunk: int,
             sm_count: int) -> Tuple[int, int]:
    """How the bf16 kernel splits the chunks of each (b, h): ``(R,
    chunks_per_cta)``.  The sequence is cut into ``ceil(S / chunk)`` chunks
    of ``chunk`` rows; CTA ``r`` of the (b, h)'s cluster owns chunks ``[r *
    chunks_per_cta, min((r + 1) * chunks_per_cta, n_chunks))``.  The runs
    are contiguous, cover every chunk and are none of them empty, and ``1 <=
    R <= 8``.  The plan takes the fewest ranks that give the ``B * H * R``
    CTAs ``CTAS_PER_SM`` per SM, in runs of equal length, so that batch 1
    fills the card as batch 8 does: every rank but the last walks its run
    twice and reads its predecessors' states, so a split past that costs
    more than it saves (``chip_smoke.py`` times every split)."""
    n_chunks = max(1, -(-S // chunk))
    want = -(-CTAS_PER_SM * sm_count // max(1, B * H))
    n = max(1, min(MAX_RANKS, want, n_chunks))
    per = -(-n_chunks // n)
    return -(-n_chunks // per), per


def _pad_to_chunk(x, dt, Bm, Cm, chunk: int):
    """Zero-pad the sequence axis to a multiple of ``chunk`` (dt = 0)."""
    pad = (-x.shape[1]) % chunk
    if not pad:
        return x, dt, Bm, Cm
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad)))


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                   init_state: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, with ``_ssd_kernel``'s
    numerics: every input widened to float32 (x·dt too), the decay math
    and every product in float32, a loop over chunks carrying the state.
    Float64 inputs stay float64 (gradient checks)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    acc = torch.promote_types(x.dtype, f32)
    xp, dtp, Bp, Cp = _pad_to_chunk(x, dt, Bm, Cm, chunk)
    nc, Q = xp.shape[1] // chunk, chunk
    dtf = dtp.to(acc).reshape(B, nc, Q, H)
    xdt = xp.to(acc).reshape(B, nc, Q, H, P) * dtf[..., None]
    Bf = Bp.to(acc).reshape(B, nc, Q, N)
    Cf = Cp.to(acc).reshape(B, nc, Q, N)
    cum = torch.cumsum(dtf * A.to(acc), dim=2)             # (B,nc,Q,H)
    total = cum[:, :, -1]                                   # (B,nc,H)
    # intra-chunk: (exp(cum_i - cum_j) masked to i >= j) * C_i.B_j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Qi,Qj,H)
    live = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # masked before the exp: above the diagonal seg is positive and its exp
    # can overflow, which a mask after it would turn into a NaN gradient
    L = torch.exp(torch.where(live[:, :, None], seg, -math.inf))
    scores = torch.einsum("bcin,bcjn->bcij", Cf, Bf)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", L * scores[..., None], xdt)
    decay_in = torch.exp(cum)
    decay_out = torch.exp(total[:, :, None, :] - cum)
    state = (torch.zeros((B, H, P, N), dtype=acc, device=x.device)
             if init_state is None else init_state.to(acc))
    ys = []
    for c in range(nc):
        y_off = torch.einsum("bqhn,bhpn->bqhp",
                             Cf[:, c, :, None, :] * decay_in[:, c, ..., None],
                             state)
        ys.append(y_diag[:, c] + y_off)
        contrib = torch.einsum("bqhp,bqhn->bhpn", xdt[:, c],
                               Bf[:, c, :, None, :]
                               * decay_out[:, c, ..., None])
        state = state * torch.exp(total[:, c])[..., None, None] + contrib
    y = (torch.stack(ys, dim=1).reshape(B, nc * Q, H, P) if ys
         else torch.zeros((B, 0, H, P), dtype=acc, device=x.device))
    return y[:, :S].to(x.dtype), state


def _check(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
           init_state: Optional[torch.Tensor]) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 \
            or Bm.shape != Cm.shape:
        raise ValueError(f"ssd_scan wants x (B,S,H,P), dt (B,S,H), A (H,) "
                         f"and Bm/Cm (B,S,N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape[:2] != (B, S):
        raise ValueError(f"ssd_scan: incompatible x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm/Cm "
                         f"{tuple(Bm.shape)}")
    if P not in HEAD_DIMS or N not in STATE_DIMS or chunk not in CHUNKS:
        raise ValueError(f"ssd_scan kernel takes head dims {HEAD_DIMS}, "
                         f"state dims {STATE_DIMS} and chunks {CHUNKS}, got "
                         f"P={P}, N={N}, chunk={chunk}")
    for t in (x, dt, Bm, Cm):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("ssd_scan: x, dt, Bm, Cm must share device "
                             "and dtype")
        if t.dtype not in DTYPES:
            raise ValueError(f"ssd_scan kernel takes {DTYPES}, got "
                             f"{t.dtype}")
    want = {"A": (A, (H,))}
    if init_state is not None:
        want["init_state"] = (init_state, (B, H, P, N))
    for name, (t, shape) in want.items():
        if t.shape != shape or t.dtype != f32 or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} must be a float32 {shape} "
                             f"tensor on {x.device}")
    for t in (x, dt, A, Bm, Cm) + (() if init_state is None
                                   else (init_state,)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("ssd_scan kernel needs contiguous, 16-byte "
                             "aligned tensors")


class SSDScanFn(torch.autograd.Function):
    """The scan with a gradient: ``forward(x, dt, A, Bm, Cm, init_state,
    chunk)`` (the kernel launch on the card) and a backward that recomputes
    ``ssd_scan_ref`` on the saved inputs under autograd.  Either output's
    gradient may be None: training discards the final state.  The tests'
    gradient checks pass the plain version as ``forward``."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk: int, forward):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk = chunk
        return forward(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)

    @staticmethod
    def backward(ctx, gy, gstate):
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad[:6])]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        given = [i for i, g in enumerate((gy, gstate)) if g is not None]
        if not given:
            return (None,) * 8
        with torch.enable_grad():
            outs = ssd_scan_ref(*inputs[:5], ctx.chunk,
                                init_state=inputs[5])
            got = iter(torch.autograd.grad(
                [outs[i] for i in given], wanted,
                [(gy, gstate)[i] for i in given], allow_unused=True))
        return tuple(next(got) if t is not None and t.requires_grad
                     else None for t in inputs) + (None, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N) -> (y (B,S,H,P),
    final state (B,H,P,N) float32).  CPU and meta tensors: the plain
    version; CUDA tensors: the kernel, inside :class:`SSDScanFn` when a
    gradient is to be carried."""
    if x.device.type in PLAIN_DEVICES:
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk,
                              init_state=init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init_state)):
        return SSDScanFn.apply(x, dt, A, Bm, Cm, init_state, chunk, _launch)
    return _launch(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)


def _launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
            init_state: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors; counts the launch."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu, meta or cuda tensors, got "
                         f"{x.device}")
    _check(x, dt, A, Bm, Cm, chunk, init_state)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    xp, dtp, Bp, Cp = _pad_to_chunk(x, dt, Bm, Cm, chunk)
    y = torch.empty_like(xp)
    st = torch.empty((B, H, P, N), dtype=f32, device=x.device)
    if B * H == 0:
        return y[:, :S], st
    bf16 = x.dtype == torch.bfloat16
    R, per = (ssd_plan(B, H, xp.shape[1], KERNEL_CHUNK, sm_count(x.device))
              if bf16 else (1, 1))
    fn = _build.launcher("ssd_scan", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xp.data_ptr(), dtp.data_ptr(), A.data_ptr(), Bp.data_ptr(),
                 Cp.data_ptr(),
                 None if init_state is None else init_state.data_ptr(),
                 y.data_ptr(), st.data_ptr(), int(bf16), B, xp.shape[1], H,
                 P, N, chunk, R, per, stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed (error {err}) at "
                           f"x {tuple(x.shape)}, N {N}, chunk {chunk}, "
                           f"{x.dtype}, {R} ranks of {per} chunks")
    ssd_scan.launches += 1
    return y[:, :S], st


ssd_scan.launches = 0
