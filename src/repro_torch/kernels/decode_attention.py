"""Flash-decoding: the hand-written CUDA kernel ``csrc/decode_attention.cu``
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py``
(``decode_attention``, body ``_dec_kernel``).  :func:`decode_attention`
picks the implementation from the device of its inputs: CPU and meta
tensors go to :func:`decode_attention_plain`, CUDA tensors launch the
kernel or raise.  The kernel has two bodies, and :func:`decode_instance`
names the one a launch runs: the tensor cores for bf16 at hd 256, at hd
128 with 2 to 8 query heads a KV head (minitron-8b, llama4-scout) and at
hd 64 and 96 with up to 8 (minicpm-2b, zamba2-1.2b, whisper-tiny; phi-3),
split by :func:`split_plan_tc`; the CUDA cores for the rest, split by
:func:`split_plan`: float32, and bf16 at shapes no published config
decodes at.
``decode_attention.launches`` counts kernel launches.

A row with ``valid_len = 0`` attends to nothing and comes out as zeros, as
the Pallas kernel's does; the JAX oracle ``ref.decode_attention_ref``
returns the mean of V there instead, and the plain version here follows the
kernel.

Beyond the Pallas kernel's contract, ``rows`` (B,) int32 lets query row b
attend over cache row ``rows[b]`` of k/v (R, L, Hkv, hd): a serving step
decodes against its slab of R slots in place, through the slot ids,
instead of a gathered copy.  The launch's plan is the one of B rows, so it
reads the bytes a compact launch reads.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from ..device import sm_count
from .ref import PLAIN_DEVICES, decode_attention_ref

HEAD_DIMS = (32, 64, 72, 96, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)
# pointers, then ints, then the stream: the C launcher's parameters
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
MAX_GROUP_WIDTH = 1024      # G * hd: the kernel's per-lane registers
SPLIT_TILE = 32             # the kernel's keys per tile
MAX_SPLIT = 8               # CTAs per cluster that every Hopper card takes
CTAS_PER_SM = 4             # a one-cluster plan aims at this many per SM
MAX_CTAS = 1024             # CTAs per (b, KV head) past one cluster
MIN_CHUNK = 4 * SPLIT_TILE  # keys per CTA at least, past one cluster
MAX_GROUP = 32              # partials one ticket combine reads (the kernel's)
TICKET_HEAD_DIMS = (256,)   # instances that combine by tickets at any plan
TC_MIN_CHUNK = 256          # keys per CTA at least on the hd 128 tensor cores
TC96_MIN_CHUNK = 1024       # keys per CTA at least on the hd 96 tensor cores
# bf16 head dims on the tensor cores, with the query heads a KV head there
TENSOR_CORE_GROUPS = {64: range(1, 9), 96: range(1, 9), 128: range(2, 9),
                      256: range(1, 5)}


def decode_instance(hd: int, G: int, dtype: torch.dtype) -> str:
    """Which of the kernel's two bodies a launch at head dim ``hd`` with
    ``G`` query heads a KV head runs: ``"tensor_cores"`` (``dec_kernel_tc``,
    ``mma.sync`` on TMA-loaded 16-key blocks) for bf16 at hd 256, at hd 128
    with 2 <= G <= 8 and at hd 64 and 96 with G <= 8, where the CUDA cores'
    per-score shuffle reductions cost more than the loads (at hd 64 and 96
    even G = 1, whose mma leaves 7 of its 8 head columns empty: that costs
    issue slots, not bytes); else ``"cuda_cores"`` (``dec_kernel``):
    float32, whose tolerance needs full-f32 products, and bf16 where no
    published config decodes: hd 32 and 72, hd 128 at G = 1, hd 64 and 96
    past G = 8.  Every published bf16 config decodes on the tensor cores.
    The wrapper passes the choice to the C launcher, which launches that
    body or refuses: this function alone decides."""
    if dtype == torch.bfloat16 and G in TENSOR_CORE_GROUPS.get(hd, ()):
        return "tensor_cores"
    return "cuda_cores"


def split_plan(B: int, Hkv: int, L: int, sm_count: int) -> Tuple[int, int]:
    """How the kernel splits the cache: ``(n_split, chunk)``.  Split ``s`` of
    every (b, KV head) covers keys ``[s * chunk, min((s + 1) * chunk, L))``;
    the ranges are contiguous, cover ``[0, L)`` and are none of them empty.

    Up to ``MAX_SPLIT`` ranges (one thread-block cluster), ``chunk`` a whole
    number of the kernel's 32-key tiles, aiming at ``CTAS_PER_SM`` CTAs per
    SM over the ``B * Hkv * n_split`` CTAs, so that batch 1 fills the card
    as batch 8 does.  Where even one CTA per SM gives each (b, KV head) more
    than ``MAX_SPLIT`` (one KV head at batch 1: gemma3-1b) and the cache is
    long enough for more than ``MAX_SPLIT`` ranges of ``MIN_CHUNK`` keys,
    the cache is cut into ``ceil(L / chunk)`` ranges of ``chunk =
    max(MIN_CHUNK, ceil(L / (sm_count // (B * Hkv))))`` keys (at most
    ``MAX_CTAS``): about one CTA per SM in one wave, at least one per SM
    once ``L > t * (t - 1)`` for ``t = sm_count // (B * Hkv)``.  Such
    ranges need not be whole tiles; the kernel combines them by tickets
    (:func:`split_groups`)."""
    tiles = max(1, -(-L // SPLIT_TILE))
    want = -(-CTAS_PER_SM * sm_count // max(1, B * Hkv))
    n = max(1, min(MAX_SPLIT, want, tiles))
    chunk = -(-tiles // n) * SPLIT_TILE
    one_wave = min(MAX_CTAS, sm_count // max(1, B * Hkv))
    if one_wave > MAX_SPLIT:
        wide = max(MIN_CHUNK, -(-L // one_wave))
        if -(-L // wide) > MAX_SPLIT:
            chunk = wide
    return max(1, -(-L // chunk)), chunk


def split_plan_tc(B: int, Hkv: int, L: int, sm_count: int,
                  hd: int = 128) -> Tuple[int, int]:
    """The plan of the tensor-core body at hd 64, 96 and 128
    (:func:`decode_instance`):
    ``(n_split, chunk)`` as :func:`split_plan` gives them, ranges of whole
    32-key tiles, but at most one CTA per SM over ``B * Hkv * n_split``, at
    most ``MAX_SPLIT`` ranges (one cluster), and no more ranges than
    ``ceil(L / TC_MIN_CHUNK)``, so that each of several holds more than
    ``TC_MIN_CHUNK / 2`` keys: more than one 16-key block a warp, which
    then streams through two stages.  A warp there scores a block in
    less time than its stage takes to refill, so fewer and longer ranges
    stream as fast and pay fewer prologues and combines: on an H100 at 8
    KV heads, G 6, the kernel took 0.0194 ms at batch 8 over 544 keys in 2
    ranges against 0.0282 in :func:`split_plan`'s 6, and 0.0639–0.0645 ms
    at batch 1 over 32768 keys in 8 ranges against 0.0663–0.0667 in its 16
    (``tools/time_kernels.py --hd128-plans``; PERF.md, section 6).  At hd
    64, G 1, 36 heads the same rule gives 1 range at batch 8 over 544 keys
    (288 CTAs, three an SM) and 3 at batch 1, the fastest of the 1 to 8
    that ``--hd64-plans`` timed there.  At hd 96, where two CTAs fit an
    SM, at most one CTA per two SMs and no more ranges than ``ceil(L /
    TC96_MIN_CHUNK)``: at phi-3's 32 heads fewer, longer ranges were
    faster at every shape ``--hd96-plans`` timed, one range at buckets 8
    to 1 over 544 keys (0.0141 ms at bucket 2 and 0.0116 at batch 1
    against 0.0162 and 0.0129 in 2 and 3 ranges), two at batch 1 over
    4096 keys (0.0326 against 0.0342 in 4) and over 32768 (0.1509 against
    0.1721 in 4)."""
    tiles = max(1, -(-L // SPLIT_TILE))
    sms, min_chunk = ((sm_count // 2, TC96_MIN_CHUNK) if hd == 96
                      else (sm_count, TC_MIN_CHUNK))
    n = max(1, min(MAX_SPLIT, sms // max(1, B * Hkv), -(-L // min_chunk),
                   tiles))
    chunk = -(-tiles // n) * SPLIT_TILE
    return max(1, -(-L // chunk)), chunk


def split_groups(n_split: int, hd: int) -> int:
    """How the kernel combines the ``n_split`` partials of a (b, KV head),
    in either body: 0 for the cluster combine (the CTAs form one
    thread-block cluster, rank 0 reads the others' partials) up to
    ``MAX_SPLIT`` ranges; else the size of the ticket combine's groups of
    consecutive ranges: all of them where there are at most ``MAX_SPLIT``
    (hd 256: on an H100 gemma3-1b's 6 ranges at batch 1 over 544 keys
    took 0.0133-0.0136 ms by tickets against 0.0136-0.0138 over a
    cluster, level at batch 8; ``tools/time_kernels.py --hd256``, PERF.md
    section 6), else
    ``ceil(sqrt(n_split))``, so that the last CTA of a group and the last
    group each read about ``sqrt(n_split)`` partials.  Every sum runs in
    range order."""
    if n_split <= MAX_SPLIT:
        return 0 if hd not in TICKET_HEAD_DIMS else n_split
    return math.isqrt(n_split - 1) + 1


def decode_plan(B: int, Hq: int, Hkv: int, L: int, hd: int,
                dtype: torch.dtype, sm_count: int) -> Tuple[str, int, int,
                                                             int]:
    """The launch a decode at these shapes makes: ``(instance, n_split,
    chunk, group)``, the body (:func:`decode_instance`), its plan
    (:func:`split_plan_tc` for the tensor-core body at hd 64 to 128, else
    :func:`split_plan`) and the combine (:func:`split_groups`)."""
    instance = decode_instance(hd, Hq // Hkv, dtype)
    if instance == "tensor_cores" and hd != 256:
        n_split, chunk = split_plan_tc(B, Hkv, L, sm_count, hd)
    else:
        n_split, chunk = split_plan(B, Hkv, L, sm_count)
    return instance, n_split, chunk, split_groups(n_split, hd)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len: torch.Tensor,
                           rows: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: q (B,Hq,hd), k/v (B,L,Hkv,hd),
    valid_len (B,) -> (B,Hq,hd); rows with valid_len <= 0 are zeros.  With
    ``rows`` (B,), k/v are (R,L,Hkv,hd) and row b reads cache row
    ``rows[b]``."""
    if rows is not None:
        k, v = k.index_select(0, rows), v.index_select(0, rows)
    out = decode_attention_ref(q, k, v, valid_len)
    return torch.where((valid_len > 0)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid_len: torch.Tensor, rows: Optional[torch.Tensor]) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention wants q (B,Hq,hd) and k/v "
                         f"(B,L,Hkv,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, hd = q.shape
    Hkv = k.shape[2]
    if (rows is None and k.shape[0] != B) or k.shape[3] != hd or Hkv == 0 \
            or Hq % Hkv:
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
    if rows is not None and (rows.shape != (B,) or rows.dtype != torch.int32
                             or rows.device != q.device
                             or not rows.is_contiguous()):
        raise ValueError(f"decode_attention: rows must be a contiguous "
                         f"int32 ({B},) tensor on {q.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor,
                     rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,Hq,hd), k/v (B,L,Hkv,hd), valid_len (B,) -> (B,Hq,hd); with
    ``rows`` (B,) int32, k/v are (R,L,Hkv,hd) and row b attends over cache
    row ``rows[b]``, which must lie in [0, R) (the kernel does not check).
    CPU and meta tensors: the plain version; CUDA tensors: the kernel."""
    if q.device.type in PLAIN_DEVICES:
        return decode_attention_plain(q, k, v, valid_len, rows)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu, meta or cuda "
                         f"tensors, got {q.device}")
    _check(q, k, v, valid_len, rows)
    B, Hq, hd = q.shape
    R, L, Hkv = k.shape[0], k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    instance, n_split, chunk, group = decode_plan(
        B, Hq, Hkv, L, hd, q.dtype, sm_count(q.device))
    # the ticket combine's partials: one per CTA, then one per group, of
    # G * (hd + 2) floats (m, l, acc), every slot written before read; then
    # its tickets, one per group and one per (b, KV head), which the C
    # launcher zeroes on the stream: each launch counts in its own
    scratch = None
    if group:
        groups = -(-n_split // group)
        scratch = torch.empty(B * Hkv * ((n_split + groups) * (Hq // Hkv)
                                         * (hd + 2) + groups + 1),
                              dtype=torch.float32, device=q.device)
    fn = _build.launcher("decode_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 valid_len.data_ptr(), out.data_ptr(),
                 0 if scratch is None else scratch.data_ptr(),
                 0 if rows is None else rows.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, R, L, Hq, Hkv, hd,
                 n_split, chunk, group, int(instance == "tensor_cores"),
                 stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed "
                           f"(error {err}) at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype}, {n_split} "
                           f"splits of {chunk} keys, groups of {group}, "
                           f"on the {instance.replace('_', ' ')}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
