"""Optimizers and LR schedules (no external deps).

Port of ``src/repro/train/optim.py``, with its numerics: the moments are
float32 whatever the parameter dtype, the global norm is taken over every
gradient in float32, bias correction raises to the step as a float32 value,
weight decay is decoupled, the new parameter is cast back to its dtype, and
the schedules compute in float32 from the step.  ``torch.optim.AdamW`` keeps
its moments in the parameter's dtype and ``clip_grad_norm_`` divides by
``norm + 1e-6``, so neither is used.

Includes the WSD (warmup-stable-decay) schedule MiniCPM introduced
[arXiv:2404.06395] alongside the standard cosine schedule.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Sequence, Tuple, Union

import torch

from .tree import leaves, map_with_path

f32 = torch.float32
Step = Union[int, torch.Tensor]


def sum_of_squares(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sum(torch.sum(torch.square(t.float())) for t in ts)`` (the
    squared global norm of gradient clipping).  On ``DTensor``s each rank
    sums its own shards, the tensors split over the same mesh dims
    together, and one all-reduce over those dims per such set gives the
    total: left to DTensor, the number of reductions differs between torch
    versions (the dry-run's counts, ``launch/dryrun.py``)."""
    meshes = [t.device_mesh for t in ts if hasattr(t, "device_mesh")]
    if not meshes:
        return sum(torch.sum(torch.square(t.to(f32))) for t in ts)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, whole = meshes[0], [Replicate()] * meshes[0].ndim
    groups = {}
    for t in ts:
        if any(p.is_partial() for p in t.placements):
            t = t.redistribute(mesh, [Replicate() if p.is_partial() else p
                                      for p in t.placements])
        split = tuple(i for i, p in enumerate(t.placements) if p.is_shard())
        local = torch.sum(torch.square(t.to_local().to(f32)))
        groups[split] = local if split not in groups \
            else groups[split] + local
    total = None
    for split, local in groups.items():
        part = DTensor.from_local(
            local, mesh, [Partial() if i in split else Replicate()
                          for i in range(mesh.ndim)], run_check=False)
        part = part.redistribute(mesh, whole)
        total = part if total is None else total + part
    return total


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar: updates applied so far
    mu: Any                 # float32 first moments, shaped as the params
    nu: Any                 # float32 second moments


def adamw_init(params: Any) -> AdamWState:
    """Zero moments in float32 beside each parameter, step 0 on the
    parameters' device."""
    zeros = lambda _, p: torch.zeros_like(p, dtype=f32)  # noqa: E731
    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=map_with_path(zeros, params),
                      nu=map_with_path(zeros, params))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, *,
                 lr: Union[float, torch.Tensor], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0
                 ) -> Tuple[Any, AdamWState]:
    """Returns (new_params, new_state).  Global-norm clipping + decoupled WD.

    Unlike the JAX package's, the update is in place: each parameter and
    each moment is overwritten, and the trees returned are the ones passed
    in (a step of minicpm-2b holds 22 GB of float32 moments, which a second
    copy would double)."""
    flat_g, flat_p = leaves(grads), leaves(params)
    flat_m, flat_v = leaves(state.mu), leaves(state.nu)
    if not len(flat_g) == len(flat_p) == len(flat_m) == len(flat_v):
        raise ValueError(f"adamw_update: {len(flat_g)} gradients, "
                         f"{len(flat_p)} parameters, {len(flat_m)} / "
                         f"{len(flat_v)} moments")
    gnorm = torch.sqrt(sum_of_squares(flat_g))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    t = step.to(f32)
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        g = g.to(f32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p32 = p.to(f32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
            + weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------


def _f32(step: Step) -> torch.Tensor:
    return torch.as_tensor(step).to(f32)


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int,
                 floor_frac: float = 0.1) -> Callable[[Step], torch.Tensor]:
    """Warmup-Stable-Decay (MiniCPM): linear warmup, flat plateau, then
    exponential-style decay to floor_frac * peak."""

    def sched(step: Step) -> torch.Tensor:
        s = _f32(step)
        wu = peak_lr * torch.clamp(s / max(1, warmup), max=1.0)
        in_decay = torch.clamp((s - warmup - stable) / max(1, decay),
                               0.0, 1.0)
        decay_mult = (1.0 - in_decay) + floor_frac * in_decay
        return torch.where(s <= warmup + stable, wu, peak_lr * decay_mult)

    return sched


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable[[Step], torch.Tensor]:
    def sched(step: Step) -> torch.Tensor:
        s = _f32(step)
        wu = peak_lr * torch.clamp(s / max(1, warmup), max=1.0)
        prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = floor_frac + (1 - floor_frac) * 0.5 \
            * (1 + torch.cos(math.pi * prog))
        return torch.where(s <= warmup, wu, peak_lr * cos)

    return sched


def make_schedule(kind: str, peak_lr: float, total_steps: int
                  ) -> Callable[[Step], torch.Tensor]:
    warmup = max(1, total_steps // 20)
    if kind == "wsd":
        decay = max(1, total_steps // 10)
        return wsd_schedule(peak_lr, warmup, total_steps - warmup - decay,
                            decay)
    return cosine_schedule(peak_lr, warmup, total_steps)
