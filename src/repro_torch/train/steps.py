"""The canonical train step: loss, gradients and AdamW.

Port of ``src/repro/train/steps.py`` (``make_train_step``).  Autograd takes
the place of ``jax.value_and_grad``; ``torch.utils.checkpoint`` takes the
place of ``jax.checkpoint`` inside the model (``cfg.remat``).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..models import lm_loss
from ..models.config import ModelConfig
from ..models.spmd import settled
from .optim import AdamWState, adamw_update, make_schedule
from .tree import leaves_with_paths, unflatten_like


def make_train_step(cfg: ModelConfig, total_steps: int = 10_000,
                    peak_lr: float = 3e-4,
                    ) -> Callable[..., Tuple[Any, AdamWState, torch.Tensor]]:
    """Returns train_step(params, opt_state, tokens[, frontend]) ->
    (params, opt_state, loss).

    The step marks every parameter leaf as requiring a gradient, updates
    the parameters and moments in place (``adamw_update``) and returns
    them.  It raises if a leaf gets no gradient: a kernel whose output
    carries none would otherwise leave the weights in front of it
    untrained, without an error."""
    sched = make_schedule(cfg.lr_schedule, peak_lr, total_steps)

    def train_step(params: Any, opt_state: AdamWState, tokens: torch.Tensor,
                   frontend: Optional[torch.Tensor] = None,
                   ) -> Tuple[Any, AdamWState, torch.Tensor]:
        paths, flat = zip(*leaves_with_paths(params))
        for p in flat:
            p.requires_grad_(True)
        loss = lm_loss(cfg, params, tokens, frontend)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        missing = ["/".join(path) for path, g in zip(paths, grads)
                   if g is None]
        if missing:
            raise RuntimeError(f"{cfg.name}: no gradient reached "
                               f"{len(missing)} parameter leaves: "
                               f"{missing[:8]}")
        # on a mesh, a whole leaf's gradient may still be a pending sum
        # over the rows (spmd.products): reduce it once, here
        grads = [settled(g) for g in grads]
        lr = sched(opt_state.step + 1)
        params, opt_state = adamw_update(unflatten_like(params, list(grads)),
                                         opt_state, params, lr=lr)
        return params, opt_state, loss.detach()

    return train_step
