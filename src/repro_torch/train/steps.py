"""The canonical train step: loss, gradients and AdamW.

Port of ``src/repro/train/steps.py`` (``make_train_step``).  Autograd takes
the place of ``jax.value_and_grad``; ``torch.utils.checkpoint`` takes the
place of ``jax.checkpoint`` inside the model (``cfg.remat``).

:class:`CompiledTrainStep` is the counterpart of the reference launcher's
``jax.jit(make_train_step(...))`` (``src/repro/launch/train.py:40``): the
step as one program over static buffers (``serving.graphs``), captured on
the card as a CUDA graph at its first call and replayed on every later one.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..models import lm_loss
from ..models.config import ModelConfig
from ..models.spmd import settled
from ..serving.graphs import ProgramSet
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


class CompiledTrainStep:
    """``make_train_step``'s step over ``params`` and ``opt`` for one batch
    shape, as one program: ``step(tokens) -> loss``, ``tokens`` a (batch,
    seq) integer array on the host.

    The parameters and moments are updated in place (``adamw_update``),
    and the body writes the new step counter back into ``opt.step``, from
    which the schedule reads the learning rate on the device: every tensor
    the step reads or writes has one address for good.  The batch is
    staged through pinned host memory into a static (batch, seq) int64
    input; ``frontend`` (a frontend model's embeddings) is a static input.

    The first call is the first real step and, as ``jax.jit``'s first call
    compiles, it also compiles: it stages the batch, runs the body eagerly
    on the programs' side stream (the warm-up; its launches count) and, on
    the card, captures it as a CUDA graph (``capture_seconds``), which
    executes nothing.  It returns the warm-up's loss.  Every later call is
    one replay.  Off the card nothing is captured: every call runs the
    body through the same static buffers.  A capture or a replay that
    fails raises, and so does every call after a failed capture: nothing
    falls back to the eager body.

    The loss returned, and ``lr``, are the program's output buffers, which
    the next step overwrites: read them before then."""

    def __init__(self, cfg: ModelConfig, params: Any, opt: AdamWState,
                 batch: int, seq: int,
                 frontend: Optional[torch.Tensor] = None, *,
                 total_steps: int = 10_000, peak_lr: float = 3e-4):
        step = make_train_step(cfg, total_steps=total_steps,
                               peak_lr=peak_lr)
        sched = make_schedule(cfg.lr_schedule, peak_lr, total_steps)

        def body(tokens: torch.Tensor,
                 frontend: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
            _, new, loss = step(params, opt, tokens, frontend)
            opt.step.copy_(new.step)
            return loss, sched(opt.step)

        device = opt.step.device
        inputs = {"tokens": torch.zeros((batch, seq), dtype=torch.long,
                                        device=device)}
        if frontend is not None:
            inputs["frontend"] = frontend
        self.programs = ProgramSet(device)
        self.program = self.programs.add(body, inputs, host=("tokens",))
        self.compiled = False
        self.capture_seconds = 0.0

    @property
    def lr(self) -> torch.Tensor:
        """The learning rate of the last step (a device scalar)."""
        return self.program.outputs[1]

    def __call__(self, tokens: np.ndarray) -> torch.Tensor:
        prog = self.program
        if self.compiled:
            if prog.graph is None and self.programs.graph is not None:
                raise RuntimeError("the training step's first call (its "
                                   "warm-up and capture) failed; it does "
                                   "not run eagerly instead")
            return prog(tokens=tokens)[0]
        self.compiled = True
        prog.stage(tokens=tokens)
        with self.programs.side_stream():
            warm = prog.warm_up()
        if self.programs.stream is not None:
            torch.cuda.synchronize(self.programs.device)  # the warm-up's end
        t0 = time.perf_counter()
        self.programs.capture()
        self.capture_seconds = time.perf_counter() - t0
        # the captured outputs hold nothing yet: the warm-up's values
        for out, value in zip(prog.outputs, warm):
            out.copy_(value)
        return prog.outputs[0]
