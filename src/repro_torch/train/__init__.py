"""Training substrate: optimizer, schedules, data pipeline, checkpointing,
and the canonical train_step used by the launcher.

Port of ``src/repro/train``, with its ``__all__`` and the compiled step
(``CompiledTrainStep``, the counterpart of ``jax.jit(make_train_step)``)."""
from .optim import (AdamWState, adamw_init, adamw_update, cosine_schedule,
                    make_schedule, wsd_schedule)
from .data import DataConfig, Prefetcher, SyntheticLM
from . import checkpoint
from .steps import CompiledTrainStep, make_train_step

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "make_schedule", "wsd_schedule", "DataConfig", "Prefetcher",
           "SyntheticLM", "checkpoint", "make_train_step",
           "CompiledTrainStep"]
