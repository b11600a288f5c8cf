"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``

Port of ``src/repro/launch/train.py``: AdamW under the config's schedule
(WSD for minicpm, cosine otherwise) on the ``SyntheticLM`` stream, reduced
configs unless ``--full``, checkpoints every ``--ckpt-every`` steps.  It
runs on the card unless ``--device cpu`` is given, and raises without
CUDA.  Frontend models get zero frame or patch embeddings, as in the JAX
package.  Beside the loss it prints each logged step's milliseconds,
tokens per second and the peak device memory so far.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        --steps 20 --batch 4 --seq 512 --full
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..device import DeviceLike, device_name, resolve_device
from ..models import init_params
from ..models.config import ModelConfig
from ..train import (CompiledTrainStep, DataConfig, Prefetcher,
                     SyntheticLM, adamw_init, checkpoint)


class Trainer:
    """What the launcher trains: the model's weights from seed 0, their
    AdamW state, the data (``seq_len = max(seq, ssm_chunk or 1)``) and
    the compiled step over ``steps`` steps of the schedule
    (``CompiledTrainStep``, as the reference launcher takes
    ``jax.jit(make_train_step(...))``).  ``params`` and ``opt`` are the
    static trees the step updates in place; its first call compiles (on
    the card, a CUDA graph capture), every later one replays."""

    def __init__(self, cfg: ModelConfig, *, steps: int, batch: int,
                 seq: int, lr: float, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = init_params(cfg, 0, self.device)
        self.opt = adamw_init(self.params)
        self.data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=max(seq, cfg.ssm_chunk or 1),
            batch_size=batch))
        self.frontend = None
        if cfg.frontend:
            self.frontend = torch.zeros(
                (batch, cfg.n_frontend_tokens, cfg.d_model),
                dtype=cfg.dtype(), device=self.device)
        self.step_fn = CompiledTrainStep(
            cfg, self.params, self.opt, batch, self.data.cfg.seq_len,
            self.frontend, total_steps=steps, peak_lr=lr)

    @property
    def tokens_per_step(self) -> int:
        return self.data.cfg.batch_size * self.data.cfg.seq_len

    def step(self, batch: np.ndarray) -> Tuple[float, float]:
        """One step on a (B, S) batch: (loss, wall seconds), the clock
        stopped once the loss has reached the host.  The first step's
        seconds hold the compile, as the reference's first step does."""
        t0 = time.perf_counter()
        loss = float(self.step_fn(batch))
        return loss, time.perf_counter() - t0


def _peak(device: torch.device) -> str:
    if device.type != "cuda":
        return "peak memory not measured on the cpu"
    return f"peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="full config; default reduced")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=not args.full)
    if cfg.frontend:
        print(f"note: {args.arch} uses a stub {cfg.frontend} frontend; "
              f"training feeds zero frame/patch embeddings")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tr = Trainer(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, device=device)
    print(f"[train] {cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"schedule={cfg.lr_schedule} steps={args.steps} on "
          f"{device_name(device)}")
    it = Prefetcher(tr.data.iterate())
    t0 = time.time()
    try:
        for step in range(args.steps):
            loss, sec = tr.step(next(it))
            if step % 20 == 0 or step == args.steps - 1:
                print(f"  step {step:4d} loss {loss:.4f} "
                      f"({time.time()-t0:.0f}s; step {sec * 1e3:.1f} ms, "
                      f"{tr.tokens_per_step / sec:,.0f} tokens/s, "
                      f"{_peak(device)})")
            if args.ckpt and (step + 1) % args.ckpt_every == 0:
                checkpoint.save(args.ckpt, step + 1, tr.params, tr.opt)
    finally:
        it.close()
    print("[train] done")


if __name__ == "__main__":
    main()
