"""End-to-end training driver on the PyTorch port: a ~100M-parameter
MiniCPM-family model trained for a few hundred steps on the synthetic
Markov-Zipf pipeline with the WSD schedule, gradient clipping, and
checkpointing.  The twin of ``examples/train_small.py``: as that one takes
``jax.jit`` of the step, this one takes the compiled step
(``CompiledTrainStep``: on the card the first step is captured as a CUDA
graph and every later one replays it).  It runs on the card unless
``--device cpu`` is given (and raises without CUDA).

    python examples/train_small_torch.py [--steps 300] [--device cpu]
(works after `pip install -e .` or with PYTHONPATH=src)
"""
import argparse
import os
import sys
import time

try:
    import repro_torch  # noqa: F401
except ImportError:  # no editable install: fall back to the checkout layout
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.device import device_name, resolve_device
from repro_torch.models import init_params
from repro_torch.train import (CompiledTrainStep, DataConfig, Prefetcher,
                               SyntheticLM, adamw_init, checkpoint)
from repro_torch.train.tree import leaves

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(ROOT, "build",
                                                   "train_small_ckpt"))
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # ~100M params: minicpm family scaled (d=768, 10 layers, 32k vocab)
    cfg = get_config("minicpm-2b").with_(
        n_layers=10, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=2048, vocab_size=32000, param_dtype="float32",
        compute_dtype="float32")
    n = cfg.param_count()
    print(f"model: {cfg.name}-small  params={n/1e6:.1f}M  "
          f"schedule={cfg.lr_schedule}  device={device_name(device)}")

    params = init_params(cfg, 0, device)
    opt = adamw_init(params)
    # updates params and opt in place
    step_fn = CompiledTrainStep(cfg, params, opt, args.batch, args.seq,
                                total_steps=args.steps, peak_lr=1e-3)

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, batch_size=args.batch))
    it = Prefetcher(data.iterate())

    t0 = time.time()
    first = last = None
    for step in range(args.steps):
        loss = step_fn(next(it))
        if step == 0:
            first = float(loss)
        if step % 25 == 0 or step == args.steps - 1:
            last = float(loss)
            tps = args.batch * args.seq * (step + 1) / (time.time() - t0)
            print(f"step {step:4d}  loss {last:7.4f}  tok/s {tps:,.0f}")
    it.close()

    checkpoint.save(args.ckpt, args.steps, params, opt)
    p2, o2 = checkpoint.restore(args.ckpt, args.steps, params, opt)
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(params), leaves(p2)))
    print(f"checkpoint round-trip OK at {args.ckpt}")
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    assert last < first, "training must reduce loss"
    print("OK")


if __name__ == "__main__":
    main()
