"""Loss trajectories of a train step, JAX package or port, on the same
weights and batches.

    python3 tools/train_trajectory.py --impl jax --arch minicpm-2b \\
        --layers 2 --lr 3e-4 5e-5 --init INIT
    python3 tools/train_trajectory.py --impl torch --device cpu \\
        --arch minicpm-2b --layers 2 --lr 3e-4 5e-5 --init INIT

The published config (full width, the published dtypes) cut to
``--layers``.  ``--impl jax`` draws the weights from ``PRNGKey(0)`` and,
with ``--init``, saves them there in the JAX package's checkpoint format;
``--impl torch`` restores them from ``--init`` (the two formats
cross-load), or without it draws the port's own (seed 0, on the CPU, then
moved to ``--device``), so that the card and the CPU start from the same
weights.  Each peak learning rate trains afresh from those weights for
``--steps`` steps of the compiled ``make_train_step`` (the config's
schedule over the run) on ``SyntheticLM`` batch ``i`` at step ``i``:
``jax.jit`` of it in the JAX package, ``CompiledTrainStep`` in the port
(a CUDA graph on the card).  One process imports only one of the two
packages.  It prints one JSON line per learning rate: the losses and each
step's seconds, the first holding the compile (JAX) or the warm-up and
the capture (the port).
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def run_jax(args) -> None:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import init_params
    from repro.train import (DataConfig, SyntheticLM, adamw_init, checkpoint,
                             make_train_step)
    cfg = get_config(args.arch).with_(n_layers=args.layers)
    init = init_params(cfg, jax.random.PRNGKey(0))
    if args.init:
        checkpoint.save(args.init, 0, init)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=max(args.seq, cfg.ssm_chunk or 1),
                                  batch_size=args.batch))
    for lr in args.lr:
        step_fn = jax.jit(make_train_step(cfg, total_steps=args.steps,
                                          peak_lr=lr))
        params, opt, losses, secs = init, adamw_init(init), [], []
        for i in range(args.steps):
            t0 = time.perf_counter()
            params, opt, loss = step_fn(params, opt,
                                        jnp.asarray(data.batch(i)))
            losses.append(float(loss))
            secs.append(time.perf_counter() - t0)
        report(args, cfg, lr, losses, secs, "cpu (jax)")


def run_torch(args) -> None:
    from repro_torch.configs import get_config
    from repro_torch.device import device_name, resolve_device
    from repro_torch.models import init_params
    from repro_torch.train import (CompiledTrainStep, DataConfig,
                                   SyntheticLM, adamw_init, checkpoint)
    from repro_torch.train.tree import map_with_path
    dev = resolve_device(args.device)
    cfg = get_config(args.arch).with_(n_layers=args.layers)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=max(args.seq, cfg.ssm_chunk or 1),
                                  batch_size=args.batch))
    for lr in args.lr:
        params = init_params(cfg, 0, "cpu")
        if args.init:
            params, _ = checkpoint.restore(args.init, 0, params)
        params = map_with_path(lambda _, t: t.to(dev), params)
        opt, losses, secs = adamw_init(params), [], []
        step_fn = CompiledTrainStep(cfg, params, opt, data.cfg.batch_size,
                                    data.cfg.seq_len, total_steps=args.steps,
                                    peak_lr=lr)
        for i in range(args.steps):
            t0 = time.perf_counter()
            losses.append(float(step_fn(data.batch(i))))
            secs.append(time.perf_counter() - t0)
        report(args, cfg, lr, losses, secs, device_name(dev))
        del params, opt, step_fn


def report(args, cfg, lr, losses, secs, device) -> None:
    print(json.dumps({"impl": args.impl, "device": device, "arch": cfg.name,
                      "layers": cfg.n_layers, "batch": args.batch,
                      "seq": max(args.seq, cfg.ssm_chunk or 1),
                      "dtype": cfg.param_dtype, "lr": lr,
                      "schedule": cfg.lr_schedule, "losses": losses,
                      "step_s": secs}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, nargs="+", default=[3e-4])
    ap.add_argument("--init", default="",
                    help="jax: save its initial weights here; torch: start "
                         "from the weights saved here")
    ap.add_argument("--device", default=None,
                    help="torch only: cuda (default) or cpu")
    args = ap.parse_args()
    (run_jax if args.impl == "jax" else run_torch)(args)


if __name__ == "__main__":
    main()
