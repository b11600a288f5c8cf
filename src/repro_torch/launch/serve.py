"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``

Port of ``src/repro/launch/serve.py`` for the data plane that exists so
far: one served model under continuous batching.  ``serve`` calibrates a
``ContinuousTorchExecutor`` (kernel build, weights, every bucket timed),
then drives seeded Poisson arrivals through ``SimEnv`` +
``ContinuousBatcher``.  The measured wall seconds of every join and step
advance the simulated clock, as in the JAX package's batched backend, so
latencies are device time as the requests would have seen it.  No LBS/SGS
stands in front: serving under Archipelago's scheduler goes through
``sim.simulate`` with ``backend="torch-batched"`` (README).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..core.batching import ContinuousBatcher
from ..core.types import DagSpec, FunctionSpec, Invocation, Request
from ..device import DeviceLike, device_name, resolve_device
from ..kernels import ops as kernel_ops
from ..models.config import ModelConfig
from ..serving.executor import ContinuousTorchExecutor, ServedModel
from ..sim.engine import SimEnv

FN = "generate"


def serve(cfg: ModelConfig, *, n_requests: int, rps: Optional[float],
          prompt_len: int, gen_len: int, max_batch: int,
          device: DeviceLike = None, seed: int = 0) -> Dict[str, Any]:
    """Serve ``n_requests`` greedy generations of ``cfg`` and report.

    Arrivals are Poisson at ``rps`` requests per second of the simulated
    clock.  ``rps=None`` takes the rate from calibration: the rate at which
    three quarters of ``max_batch`` requests would be resident on average
    (arrival rate times one request's residency, prefill plus ``gen_len``
    steps at the full bucket).  The report gives, on the simulated clock,
    each request's latency to its last token, its time to first token and
    the mean gap between its later tokens, as medians and p99."""
    dev = resolve_device(device)
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    ex = ContinuousTorchExecutor(
        {FN: ServedModel(cfg, prompt_len=prompt_len, gen_len=gen_len)},
        max_batch=max_batch, device=dev, seed=seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    spec = ex.calibrate()[FN]
    calibrate_s = time.perf_counter() - t0
    cap = ex.buckets()[-1]
    residency = (ex.bucket_admit_s[(FN, 1)]
                 + gen_len * ex.bucket_step_s[(FN, cap)])
    if rps is None:
        rps = 0.75 * max_batch / residency
    if rps <= 0:
        raise ValueError(f"rps must be positive, got {rps}")

    env = SimEnv()
    dag = DagSpec(cfg.name, (FunctionSpec(FN, exec_time=spec.exec_time,
                                          setup_time=spec.setup_time),))
    slot_owner: Dict[int, int] = {}
    tokens: Dict[int, list] = {}
    first_at: Dict[int, float] = {}     # sim time of each first token

    def admit(fn, invs, slots):
        dur = ex.admit(fn, invs, slots)
        for inv, tok in zip(invs, ex.last_tokens(fn, slots)):
            tokens[inv.inv_id] = [tok]
            first_at[inv.inv_id] = env.now() + dur
        slot_owner.update(zip(slots, (inv.inv_id for inv in invs)))
        return dur

    def step(fn, slots):
        dur = ex.step(fn, slots)
        for s, tok in zip(slots, ex.last_tokens(fn, slots)):
            tokens[slot_owner[s]].append(tok)
        return dur

    batcher = ContinuousBatcher(env, admit, step, ex.gen_steps,
                                max_batch=max_batch,
                                release=ex.release_slots)
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rps, n_requests))
    invs = []
    done_at: Dict[int, float] = {}
    for t in arrivals:
        req = Request(dag=dag, arrival_time=float(t))
        inv = Invocation(request=req, fn=dag.fn(FN), ready_time=float(t))
        invs.append(inv)
        env.call_at(float(t), batcher.submit, inv,
                    lambda exec_s, i=inv.inv_id: done_at.__setitem__(
                        i, env.now()))
    launches0 = kernel_ops.launch_counts()
    w0 = time.perf_counter()
    env.run()
    wall_s = time.perf_counter() - w0
    launches = {k: v - launches0[k]
                for k, v in kernel_ops.launch_counts().items()}

    done = [i for i in invs if i.inv_id in done_at]
    lat = np.array([done_at[i.inv_id] - i.request.arrival_time
                    for i in done])
    ttft = np.array([first_at[i.inv_id] - i.request.arrival_time
                     for i in done])
    # mean gap between a request's output tokens after the first
    gap = np.array([(done_at[i.inv_id] - first_at[i.inv_id]) / gen_len
                    for i in done]) if gen_len else np.array([])

    def pct(a, q):
        return float(np.percentile(a, q)) if len(a) else None

    counters = batcher.counters()
    n_tokens = sum(len(tokens.get(i.inv_id, ())) for i in invs)
    span = env.now() - float(arrivals[0])
    out = {
        "model": cfg.name, "n_layers": cfg.n_layers,
        "device": dev.type, "device_name": device_name(dev),
        "n_requests": n_requests, "completed": len(done_at),
        "rps": rps, "prompt_len": prompt_len, "gen_len": gen_len,
        "max_batch": max_batch,
        "latency_p50_s": pct(lat, 50), "latency_p99_s": pct(lat, 99),
        "ttft_p50_s": pct(ttft, 50), "ttft_p99_s": pct(ttft, 99),
        "token_gap_p50_s": pct(gap, 50), "token_gap_p99_s": pct(gap, 99),
        "tokens": [tokens.get(i.inv_id, []) for i in invs],
        "tokens_per_s": n_tokens / span if span > 0 else None,
        "mean_decode_occupancy": (counters["n_step_slots"]
                                  / counters["n_decode_ticks"]
                                  if counters["n_decode_ticks"] else 0.0),
        "batcher": counters,
        "bucket_admit_ms": {b: ex.bucket_admit_s[(FN, b)] * 1e3
                            for b in ex.buckets()},
        "bucket_step_ms": {b: ex.bucket_step_s[(FN, b)] * 1e3
                           for b in ex.buckets()},
        "kernel_launches": launches,
        "executor": {"n_admits": ex.n_admits, "n_steps": ex.n_steps},
        "logits_finite": ex.logits_finite(FN),
        "setup_s": spec.setup_time, "build_s": ex.build_seconds,
        "calibrate_s": calibrate_s, "sim_s": span, "wall_s": wall_s,
    }
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b", choices=ARCH_IDS)
    ap.add_argument("--rps", type=float, default=None,
                    help="Poisson arrival rate (requests per simulated "
                         "second); default: derived from calibration")
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    rep = serve(get_config(args.arch, reduced=True),
                n_requests=args.requests, rps=args.rps,
                prompt_len=args.prompt, gen_len=args.gen,
                max_batch=args.max_batch, device=args.device)
    rep.pop("tokens")
    print(json.dumps(rep, indent=1, default=str))


if __name__ == "__main__":
    main()
