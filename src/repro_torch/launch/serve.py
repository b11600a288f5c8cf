"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``

Port of ``src/repro/launch/serve.py``.  The command line runs a
single-tenant Archipelago serving session through the experiment API with
the ``torch`` execution backend: calibrates the model (the kernel build,
then weights, cache, a warm-up, the capture of each bucket's programs and
timed runs: the sandbox set-up cost), pre-warms, then drives Poisson
traffic through LBS -> SGS -> workers and
reports the ``ExperimentResult`` (latency percentiles, deadline adherence,
cold starts), line for line as the reference does.  ``--backend stub``
replays the same pipeline with scripted times.  ``--device`` takes the
place of the reference's ``--kernels``: the device picks the
implementation (``kernels/ops.py``), and without it the models run on the
card.  ``main`` is ``parse_args`` -> ``build_experiment`` -> ``simulate``
-> ``report``, so that a caller can build the same run from a config of
its own (``chip_smoke.py`` phase 13 at published width).

``serve`` is the data plane alone: one served model under continuous
batching with no LBS/SGS in front.  It calibrates a
``ContinuousTorchExecutor`` (kernel build, weights, every bucket timed),
then drives seeded Poisson arrivals through ``SimEnv`` +
``ContinuousBatcher``.  The measured wall seconds of every join and step
advance the simulated clock, as in the JAX package's batched backend, so
latencies are device time as the requests would have seen it.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..core import ClusterConfig
from ..core.batching import ContinuousBatcher
from ..core.types import DagSpec, FunctionSpec, Invocation, Request
from ..device import DeviceLike, device_name, resolve_device
from ..kernels import ops as kernel_ops
from ..models.config import ModelConfig
from ..serving import ServingApp
from ..serving.executor import ContinuousTorchExecutor, ServedModel
from ..sim import Experiment, ExperimentResult, simulate
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


TORCH_BACKENDS = ("torch", "torch-batched")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The reference launcher's flags, with ``--device`` in place of
    ``--kernels`` and the port's backends."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="minicpm-2b", choices=ARCH_IDS)
    ap.add_argument("--rps", type=float, default=10.0)
    ap.add_argument("--requests", type=int, default=60,
                    help="expected request count (duration = requests/rps)")
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=4)
    ap.add_argument("--slack", type=float, default=0.5)
    ap.add_argument("--n-sgs", type=int, default=2)
    ap.add_argument("--backend", default="torch",
                    choices=[*TORCH_BACKENDS, "stub", "stub-batched",
                             "modeled"])
    ap.add_argument("--batch-window", type=float, default=0.005,
                    help="batched backends: coalescing window (sim seconds)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="batched backends: flush when this many invocations "
                         "of one model have gathered")
    ap.add_argument("--device", default=None,
                    help="torch backends: where the models run (default: "
                         "cuda, which raises without CUDA; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--batching", default="windowed",
                    choices=["windowed", "continuous"],
                    help="batched backends: request-window coalescing vs "
                         "step-granular continuous batching")
    ap.add_argument("--stack", default="archipelago")
    ap.add_argument("--warmup", type=float, default=None,
                    help="steady-state window start (exclude the pre-warm "
                         "transient from the reported stats); default: half "
                         "the duration for the torch backends (real runs "
                         "take their measured time and arrivals start at "
                         "t=0), else 0")
    return ap.parse_args(argv)


def build_experiment(args: argparse.Namespace, cfg: ModelConfig
                     ) -> Experiment:
    """One tenant serving ``cfg`` under ``args.stack`` on ``args.backend``,
    as the reference launcher builds it."""
    duration = args.requests / args.rps
    warmup = args.warmup
    real = args.backend in TORCH_BACKENDS
    if warmup is None:
        warmup = duration / 2.0 if real else 0.0
    backend_kwargs: Dict[str, Any] = {}
    if args.backend.endswith("-batched"):
        backend_kwargs = dict(batch_window=args.batch_window,
                              max_batch=args.max_batch,
                              batching=args.batching)
    if real:
        backend_kwargs["device"] = args.device
    app = ServingApp(
        dag_id=args.arch,
        models={f"{args.arch}/generate": ServedModel(
            cfg, prompt_len=args.prompt, gen_len=args.gen)},
        slack=args.slack)
    return Experiment(
        stack=args.stack,
        backend=args.backend,
        backend_kwargs=backend_kwargs,
        workload_factory="serving_apps",
        workload_kwargs=dict(apps=[app], duration=duration,
                             rps=args.rps, prewarm_per_fn=4),
        cluster=ClusterConfig(n_sgs=args.n_sgs, workers_per_sgs=2,
                              cores_per_worker=2),
        warmup=warmup, drain=10.0)


def report(r: ExperimentResult) -> None:
    """The reference launcher's lines: each function's measured spec, the
    latency percentiles, deadlines met and cold starts, the data plane, and
    the batch or continuous counters."""
    backend = r.sim.backend
    for name, spec in (getattr(backend, "fn_specs", None) or {}).items():
        print(f"  {name}: exec={spec.exec_time*1e3:.1f}ms "
              f"setup={spec.setup_time:.1f}s "
              f"SNE={spec.setup_time/spec.exec_time:.0f}x")
    lat = r.latency_percentiles
    print(f"  {r.name}: n={r.n_requests} done={r.n_completed} "
          f"p50={(lat['p50'] or 0)*1e3:.1f}ms "
          f"p99={(lat['p99'] or 0)*1e3:.1f}ms "
          f"deadlines_met={(r.deadline_met_frac or 0)*100:.2f}% "
          f"cold_starts={r.cold_start_count}")
    dp = "".join(f" {k}={v}" for k, v in sorted(r.data_plane.items()))
    print(f"  executions: {backend.counters().get('n_executions', 0)} "
          f"({r.backend} backend{dp})")
    bc = r.backend_counters
    if bc.get("n_batches"):
        print(f"  batches: {bc['n_batches']} "
              f"(mean occupancy "
              f"{bc['n_batched_invocations'] / bc['n_batches']:.2f}, "
              f"max {bc['max_batch_occupancy']}, "
              f"padding efficiency "
              f"{bc['n_batched_invocations'] / bc['n_batch_slots']:.2f})")
    if bc.get("n_decode_ticks"):
        print(f"  continuous: {bc['n_prefill_batches']} prefill batches, "
              f"{bc['n_decode_ticks']} decode ticks "
              f"(mean step occupancy "
              f"{bc['n_step_slots'] / bc['n_decode_ticks']:.2f}, "
              f"max {bc['max_batch_occupancy']})")


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    exp = build_experiment(args, get_config(args.arch, reduced=True))
    if args.backend in TORCH_BACKENDS:
        dev = resolve_device(args.device)
        what = ("the kernel build, then timed runs of each batch bucket"
                if args.backend == "torch-batched"
                else "the kernel build, then timed runs")
        print(f"[serve] calibrating {args.arch} on {device_name(dev)} "
              f"({what})...")
    report(simulate(exp))


if __name__ == "__main__":
    main()
