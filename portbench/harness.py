"""One run of one cell: set-up, the window, the metrics, the check.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start to the window):
imports, the program's kernel build (nvcc, on a checkout's first run
only), its set-up of the function (weights, slab, the warm-up and capture
of every bucket's join and step), the benchmark's weights drawn into the
program's parameters, and the program's calibration.  The window: every
request of the seed's arrival schedule (spanning ``--seconds`` on the
system's clock) served to completion through ``simulate``.  With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read with a profiled slice in the
window.  After the window the program's state is freed and a sample of
the served requests is judged against the float32 reference
(``judge.py``).  The last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.

``--smoke`` runs the same path on the CPU at the configuration's reduced
sizes and short lengths (tests only; its numbers are not device numbers).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import cells, judge
from . import metrics as layer_metrics
from . import record
from . import traffic as gen
from . import weights as wts

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SMOKE = {"prompt_len": 32, "gen_len": 4, "rps": 40.0}
SMOKE_SAMPLE = 8


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--smoke", action="store_true",
                   help="reduced sizes on the CPU (tests only)")
    return p.parse_args(argv)


def forbidden(modules) -> List[str]:
    """The top-level names among ``modules`` that are the JAX stack's or
    the JAX package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def attended_keys(events, prompt_len: int) -> List[Optional[List[int]]]:
    """Per event, the keys each stepped row attends (its position + 1);
    None for a join."""
    pos: Dict[int, int] = {}
    out: List[Optional[List[int]]] = []
    for e in events:
        if e.kind == "join":
            pos.update((s, prompt_len) for s in e.slots)
            out.append(None)
            continue
        out.append([pos[s] + 1 for s in e.slots])
        for s in e.slots:
            pos[s] += 1
    return out


@dataclasses.dataclass
class Setup:
    """A cell's system, set up and calibrated, with its inputs."""

    cell: Any
    traffic: Dict[str, Any]
    dims: Dict[str, Any]
    fam: Any
    counts: Any
    device: Any
    cfg: Any
    backend: Any
    weight_seed: int


def set_up(cell, smoke: bool, seed: int):
    """Everything before a window: the program's kernel build, its set-up
    of the function (with the benchmark's weights drawn into it) and its
    calibration.  Raises ``SystemExit(2)`` without the cell's devices."""
    import torch

    from . import counts, reference, system
    if smoke:
        device = torch.device("cpu")
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"portbench: {cell.name} needs {cell.chips} CUDA "
                  f"device(s); found {have}", file=sys.stderr)
            raise SystemExit(2)
        device = torch.device("cuda", 0)
    traffic = dict(cell.traffic, **(SMOKE if smoke else {}))
    if smoke:
        c = traffic["check"]
        traffic["check"] = dict(c, sample=SMOKE_SAMPLE,
                                max_logit_gap=c["smoke_max_logit_gap"])
    d = cells.dims(cell.config, smoke)
    fam = reference.family(cell.config["family"])
    cfg = cells.program_config(cell.config, smoke)
    wseed = gen.weight_seed(seed)
    calib = gen.calibration_prompts(traffic, int(traffic["max_batch"]),
                                    d["vocab_size"], seed)
    be = system.backend(cfg, traffic, device, fam.leaves(d), wseed,
                        np.empty((0, int(traffic["prompt_len"])), np.int64),
                        calib)
    exp = system.experiment(cfg, traffic, np.zeros(1), be, 1.0)
    be.build(exp, exp.resolve_workload())
    return Setup(cell, traffic, d, fam, counts.family(cell.config["family"]),
                 device, cfg, be, wseed)


def window(s: Setup, times: np.ndarray, prompts: np.ndarray,
           seconds: float, setup_s: float, slicer=None
           ) -> Tuple[record.Run, Dict[str, Any]]:
    """Serve every request of ``times`` to completion; returns the run's
    record and what the check needs (served tokens, accounting)."""
    import torch

    from . import system
    ex = s.backend.executor
    ex.prompts = prompts
    ex.events.clear()
    ex.tokens.clear()
    exp = system.experiment(s.cfg, s.traffic, times, s.backend, seconds)
    ex.recording = True
    t0 = time.perf_counter()
    r = system.simulate(exp, timed_calls=slicer.timed_calls()
                        if slicer else ())
    wall = time.perf_counter() - t0
    ex.recording = False
    if s.device.type == "cuda":
        torch.cuda.synchronize()
    n = len(times)
    G1 = int(s.traffic["gen_len"]) + 1
    reqs = r.sim.metrics.requests
    completion = np.array([np.nan if q.completion_time is None
                           else q.completion_time for q in reqs])
    first = np.full(n, np.nan)
    for e in ex.events:
        if e.kind == "join":
            first[list(e.rows)] = e.t + e.seconds
    served, got = ex.served_tokens(n, G1)
    run = record.Run(
        cell=s.cell.name, traffic=s.traffic, dims=s.dims, counts=s.counts,
        setup_s=setup_s, wall_s=wall,
        horizon=gen.UPLOAD_S + seconds + system.DRAIN_S,
        arrival=np.asarray(times), completion=completion, first_token=first,
        cold_starts=int(r.cold_start_count),
        queuing=np.array([q.total_queuing_delay for q in reqs]),
        counters=dict(r.backend_counters), events=list(ex.events),
        keys=attended_keys(ex.events, int(s.traffic["prompt_len"])),
        slice=slicer.result() if slicer else None)
    out = {"served": served, "got": got,
           "finite": ex.logits_finite(s.traffic["function"]),
           "accounting": dict(r.accounting)}
    return run, out


def run_cell(a: argparse.Namespace, t_start: float,
             root: Path = cells.ROOT) -> int:
    import torch

    from .profiling import Slicer

    cell = cells.find_cell(a.workload, root=root)
    try:
        s = set_up(cell, a.smoke, a.seed)
    except SystemExit as e:
        return int(e.code)
    traffic, d, device = s.traffic, s.dims, s.device
    times = gen.arrivals(traffic, a.seconds, a.seed)
    n = len(times)
    prompts = gen.prompts(traffic, n, d["vocab_size"], a.seed)
    card = "cpu" if a.smoke else power_limit()
    # the CPU has no device trace: a smoke run reads its per-layer
    # metrics without a slice (the trace's metrics read nothing)
    slicer = Slicer(s.backend.executor, gen.UPLOAD_S, a.seconds) \
        if a.trace and not a.smoke else None
    setup = time.perf_counter() - t_start
    run, out = window(s, times, prompts, a.seconds, setup, slicer)
    if device.type == "cuda":
        peak = int(torch.cuda.max_memory_allocated(device))
        kind = torch.cuda.get_device_name(device)
    else:
        peak, kind = 0, "cpu"
    if slicer is not None and run.slice is None:
        print(f"portbench: the profiler recorded no device event in "
              f"{slicer.tried} slice(s); no per-layer metric is read",
              file=sys.stderr)
        return 5
    if a.trace:
        wanted = cell.per_layer
        values = {m["name"]: layer_metrics.load(m["name"], root).read(run)
                  for m in wanted}
    else:
        wanted = cell.end_to_end
        values = {m["name"]: record.END_TO_END[m["name"]](run)
                  for m in wanted}
    out_metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in wanted if values[m["name"]] is not None}

    # the program's state goes before the reference runs
    s.backend = None
    del slicer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    G1 = run.tokens_per_request
    check = traffic["check"]
    done = ~np.isnan(run.completion)
    got = out["got"]
    full = np.flatnonzero(done & (got == G1))
    sample = full[gen.check_sample(len(full), int(check["sample"]), a.seed)]
    t_check = time.perf_counter()
    w = wts.fill(s.fam.leaves(d), s.weight_seed, device)
    gaps = judge.widest_gaps(s.fam, d, w, prompts[sample],
                             out["served"][sample], device)
    del w
    check_s = time.perf_counter() - t_check
    widest = float(gaps.max()) if len(gaps) else None
    acct = out["accounting"]
    checks = {
        "widest_logit_gap": [widest, float(check["max_logit_gap"])],
        "unfinished": [int(n - done.sum()), 0],
        "lost": [int(acct.get("lost", 0)), 0],
        "duplicated": [int(acct.get("duplicate_completions", 0)), 0],
        "wrong_token_count": [int((got[done] != G1).sum()), 0],
        "nonfinite_logits": [int(not out["finite"]), 0],
    }
    correct = (widest is not None and widest <= check["max_logit_gap"]
               and all(v == lim for k, (v, lim) in checks.items()
                       if k != "widest_logit_gap"))

    found = forbidden(list(sys.modules))
    if found:
        print(f"portbench: loaded {found} in the process that reports",
              file=sys.stderr)
        return 4

    system_end = float(np.nanmax(run.completion)) if done.any() \
        else math.nan
    dev: Dict[str, Any] = {"platform": "cpu" if a.smoke else "gpu",
                           "kind": kind, "count": 1,
                           "memory_peak_bytes": peak}
    result: Dict[str, Any] = {
        "correct": bool(correct), "attempted": int(n),
        "failed": int(n - done.sum()), "metrics": out_metrics,
        "device": dev}
    if run.slice is not None:
        dev["busy_s"] = run.slice.busy_s
        dev["window_s"] = run.slice.window_s
        result["breakdown"] = {"device_ops": run.slice.device_ops,
                               "idle_gaps": run.slice.idle_gaps}
    result["card"] = card
    result["clocks"] = {"system_s": system_end, "wall_s": run.wall_s,
                        "check_s": check_s, "setup_s": setup}
    result["checks"] = checks
    print(f"portbench: {cell.name} seed {a.seed}: {n} requests, window "
          f"{run.wall_s:.3f} s wall against {system_end:.3f} s on the "
          f"system's clock; {len(sample) * G1} served tokens judged in "
          f"{check_s:.1f} s; {card}", file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv: List[str], t_start: float) -> int:
    return run_cell(parse(argv), t_start)
