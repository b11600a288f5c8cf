"""Find the highest rate a cell's system sustains, once, on the chip.

    python3 portbench/sweep.py --workload minicpm-2b.chat --seed 5 \
        --seconds 30 --rates 3 4 5 6 7

One set-up, then one window per rate, each with the seed's arrivals and
prompts at that rate.  A rate is sustained when every request completes,
the backlog does not grow (the median latency of the last quarter of
arrivals is within 1.5 times that of the second quarter; the first
quarter starts from an idle system) and the 95th percentile of latency
is within the mix's limit.  The knee is the highest rate sustained below
the first that is not.  Before the windows it prints the program's
calibrated batch-1 critical path (one join at bucket 1 and ``gen_len``
steps), from which the mix's limit is set; ``--limit-ms`` judges against
another limit.  Prints one JSON line per rate and a last line with the
knee and four fifths of it; it judges no correctness.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

import numpy as np  # noqa: E402

from portbench import cells, harness, record  # noqa: E402
from portbench import traffic as gen  # noqa: E402

BACKLOG_RATIO = 1.5


def backlog_grows(run: record.Run) -> bool:
    lat = record.latencies(run)
    n = len(lat)
    second, last = np.median(lat[n // 4: n // 2]), np.median(lat[3 * n // 4:])
    return bool(last > BACKLOG_RATIO * second)


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="portbench/sweep.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--limit-ms", type=float, default=None)
    p.add_argument("--smoke", action="store_true")
    a = p.parse_args(argv)
    cell = cells.find_cell(a.workload)
    try:
        s = harness.set_up(cell, a.smoke, a.seed)
    except SystemExit as e:
        return int(e.code)
    be, t = s.backend, s.traffic
    fn = t["function"]
    cp = be.fn_specs[fn].exec_time
    limit_ms = a.limit_ms if a.limit_ms is not None else \
        (float(t["slack_s"]) + cp) * 1e3
    s.traffic = t = dict(t, limit_ms=limit_ms)
    ex = be.executor
    print(json.dumps({
        "workload": a.workload, "batch1_critical_path_s": cp,
        "slack_s": t["slack_s"], "limit_ms": limit_ms,
        "setup_seconds": be.fn_specs[fn].setup_time,
        "bucket_admit_s": {str(k[1]): v for k, v in ex.bucket_admit_s.items()},
        "bucket_step_s": {str(k[1]): v for k, v in ex.bucket_step_s.items()},
        "card": harness.power_limit(),
        "setup_s": time.perf_counter() - T_START}), flush=True)
    knee = prev = None
    for rps in sorted(a.rates):
        tr = dict(t, rps=rps)
        times = gen.arrivals(tr, a.seconds, a.seed)
        prompts = gen.prompts(tr, len(times), s.dims["vocab_size"], a.seed)
        run, _ = harness.window(s, times, prompts, a.seconds, 0.0)
        lat = record.latencies(run)
        grows = backlog_grows(run)
        ok = (not grows and not np.isnan(run.completion).any()
              and record.latency_p95_ms(run) <= limit_ms)
        if ok and knee == prev:
            knee = rps
        prev = rps
        occ = run.counters.get("n_step_slots", 0) / max(
            1, run.counters.get("n_decode_ticks", 0))
        print(json.dumps({
            "rps": rps, "requests": len(times),
            "latency_p50_ms": float(np.median(lat)) * 1e3,
            "latency_p95_ms": record.latency_p95_ms(run),
            "ttft_p95_ms": record.ttft_p95_ms(run),
            "deadline_met_pct": record.deadline_met_pct(run),
            "tokens_per_s": record.tokens_per_s(run),
            "cold_starts": run.cold_starts, "decode_occupancy": occ,
            "wall_s": run.wall_s,
            "system_s": float(np.nanmax(run.completion)),
            "p95_within_limit": record.latency_p95_ms(run) <= limit_ms,
            "backlog_grows": grows, "sustained": ok}), flush=True)
    print(json.dumps({"workload": a.workload, "knee_rps": knee,
                      "four_fifths_rps": None if knee is None
                      else 0.8 * knee, "limit_ms": limit_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
