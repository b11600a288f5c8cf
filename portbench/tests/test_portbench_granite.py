"""The granite-4.0-h-micro cell (``granite-4.0-h-micro.rag``) on the CPU at
the configuration's reduced sizes (``--smoke``): a run judged correct, the
same seed giving the same work, the per-layer metrics of a traced run, and
a window served with the port's tracer on, which reads a slab split
between K/V in place and SSM state copied."""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import harness, metrics, peaks, record
from portbench import traffic as gen
from portbench.cells import dims, find_cell
from portbench.counts import family
from portbench.profiling import Slice
from portbench.system import Event
from repro_torch import trace, trace_readings

ROOT = Path(__file__).resolve().parents[2]
CELL = "granite-4.0-h-micro.rag"
SEED = 2 ** 31 + 13                      # more than 32 signed bits hold


def args(trace=0, seed=SEED, seconds=1.5):
    return argparse.Namespace(workload=CELL, seed=seed, seconds=seconds,
                              trace=trace, smoke=True)


def result(capsys, ns):
    rc = harness.run_cell(ns, time.perf_counter())
    out = capsys.readouterr()
    assert rc == 0, out.err
    return json.loads(out.out.strip().splitlines()[-1])


def test_the_granite_cell_s_smoke_run_is_correct_in_a_process():
    cmd = [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
           str(SEED), "--seconds", "1.5", "--trace", "0", "--smoke"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    cell = find_cell(CELL)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end} \
        == {"deadline_met_pct", "tokens_per_s", "setup_s"}
    assert res["checks"]["widest_logit_gap"][0] <= \
        cell.traffic["check"]["smoke_max_logit_gap"]


def test_the_same_seed_gives_the_same_work_in_the_granite_cell(capsys,
                                                                in_process):
    a = result(capsys, args(seed=11))
    b = result(capsys, args(seed=11))
    assert a["correct"] and b["correct"]
    assert a["attempted"] == b["attempted"]
    assert a["checks"] == b["checks"]


def test_per_layer_metrics_of_a_traced_granite_smoke_run(capsys,
                                                         in_process):
    res = result(capsys, args(trace=1))
    assert res["correct"] is True
    cell = find_cell(CELL)
    names = {m["name"] for m in cell.per_layer}
    assert "hybrid_decode_attention_roofline" in names
    device_trace = {m["name"] for m in cell.per_layer
                    if m["source"] == "device_trace"}
    assert set(res["metrics"]) == names - device_trace


def test_a_traced_granite_smoke_window_reads_a_split_slab(one_thread):
    cell = find_cell(CELL)
    trace.clear()
    trace.enable()
    try:
        s = harness.set_up(cell, True, SEED)
        times = gen.arrivals(s.traffic, 1.0, SEED)
        prompts = gen.prompts(s.traffic, len(times), s.dims["vocab_size"],
                              SEED)
        trace.clear()
        run, _ = harness.window(s, times, prompts, 1.0, 0.0)
        spans = trace.spans()
    finally:
        trace.enable(False)
        trace.clear()
    got = trace_readings.summarize(spans)
    assert got["step"]["n"] == sum(e.kind == "step" for e in run.events)
    assert 0 < got["slab_in_place_pct"] < 100
    assert got["step_mamba_ms"] > 0 and got["step_attn_ms"] > 0


def test_the_hybrid_decode_roofline_reads_the_slice_s_steps():
    """At the published sizes: the bound of the steps inside the slice
    (G 4 over each row's keys) over the slice's ``dec_kernel`` time; a
    slice that profiled no step reads nothing."""
    cell = find_cell(CELL)
    d = dims(cell.config)
    counts = family(cell.config["family"])
    reader = metrics.load("hybrid_decode_attention_roofline")

    def run_of(events, keys, kernel_s):
        sl = Slice(busy_s=0.5, window_s=2.0, kernel_s=kernel_s,
                   device_ops=[], idle_gaps=[])
        return record.Run(
            cell=CELL, traffic=cell.traffic, dims=d, counts=counts,
            setup_s=1.0, wall_s=2.0, horizon=10.0, arrival=np.zeros(2),
            completion=np.ones(2), first_token=np.ones(2), cold_starts=0,
            queuing=np.zeros(2), counters={}, events=events, keys=keys,
            slice=sl)

    ev = [Event("join", 0.0, (0, 1), (0, 1), 0.2, True),
          Event("step", 0.2, (0, 1), (), 0.01, True),
          Event("step", 0.21, (0, 1), (), 0.01, False)]
    keys = [None, [8193, 8194], [8194, 8195]]
    t = 2e-4
    got = reader.read(run_of(ev, keys, {"void dec_kernel_tc<64>": t,
                                        "ssd_kernel_wgmma<1>": 0.05}))
    bound = sum(peaks.bound_s(f, b) for f, b in
                counts.step_launches(d, [8193, 8194])["decode_attention"])
    assert len(counts.step_launches(d, [1])["decode_attention"]) == 4
    assert got == pytest.approx(100 * bound / t)
    assert reader.read(run_of(ev[:1], keys[:1],
                              {"ssd_kernel_wgmma<1>": 0.05})) is None
