"""The run's whole path on the CPU at the reduced configurations
(``--smoke``): set-up, the window through the program's scheduler and
continuous batcher, the metrics, the check."""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness
from portbench.cells import find_cell

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 7                       # more than 32 signed bits hold


def args(workload, trace=0, seed=SEED, seconds=1.5):
    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace, smoke=True)


def result(capsys, ns, **kw):
    rc = harness.run_cell(ns, time.perf_counter(), **kw)
    out = capsys.readouterr()
    assert rc == 0, out.err
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_run_py_end_to_end_in_a_process():
    cmd = [sys.executable, "portbench/run.py", "--workload",
           "minicpm-2b.chat", "--seed", str(SEED), "--seconds", "1.5",
           "--trace", "0", "--smoke"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    cell = find_cell("minicpm-2b.chat")
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for name in ("latency_p95_ms", "tokens_per_s", "setup_s"):
        assert res["metrics"][name]["value"] > 0
    # the numbers compared are the last lines of standard error
    err = out.stderr.strip().splitlines()
    assert err[-len(res["checks"]):] == [
        f"check {k}: {v} (limit {lim})"
        for k, (v, lim) in res["checks"].items()]


@pytest.mark.parametrize("workload", ["mamba2-370m.chat",
                                      "minicpm-2b.summarize"])
def test_the_same_seed_gives_the_same_work(capsys, in_process, workload):
    a, _ = result(capsys, args(workload, seed=11))
    b, _ = result(capsys, args(workload, seed=11))
    assert a["correct"] and b["correct"]
    assert a["attempted"] == b["attempted"]
    assert a["checks"] == b["checks"]


def test_per_layer_metrics_of_a_traced_smoke_run(capsys, in_process):
    res, _ = result(capsys, args("mamba2-370m.summarize", trace=1))
    assert res["correct"] is True
    cell = find_cell("mamba2-370m.summarize")
    device_trace = {m["name"] for m in cell.per_layer
                    if m["source"] == "device_trace"}
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer} \
        - device_trace


def test_without_the_program_it_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "minicpm-2b.chat", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_a_card_it_prints_no_result(capsys):
    ns = args("minicpm-2b.chat")
    ns.smoke = False
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert harness.run_cell(ns, time.perf_counter()) == 2
    assert capsys.readouterr().out == ""
