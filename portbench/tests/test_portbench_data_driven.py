"""A cell, a traffic mix and a per-layer metric added as new files only."""
import argparse
import json
import shutil
import time
from pathlib import Path

import pytest

from portbench import harness
from portbench.cells import find_cell

ROOT = Path(__file__).resolve().parents[2]

READER = '''"""Joins of the window."""
LAYER = "executor"
MOVES = "tokens_per_s"
UNIT = "count"
SOURCE = "program_span"
BETTER = "higher"


def read(run):
    return float(sum(e.kind == "join" for e in run.events))
'''


def test_a_cell_added_by_data_files_alone_is_found_and_run(tmp_path, capsys,
                                                           in_process):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "portbench" / sub,
                        tmp_path / "portbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # the new files: a traffic mix, a cell naming it, a metric and its reader
    mix = json.loads((tmp_path / "portbench/traffic/minicpm-2b.chat.json")
                     .read_text())
    mix.update(max_batch=4, why="a test mix")
    (tmp_path / "portbench/traffic/minicpm-2b.burst.json").write_text(
        json.dumps(mix))
    bench["workloads"].append({"name": "minicpm-2b.burst",
                               "config": "minicpm-2b",
                               "traffic": "minicpm-2b.burst", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "joins", "unit": "count",
                               "better": "higher", "source": "program_span",
                               "layer": "executor", "moves": "tokens_per_s",
                               "workloads": ["minicpm-2b.burst"]})
    (tmp_path / "portbench/metrics/joins.py").write_text(READER)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = find_cell("minicpm-2b.burst", root=tmp_path)
    assert cell.traffic["max_batch"] == 4
    assert "joins" in {m["name"] for m in cell.per_layer}
    assert "joins" not in {m["name"] for m in
                           find_cell("minicpm-2b.chat",
                                     root=tmp_path).per_layer}
    ns = argparse.Namespace(workload="minicpm-2b.burst", seed=5,
                            seconds=1.5, trace=1, smoke=True)
    assert harness.run_cell(ns, time.perf_counter(), root=tmp_path) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["joins"]["value"] >= 1
    assert res["attempted"] == round(harness.SMOKE["rps"] * 1.5)


def test_a_metric_listed_for_a_cell_that_does_not_report_its_moves_is_refused(
        tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "joins", "unit": "count",
                               "better": "higher", "source": "program_span",
                               "layer": "executor", "moves": "no_such",
                               "workloads": ["minicpm-2b.chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(ROOT / "portbench" / "configs",
                    tmp_path / "portbench" / "configs")
    shutil.copytree(ROOT / "portbench" / "traffic",
                    tmp_path / "portbench" / "traffic")
    with pytest.raises(ValueError, match="does not report no_such"):
        find_cell("minicpm-2b.chat", root=tmp_path)
