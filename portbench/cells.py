"""The catalogue: ``BENCHMARK.json``'s cells and the files they name.

A cell names a configuration (an entry of ``configs``, whose ``file`` is
the configuration as it is run) and a traffic mix, found as
``traffic/<traffic>.json``.  The per-layer metrics of a cell are the
``per_layer`` entries that list it under ``workloads`` and, among those
without that key, the ones that move an end-to-end metric the cell
reports.  A metric listed for a cell that does not report what it moves
is an error of ``BENCHMARK.json``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: Dict[str, Any]          # the configuration file's object
    traffic: Dict[str, Any]         # the traffic file's object
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def traffic_file(name: str, bench_dir: Path = BENCH) -> Path:
    return bench_dir / "traffic" / f"{name}.json"


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    ws = metric.get("workloads")
    return ws is None or cell in ws


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic loaded; raises ``KeyError`` naming the known cells."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(traffic_file(w["traffic"], root / "portbench"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = []
    for m in bench["per_layer"]:
        if name in m.get("workloads", ()):
            if m["moves"] not in reported:
                raise ValueError(f"{m['name']} is listed for {name}, which "
                                 f"does not report {m['moves']}")
            per_layer.append(m)
        elif "workloads" not in m and m["moves"] in reported:
            per_layer.append(m)
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer)


def program_config(config: Dict[str, Any], smoke: bool = False):
    """The program's ``ModelConfig`` that the configuration file names,
    held to the file: every published key the file maps to a field of the
    program's config has to read the same there (``smoke`` holds the
    reduced config to the file's ``smoke`` sizes instead)."""
    from repro_torch.configs import get_config
    cfg = get_config(config["program_config"], reduced=smoke)
    want = dims(config, smoke)
    got = {field: getattr(cfg, field) for field in want}
    if got != want:
        raise ValueError(f"{config['name']}: the program's config reads "
                         f"{got}, the configuration file {want}")
    return cfg


def dims(config: Dict[str, Any], smoke: bool = False) -> Dict[str, Any]:
    """The sizes the reference and the counts use, as plain numbers, in the
    program's field names (the file's ``fields`` map, or ``smoke``)."""
    if smoke:
        return dict(config["smoke"])
    return {field: config[key] for key, field in config["fields"].items()}
