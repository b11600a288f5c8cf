"""Roofline analysis from dry-run traces (no real hardware).

Port of ``src/repro/launch/roofline.py``.  Three terms per (arch x shape),
single production mesh (``launch/mesh.py``: data 32 x model 8), per device:

    compute term    = FLOPs / PEAK_FLOPS_BF16
    memory term     = bytes / HBM_BW
    collective term = sum over mesh axes of that axis's wire bytes over its
                      link: NVLINK_BW inside a node (model, expert, tp),
                      NET_BW across nodes (data, pod)

Each term comes from one whole trace at full depth (``launch/dryrun.py``).
The reference compiles probe configurations with one and two layers per
group and composes them (``_probe_cfg``, ``_compose``), because XLA's cost
analysis counts a while-loop body once whatever its trip count, and reads
collective bytes from the HLO text (``parse_collective_bytes``,
``_shape_bytes``).  An eager trace sees every layer's operations and every
collective as it runs, so none of those has a counterpart here.

These are counts priced with the H100 data sheet's constants, not
measurements.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict

from ..configs import ARCH_IDS, INPUT_SHAPES, get_config, shape_applicable
from ..models.config import ModelConfig
from .mesh import HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16, link_bw

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / \
    "roofline_torch"


def model_flops(cfg: ModelConfig, shape: str) -> float:
    """Analytic MODEL_FLOPS (global): 6*N*D train, 2*N*D inference, with
    N = active params (MoE: routed experts only).  Attention's quadratic
    term is excluded by convention — the useful-compute yardstick."""
    seq, batch, kind = INPUT_SHAPES[shape]
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch          # decode: one token per sequence


def terms(rec: Dict[str, Any]) -> Dict[str, float]:
    """The three roofline terms (seconds) of one dry-run record."""
    return {"compute_s": rec["flops"] / PEAK_FLOPS_BF16,
            "memory_s": rec["bytes_accessed"] / HBM_BW,
            "collective_s": sum(b / link_bw(axis) for axis, b
                                in rec["coll_by_axis"].items())}


def analyze_record(rec: Dict[str, Any],
                   cfg: ModelConfig) -> Dict[str, Any]:
    """Terms, bottleneck and useful ratio of one dry-run record."""
    t = terms(rec)
    mf_global = model_flops(cfg, rec["shape"])
    mf_dev = mf_global / rec["n_devices"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "n_devices": rec["n_devices"],
        "flops_dev": rec["flops"], "bytes_dev": rec["bytes_accessed"],
        "coll_bytes_dev": rec["coll_bytes"],
        "coll_by_kind": rec["coll_by_kind"],
        "coll_by_axis": rec["coll_by_axis"],
        **t,
        "bottleneck": max(t, key=t.get).replace("_s", ""),
        "model_flops_global": mf_global,
        "model_flops_dev": mf_dev,
        "useful_ratio": mf_dev / rec["flops"] if rec["flops"] else 0.0,
        "argument_size_in_bytes": rec["argument_size_in_bytes"],
        "fits_hbm": rec["argument_size_in_bytes"] <= HBM_BYTES,
        "fsdp": rec["fsdp"],
        "device": rec["device"],
        "torch_version": rec.get("torch_version"),
    }


def analyze(arch: str, shape: str, use_cache: bool = True
            ) -> Dict[str, Any]:
    from .dryrun import run_combo
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    out_path = RESULTS_DIR / f"{arch}__{shape}.json"
    if use_cache and out_path.exists():
        return json.loads(out_path.read_text())
    rec = run_combo(arch, shape, "single", force=not use_cache)
    result = analyze_record(rec, get_config(arch))
    out_path.write_text(json.dumps(result, indent=1))
    return result


def one_version(rows) -> str:
    """The torch version that made every row, or a ``ValueError`` naming
    the versions: DTensor's rules differ between versions, and a table
    compares its rows."""
    versions = sorted({str(r.get("torch_version")) for r in rows})
    if len(versions) > 1:
        raise ValueError(f"records of torch {' and '.join(versions)} in one "
                         f"table: re-run the dry-run on one version "
                         f"(--force)")
    return versions[0] if versions else ""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    rows = []
    for arch in archs:
        for shape in shapes:
            if not shape_applicable(arch, shape):
                continue
            r = analyze(arch, shape, use_cache=not args.force)
            rows.append(r)
            one_version(rows)
            print(f"{arch:24s} {shape:12s} C={r['compute_s']*1e3:10.3f}ms "
                  f"M={r['memory_s']*1e3:10.3f}ms "
                  f"X={r['collective_s']*1e3:10.3f}ms "
                  f"dom={r['bottleneck']:10s} "
                  f"useful={r['useful_ratio']*100:5.1f}% "
                  f"args={r['argument_size_in_bytes']/1e9:7.2f}GB",
                  flush=True)
    (RESULTS_DIR / "table.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
