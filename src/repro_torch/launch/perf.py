"""Performance hillclimbing (§Perf): hypothesis -> change -> measure ->
validate, on three chosen (arch x shape) pairs, on the dry-run's counts.

Port of ``src/repro/launch/perf.py`` with its pairs and variants:
  A. mixtral-8x22b  x train_4k    -- the expert-parallel MoE with backward
                                     and AdamW (expert mesh, capacity 1.0)
  B. minicpm-2b     x decode_32k  -- 36 heads do not divide the model axis,
                                     so its KV cache shards on the head dim
                                     (padding to 48 heads)
  C. llama4-scout   x decode_32k  -- MoE decode, the serving workload
                                     Archipelago schedules (FSDP off,
                                     padded KV heads)

Each variant is one whole trace (``launch/dryrun.py``'s ``trace_one``)
priced as ``launch/roofline.py`` prices it, with the H100 data sheet's
constants: counts, not measurements.  Results land in
results/perf_torch/<pair>__<variant>.json.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, Optional

from ..configs import get_config
from .dryrun import MESH_DEVICE, fake_group, trace_one
from .mesh import make_production_mesh
from .roofline import analyze_record

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "perf_torch"


def make_expert_mesh(device_type: str = MESH_DEVICE):
    """256 GPUs as (data 32, expert 4, tp 2): expert x tp fills one 8-GPU
    NVLink node, experts whole on groups of two GPUs."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (32, 4, 2),
                            mesh_dim_names=("data", "expert", "tp"))


def measure_variant(arch: str, shape: str, *, mesh=None,
                    cfg_transform=None, fsdp: Optional[bool] = None
                    ) -> Dict[str, Any]:
    cfg = get_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    fake_group(256)
    mesh = mesh or make_production_mesh(multi_pod=False,
                                        device_type=MESH_DEVICE)
    rec = trace_one(arch, shape, mesh, fsdp=fsdp, cfg=cfg)
    return analyze_record(rec, cfg)


VARIANTS = {
    # -- pair A: mixtral train ------------------------------------------------
    ("mixtral-8x22b", "train_4k"): {
        "baseline": {},
        # H-A1: experts live whole on GPU pairs (expert axis 4 x tp 2); MoE
        # traffic stays inside the node instead of full-f tensor shards
        "expert_mesh": {"mesh": "expert"},
        # H-A2: capacity factor 1.25 -> 1.0 shrinks every dispatch/expert
        # buffer by 20% (slight routing-drop quality trade, documented)
        "expert_mesh_cap1": {
            "mesh": "expert",
            "cfg_transform": lambda c: c.with_(capacity_factor=1.0)},
    },
    # -- pair B: minicpm decode -----------------------------------------------
    ("minicpm-2b", "decode_32k"): {
        "baseline": {},
        # H-B1: pad 36 heads -> 48 so the cache shards by kv head
        "pad_heads": {"cfg_transform": lambda c: c.pad_heads(16)},
    },
    # -- pair C: llama4 decode ------------------------------------------------
    ("llama4-scout-17b-a16e", "decode_32k"): {
        "baseline": {},
        # H-C1: decode is weight-stationary; FSDP all-gathers every weight
        # every token.  Model-axis-only sharding drops that.
        "no_fsdp": {"fsdp": False},
        # H-C2: pad kv heads 8 -> 16 so the cache shards by head
        "pad_heads": {"cfg_transform": lambda c: c.pad_heads(16)},
        # H-C3: both
        "pad_heads_no_fsdp": {"cfg_transform": lambda c: c.pad_heads(16),
                              "fsdp": False},
    },
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default=None,
                    help="arch:shape filter, e.g. minicpm-2b:decode_32k")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    for (arch, shape), variants in VARIANTS.items():
        if args.pair and args.pair != f"{arch}:{shape}":
            continue
        for vname, opts in variants.items():
            tag = f"{arch}__{shape}__{vname}"
            path = RESULTS_DIR / f"{tag}.json"
            if path.exists() and not args.force:
                r = json.loads(path.read_text())
            else:
                mesh = None
                if opts.get("mesh") == "expert":
                    fake_group(256)
                    mesh = make_expert_mesh()
                r = measure_variant(arch, shape, mesh=mesh,
                                    cfg_transform=opts.get("cfg_transform"),
                                    fsdp=opts.get("fsdp"))
                path.write_text(json.dumps(r, indent=1))
            print(f"{tag:60s} C={r['compute_s']*1e3:10.3f}ms "
                  f"M={r['memory_s']*1e3:10.3f}ms "
                  f"X={r['collective_s']*1e3:10.3f}ms "
                  f"dom={r['bottleneck']}", flush=True)


if __name__ == "__main__":
    main()
