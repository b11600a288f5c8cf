"""Multi-device dry-run: trace every (architecture x input-shape x mesh)
combination on the production meshes and record its per-device cost for
the roofline analysis.

Port of ``src/repro/launch/dryrun.py``.  The reference lowers and compiles
each step for 256 or 512 placeholder host devices and reads XLA's cost
analysis; here the step runs eagerly on ``DTensor``s over a *fake* process
group of 256 or 512 ranks (``torch.distributed``'s ``fake`` backend: no
communication, no other process), with meta tensors (nothing is
allocated), under ``launch/cost.py``'s ``DeviceCostMode``, which prices
each operation on the shard rank 0 holds.  Parameters, AdamW state, caches
and inputs are placed by ``models/sharding.py``'s rules, the counterpart of
the reference's ``in_shardings``; each output is redistributed to a
definite placement (batch-sharded logits, a replicated loss), as XLA
lowers its ``out_shardings``.  The kernel wrappers take their plain
versions on meta tensors, as the reference's dry-run lowers its XLA ops.

The fake group is process-global: one process traces one mesh kind.
``--mesh both`` runs each kind in a child process of its own, as the
reference keeps its 512 devices to its own process.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..configs import ARCH_IDS, INPUT_SHAPES, get_config, shape_applicable
from ..models import decode_step, init_cache, init_params, prefill
from ..models.config import ModelConfig
from ..models.sharding import (cache_pspecs, distribute, input_pspecs,
                               needs_fsdp, param_pspecs, placements)
from ..train.optim import adamw_init
from ..train.steps import make_train_step
from ..train.tree import leaves
from .cost import DeviceCostMode
from .mesh import make_production_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"
DEVICE = "H100 SXM (data sheet)"
MESH_WORLD = {"single": 256, "multi": 512}
# the meshes' device type: DTensor's sharding propagation makes fake tensors
# on it, which needs a device this build of torch has (see gpu_alltoall)
MESH_DEVICE = "cpu"


def fake_group(world: int) -> None:
    """Initialise this process's default group as ``world`` fake ranks
    (this process is rank 0), or check that it already is."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"this process's group has "
                               f"{dist.get_world_size()} ranks; a mesh of "
                               f"{world} needs a process of its own")
        return
    # importing the module registers the "fake" backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group("fake", store=dist.HashStore(),
                            world_size=world, rank=0)


@contextlib.contextmanager
def gpu_alltoall():
    """Within it, DTensor redistributes Shard(i) -> Shard(j) on a CPU mesh
    with the all-to-all it runs on a GPU mesh, where on a CPU mesh it runs
    an all-gather and a chunk (gloo has no all-to-all), which would price
    g times the wire bytes.  Yields whether the swap is in place (a torch
    whose DTensor is laid out otherwise keeps the all-gather)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import placement_types
    orig = getattr(placement_types, "shard_dim_alltoall", None)
    op = getattr(getattr(torch.ops, "_dtensor", None), "shard_dim_alltoall",
                 None)
    if orig is None or op is None or not all(
            hasattr(funcol, f) for f in ("_resolve_group",
                                         "_group_or_group_name")):
        yield False
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return op(input, gather_dim, shard_dim,
                  funcol._group_or_group_name(group))

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield True
    finally:
        placement_types.shard_dim_alltoall = orig


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input (the reference's
    ``ShapeDtypeStruct``s): no device allocation."""
    seq, batch, kind = INPUT_SHAPES[shape_name]
    out: Dict[str, Any] = {"kind": kind, "batch": batch, "seq": seq}
    if kind in ("train", "prefill"):
        n_text = seq - (cfg.n_frontend_tokens if cfg.frontend
                        and cfg.arch_type != "encdec" else 0)
        out["tokens"] = _meta((batch, n_text), torch.int32)
        if cfg.frontend:
            out["frontend"] = _meta(
                (batch, cfg.n_frontend_tokens, cfg.d_model), cfg.dtype())
        if kind == "prefill":
            out["cache"] = init_cache(cfg, batch, seq, device="meta")
    else:   # decode: ONE new token against a cache of `seq`
        out["token"] = _meta((batch, 1), torch.int32)
        out["t"] = seq - 1
        out["cache"] = init_cache(cfg, batch, seq, device="meta")
    return out


def _local_bytes(tree: Any) -> int:
    return sum((t.to_local() if hasattr(t, "to_local") else t).numel()
               * t.element_size() for t in leaves(tree))


def _mesh_name(mesh) -> str:
    return "x".join(str(mesh.size(i)) for i in range(mesh.ndim))


def trace_one(arch: str, shape_name: str, mesh, *,
              fsdp: Optional[bool] = None,
              cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Trace one combination on ``mesh`` (a ``DeviceMesh`` over the fake
    group) and return its record.  ``cfg`` overrides the registry config
    (``launch/perf.py``'s variants)."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    if cfg is None:
        cfg = get_config(arch)
    specs = input_specs(cfg, shape_name)
    kind, batch = specs["kind"], specs["batch"]
    fsdp = bool(needs_fsdp(cfg, mesh) if fsdp is None else fsdp)
    params = init_params(cfg, device="meta")
    params = distribute(mesh, params,
                        param_pspecs(cfg, params, mesh, fsdp=fsdp))
    in_sp = input_pspecs(cfg, mesh, batch)

    def place(t, key):
        return distribute_tensor(t, mesh, placements(mesh, in_sp[key]))

    args = {k: place(specs[k], k) for k in ("tokens", "frontend", "token")
            if k in specs}
    if kind == "train":
        inputs = [params, adamw_init(params), args["tokens"]]
    else:
        cache = distribute(mesh, specs["cache"],
                           cache_pspecs(cfg, specs["cache"], mesh, batch))
        inputs = ([params, args["tokens"], cache] if kind == "prefill"
                  else [params, cache, args["token"]])
    if "frontend" in args:
        inputs.append(args["frontend"])
    argument_bytes = _local_bytes(inputs)
    mode = DeviceCostMode(mesh)
    t0 = time.perf_counter()
    with (contextlib.nullcontext() if kind == "train" else torch.no_grad()), \
            gpu_alltoall() as alltoall, implicit_replication(), mode:
        if kind == "train":
            _, _, loss = make_train_step(cfg)(*inputs)
            loss.redistribute(mesh, placements(mesh, ()))
        else:
            logits, _ = (prefill(cfg, *inputs) if kind == "prefill"
                         else decode_step(cfg, *inputs, specs["t"]))
            # batch-sharded (B, S, V) logits, as the input tokens
            logits.redistribute(mesh, placements(mesh, in_sp["frontend"]))
    trace_s = time.perf_counter() - t0
    cost = mode.summary()
    return {
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh),
        "mesh_axes": list(mesh.mesh_dim_names),
        "n_devices": mesh.size(), "fsdp": fsdp, "kind": kind,
        "trace_s": round(trace_s, 2),
        "flops": cost["flops"], "bytes_accessed": cost["bytes_accessed"],
        "coll_bytes": cost["coll_bytes"],
        "coll_by_kind": cost["coll_by_kind"],
        "coll_by_axis": cost["coll_by_axis"],
        "coll_calls": cost["coll_calls"],
        "alltoall": ("all-to-all" if alltoall
                     else "all-gather and chunk (CPU mesh)"),
        "argument_size_in_bytes": argument_bytes,
        # XLA's temporaries have no counterpart in an eager trace on meta
        "temp_size_in_bytes": None,
        "device": DEVICE,
    }


def run_combo(arch: str, shape_name: str, mesh_kind: str,
              force: bool = False) -> Dict[str, Any]:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh_kind}"
    out_json = RESULTS_DIR / f"{tag}.json"
    if out_json.exists() and not force:
        return json.loads(out_json.read_text())
    fake_group(MESH_WORLD[mesh_kind])
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type=MESH_DEVICE)
    info = trace_one(arch, shape_name, mesh)
    out_json.write_text(json.dumps(info, indent=1))
    print(f"[dryrun] {tag}: OK trace={info['trace_s']}s "
          f"flops={info['flops']:.3e} bytes={info['bytes_accessed']:.3e} "
          f"coll={info['coll_bytes']:.3e}", flush=True)
    return info


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.mesh == "both":
        # one process per mesh kind: the fake group is process-global
        rest = [a for a in (argv if argv is not None else sys.argv[1:])]
        i = rest.index("--mesh")
        rcs = [subprocess.run([sys.executable, "-m", __spec__.name,
                               *rest[:i], "--mesh", mk, *rest[i + 2:]]
                              ).returncode for mk in ("single", "multi")]
        raise SystemExit(max(rcs))

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    failures = []
    for arch in archs:
        for shape in shapes:
            if not shape_applicable(arch, shape):
                print(f"[dryrun] {arch}__{shape}: SKIP (full attention at "
                      f"long_500k)")
                continue
            try:
                run_combo(arch, shape, args.mesh, force=args.force)
            except Exception as e:      # report every combination
                traceback.print_exc()
                failures.append((arch, shape, args.mesh, repr(e)))
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("   ", f)
        raise SystemExit(1)
    print("[dryrun] all combinations traced.")


if __name__ == "__main__":
    main()
