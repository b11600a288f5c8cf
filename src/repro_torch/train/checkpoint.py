"""Checkpointing: pure-numpy .npz of a flattened tree + JSON manifest.

Port of ``src/repro/train/checkpoint.py``, in its file format and key
names, so that checkpoints cross-load between the two packages:
``step_%08d.npz`` beside ``manifest.json`` (``{"latest_step": step}``),
parameters keyed ``p/<path>`` and the optimizer state ``o/.step``,
``o/.mu/<path>`` and ``o/.nu/<path>``, where ``<path>`` is
``groups/0/wq`` and the like (``tree.leaves_with_paths``).  bf16 leaves
are staged through float32 (npz has no bf16; the widening is exact).
``restore`` checks shapes and casts each leaf to the dtype and device of
the tree it is given.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .tree import leaves_with_paths, map_with_path


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat = {}
    for path, leaf in leaves_with_paths(tree):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        flat["/".join(path)] = t.numpy()
    return flat


def save(path: str, step: int, params: Any, opt_state: Any = None) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, f"step_{step:08d}.npz"),
             **{f"p/{k}": v for k, v in _flatten(params).items()},
             **({f"o/{k}": v for k, v in _flatten(opt_state).items()}
                if opt_state is not None else {}))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"latest_step": step}, f)


def latest_step(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["latest_step"]


def restore(path: str, step: int, params_like: Any,
            opt_like: Any = None) -> Tuple[Any, Any]:
    with np.load(os.path.join(path, f"step_{step:08d}.npz")) as data:

        def rebuild(tree, prefix):
            def leaf(p, like):
                key = prefix + "/".join(p)
                arr = data[key]
                if arr.shape != tuple(like.shape):
                    raise ValueError(f"{key}: shape {arr.shape} != "
                                     f"{tuple(like.shape)}")
                return torch.from_numpy(arr).to(dtype=like.dtype,
                                                device=like.device)
            return map_with_path(leaf, tree)

        p = rebuild(params_like, "p/")
        o = rebuild(opt_like, "o/") if opt_like is not None else None
    return p, o
