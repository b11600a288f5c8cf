"""Weights from the seed, made on the device in one call per leaf.

A family's reference module lists its leaves (``leaves(dims)``: path in the
program's parameter tree, shape, dtype, how it is drawn).  ``fill`` draws
them, in that order, from one ``torch.Generator`` on the device: into the
program's own tensors (``into``, checked leaf for leaf, so that every
weight the program serves is the benchmark's), or into fresh tensors for
the reference after the window.  The same seed, shapes, dtypes and device
give the same numbers both times.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

Path_ = Tuple[Any, ...]
Leaf = Tuple[Path_, Tuple[int, ...], str, Tuple[Any, ...]]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def at(tree: Any, path: Path_) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree


def tree_paths(tree: Any, prefix: Path_ = ()) -> List[Path_]:
    """Every tensor leaf's path in a nest of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return [prefix]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [p for k, v in items for p in tree_paths(v, prefix + (k,))]


def _draw(t: torch.Tensor, init: Tuple[Any, ...],
          gen: torch.Generator) -> None:
    kind = init[0]
    if kind == "normal":
        t.normal_(0.0, float(init[1]), generator=gen)
    elif kind == "uniform":
        t.uniform_(float(init[1]), float(init[2]), generator=gen)
    elif kind == "log_uniform":            # log of U(lo, hi)
        t.uniform_(float(init[1]), float(init[2]), generator=gen).log_()
    elif kind == "dt_bias":                # softplus^-1 of log-uniform dt
        lo, hi = math.log(float(init[1])), math.log(float(init[2]))
        t.uniform_(lo, hi, generator=gen).exp_()
        t.add_(torch.log(-torch.expm1(-t)))
    else:
        raise ValueError(f"unknown init {init!r}")


def fill(leaves: List[Leaf], seed: int, device: torch.device,
         into: Optional[Any] = None) -> Dict[Path_, torch.Tensor]:
    """Draw every leaf; returns path -> tensor.  With ``into`` (the
    program's parameter tree) the leaves are drawn in place into its
    tensors, whose set, shapes, dtypes and layout have to be the plan's."""
    if into is not None:
        have = sorted(map(str, tree_paths(into)))
        want = sorted(str(p) for p, _, _, _ in leaves)
        if have != want:
            raise ValueError(f"the program's parameters {have} are not the "
                             f"benchmark's leaves {want}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out: Dict[Path_, torch.Tensor] = {}
    for path, shape, dtype, init in leaves:
        dt = DTYPES[dtype]
        if into is None:
            t = torch.empty(shape, dtype=dt, device=device)
        else:
            t = at(into, path)
            if (tuple(t.shape) != tuple(shape) or t.dtype != dt
                    or not t.is_contiguous() or t.device.type != device.type):
                raise ValueError(
                    f"leaf {path}: the program holds {tuple(t.shape)} "
                    f"{t.dtype} on {t.device} (contiguous "
                    f"{t.is_contiguous()}), the plan {tuple(shape)} {dtype}")
        with torch.no_grad():
            _draw(t, init, gen)
        out[path] = t
    return out
