"""Parameter bridge from the JAX package's weights to the port's.

The JAX package draws its weights from ``jax.random``, which torch cannot
replay, so every parity test initialises once in JAX and brings the same
numbers across.  The tree arrives as numpy arrays with the JAX key names and
layout (``transformer.init_params``: stacked leading layer axis only for
groups of more than one layer) and leaves as torch tensors with the same
keys, shapes and dtypes.  numpy has no bfloat16 that torch reads, so bf16
leaves may come staged through float32 (exact, as the JAX package's
``train/checkpoint.py`` does) or as ml_dtypes bfloat16 arrays.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig

def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                      device: DeviceLike = None) -> Any:
    """JAX params pytree of numpy arrays in, torch tensors of the config's
    param dtype out (every leaf of the layers ported so far has it)."""
    dev = resolve_device(device)

    def walk(node: Any) -> Any:
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        arr = np.ascontiguousarray(np.asarray(node).astype(np.float32))
        return torch.from_numpy(arr).to(device=dev, dtype=cfg.pdtype())

    return walk(tree)
