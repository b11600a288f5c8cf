"""Parameter bridge from the JAX package's weights to the port's.

The JAX package draws its weights from ``jax.random``, which torch cannot
replay, so every parity test initialises once in JAX and brings the same
numbers across.  The tree arrives as numpy arrays with the JAX key names and
layout (``transformer.init_params``: stacked leading layer axis only for
groups of more than one layer) and leaves as torch tensors with the same
keys, shapes and dtypes.  ``np.asarray`` of a JAX bf16 array is an
ml_dtypes bfloat16 array, which torch cannot read directly: it is widened to
float32 (exact) and narrowed back to bfloat16 on the torch side.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                      device: DeviceLike = None) -> Any:
    """JAX params pytree of numpy arrays in, torch tensors out.

    Each leaf keeps the dtype the JAX tree gives it, never ``cfg.pdtype()``
    alone: the JAX package keeps the Mamba leaves ``A_log``, ``dt_bias``,
    ``conv_b`` and ``D`` in float32 whatever ``param_dtype`` is, and
    rounding them to bf16 would move the logits.  A leaf that is neither
    float32 nor the config's param dtype raises: the tree belongs to
    another configuration."""
    dev = resolve_device(device)
    allowed = {torch.float32, cfg.pdtype()}

    def walk(node: Any) -> Any:
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        arr = np.asarray(node)
        dtype = _DTYPES.get(arr.dtype.name)
        if dtype not in allowed:
            raise ValueError(f"{cfg.name}: parameter leaf of dtype "
                             f"{arr.dtype} is neither float32 nor the "
                             f"config's {cfg.param_dtype}")
        arr = np.ascontiguousarray(arr.astype(np.float32))
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)

    return walk(tree)
