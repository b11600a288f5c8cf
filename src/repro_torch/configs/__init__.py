"""Architecture registry: the 10 assigned architectures (+ reduced variants).

Value copies of ``src/repro/configs/*.py`` (that package imports jax through
``repro.models.config``).  Every entry cites its source in the module
docstring of its config file.

``ARCH_IDS`` are the configs with a twin in the JAX package, which tests
hold the port to.  ``PORT_ONLY_IDS`` are configs the port alone runs, whose
architecture the JAX package's ``ModelConfig`` cannot state (granite-4.0-h's
per-layer pattern, NoPE and muP multipliers); ``get_config`` resolves both,
``all_configs`` the JAX twins only.  A port-only config is held to a plain
reference instead (``portbench/reference/``).
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..models.config import ModelConfig
from . import (gemma3_1b, granite_4p0_h_micro, llama4_scout_17b,
               mamba2_370m, minicpm_2b, minitron_8b, mixtral_8x22b,
               phi3_mini_3p8b, phi3_vision_4p2b, whisper_tiny, zamba2_1p2b)

_MODULES = {
    "minicpm-2b": minicpm_2b,
    "whisper-tiny": whisper_tiny,
    "phi3-mini-3.8b": phi3_mini_3p8b,
    "gemma3-1b": gemma3_1b,
    "minitron-8b": minitron_8b,
    "phi-3-vision-4.2b": phi3_vision_4p2b,
    "zamba2-1.2b": zamba2_1p2b,
    "llama4-scout-17b-a16e": llama4_scout_17b,
    "mamba2-370m": mamba2_370m,
    "mixtral-8x22b": mixtral_8x22b,
}

_PORT_ONLY = {
    "granite-4.0-h-micro": granite_4p0_h_micro,
}

ARCH_IDS = tuple(_MODULES)
PORT_ONLY_IDS = tuple(_PORT_ONLY)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    m = _MODULES.get(arch) or _PORT_ONLY.get(arch)
    if m is None:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(_MODULES) + sorted(_PORT_ONLY)}")
    return m.REDUCED if reduced else m.CONFIG


def all_configs(reduced: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, reduced) for a in ARCH_IDS}


# ---------------------------------------------------------------------------
# Input shapes assigned to this paper
# ---------------------------------------------------------------------------

INPUT_SHAPES: Dict[str, Tuple[int, int, str]] = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention state: run only where the cache is
# bounded (SWA / SSM / hybrid); skip for pure full-attention archs (the JAX
# package's rule, src/repro/configs/__init__.py)
LONG_CONTEXT_ARCHS = ("gemma3-1b", "zamba2-1.2b", "mamba2-370m",
                      "mixtral-8x22b")


def shape_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True
