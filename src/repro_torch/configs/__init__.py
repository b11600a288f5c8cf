"""Architecture registry: the 10 assigned architectures (+ reduced variants).

Value copies of ``src/repro/configs/*.py`` (that package imports jax through
``repro.models.config``).  Every entry cites its source in the module
docstring of its config file.
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..models.config import ModelConfig
from . import (gemma3_1b, llama4_scout_17b, mamba2_370m, minicpm_2b,
               minitron_8b, mixtral_8x22b, phi3_mini_3p8b, phi3_vision_4p2b,
               whisper_tiny, zamba2_1p2b)

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

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    m = _MODULES[arch]
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
