"""Reference serving app sets shared by the examples and benchmarks.

One multitenant set spanning architecture families (dense, SSM, MoE, and a
two-stage VLM pipeline exercising DAG-aware scheduling) plus a single-model
smoke set — so ``examples/multitenant_serving.py`` and
``benchmarks/bench_serving.py`` sweep exactly the same tenants.

Copy of ``src/repro/serving/apps.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

from typing import List

from ..configs import get_config
from .engine import ServingApp
from .executor import ServedModel


def _mk(arch: str, **kw) -> ServedModel:
    return ServedModel(get_config(arch, reduced=True), **kw)


def smoke_apps() -> List[ServingApp]:
    """One small, fast-compiling model (CI smoke)."""
    return [ServingApp("chat", {"ssm/gen": _mk("mamba2-370m", prompt_len=16,
                                               gen_len=2)}, slack=0.8)]


def multitenant_apps() -> List[ServingApp]:
    """Four apps across architecture families sharing one cluster."""
    return [
        ServingApp("chat", {"chat/gen": _mk("minicpm-2b", prompt_len=32,
                                            gen_len=3)}, slack=0.8),
        ServingApp("complete", {"ssm/gen": _mk("mamba2-370m", prompt_len=32,
                                               gen_len=2)}, slack=1.2),
        ServingApp("moe", {"moe/gen": _mk("mixtral-8x22b", prompt_len=16,
                                          gen_len=2)}, slack=1.2),
        # two-stage pipeline: vision encode (stub embeds) -> caption decode
        ServingApp("caption",
                   {"vlm/embed": _mk("phi-3-vision-4.2b", prompt_len=16,
                                     gen_len=1),
                    "vlm/decode": _mk("phi3-mini-3.8b", prompt_len=16,
                                      gen_len=2)},
                   edges=(("vlm/embed", "vlm/decode"),), slack=1.5),
    ]
