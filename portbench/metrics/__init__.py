"""Per-layer metrics, one file each: ``metrics/<name>.py`` sets ``LAYER``
(as ``PERF.md``'s list of layers names it), ``MOVES`` (the end-to-end
metric it should move), ``UNIT``, ``SOURCE`` and ``BETTER``, and defines
``read(run) -> float | None`` over a ``record.Run``.  A reader that finds
nothing to read returns None and the metric is left out of the result; a
share of a roofline or a peak is never reported as 0 for want of data."""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple

from .. import peaks

HERE = Path(__file__).resolve().parent


def load(name: str, root: Path = HERE.parents[1]) -> ModuleType:
    """The reader ``portbench/metrics/<name>.py`` under ``root``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no reader for per-layer metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def event_flops(run, kinds=("join", "step")) -> List[Tuple[float, float]]:
    """(seconds the program measured, the model's operations) of each
    join and step of the window of the kinds asked."""
    out = []
    P = int(run.traffic["prompt_len"])
    for e, keys in zip(run.events, run.keys):
        if e.kind not in kinds:
            continue
        f = (run.counts.join_flops(run.dims, len(e.rows), P)
             if e.kind == "join" else run.counts.step_flops(run.dims, keys))
        out.append((e.seconds, f))
    return out


def roofline_pct(run, kernel: str, patterns) -> object:
    """A kernel's bound over its device time in the profiled slice: the
    bound sums each launch's, over the joins and steps inside the slice;
    the time sums the kernels whose names hold one of ``patterns``."""
    if run.slice is None:
        return None
    t = sum(v for n, v in run.slice.kernel_s.items()
            if any(p in n for p in patterns))
    P = int(run.traffic["prompt_len"])
    bound = 0.0
    for e, keys in zip(run.events, run.keys):
        if not e.in_slice:
            continue
        work: Dict[str, list] = (
            run.counts.join_launches(run.dims, len(e.rows), P)
            if e.kind == "join" else run.counts.step_launches(run.dims, keys))
        bound += sum(peaks.bound_s(f, b) for f, b in work.get(kernel, ()))
    if t <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / t
