"""A run's record and the end-to-end arithmetic over it.

Every end-to-end metric is the benchmark's own arithmetic over
per-request records on the system's clock (arrival, completion, the end of
the request's join) and over the window's wall time; none is read from
the program's summaries.  A request that did not complete counts as
missing: its latency and time to first token run to the end of the run's
clock, and it misses its limit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Run:
    """What a run left for the metrics to read."""

    cell: str
    traffic: Dict[str, Any]
    dims: Dict[str, Any]
    counts: Any                     # counts/<family>.py
    setup_s: float
    wall_s: float                   # the window's wall seconds
    horizon: float                  # the run's end on the system's clock
    arrival: np.ndarray             # (n,) system clock, s
    completion: np.ndarray          # (n,) NaN where not completed
    first_token: np.ndarray         # (n,) end of the request's join, NaN
    cold_starts: int
    queuing: np.ndarray             # (n,) per-request queuing delay, s
    counters: Dict[str, int]
    events: List[Any]               # system.Event, in order
    keys: List[Optional[List[int]]]  # per event: keys each step row attends
    slice: Any = None               # profiling.Slice of a traced run

    @property
    def limit_s(self) -> float:
        return float(self.traffic["limit_ms"]) / 1e3

    @property
    def tokens_per_request(self) -> int:
        """The join's token and one per decode step."""
        return int(self.traffic["gen_len"]) + 1


def nearest_rank(xs: np.ndarray, p: float) -> float:
    """The p-th percentile by nearest rank (the ceil(p/100 · n)-th
    smallest)."""
    s = np.sort(np.asarray(xs, dtype=np.float64))
    k = max(1, math.ceil(p / 100.0 * len(s)))
    return float(s[k - 1])


def latencies(run: Run) -> np.ndarray:
    done = np.where(np.isnan(run.completion), run.horizon, run.completion)
    return done - run.arrival


def ttfts(run: Run) -> np.ndarray:
    first = np.where(np.isnan(run.first_token), run.horizon, run.first_token)
    return first - run.arrival


def latency_p95_ms(run: Run) -> float:
    return nearest_rank(latencies(run), 95) * 1e3


def ttft_p95_ms(run: Run) -> float:
    return nearest_rank(ttfts(run), 95) * 1e3


def deadline_met_pct(run: Run) -> float:
    met = ~np.isnan(run.completion) & (latencies(run) <= run.limit_s + 1e-9)
    return 100.0 * float(met.sum()) / len(run.arrival)


def tokens_per_s(run: Run) -> float:
    done = int((~np.isnan(run.completion)).sum())
    return done * run.tokens_per_request / run.wall_s


def setup_s(run: Run) -> float:
    return run.setup_s


END_TO_END = {f.__name__: f for f in (latency_p95_ms, ttft_p95_ms,
                                       deadline_met_pct, tokens_per_s,
                                       setup_s)}
