"""Traffic from the seed: arrival instants, prompts and the check's sample.

The arrival schedule is an open loop (independent users) with exponential
gaps at the mix's rate.  So that the seed changes the order of the work and
not its amount, every seed gets the same gaps: ``n = round(rps *
seconds)`` requests whose gaps are the exponential distribution's
quantiles at ``(k + 1/2) / n``, scaled to span ``seconds``, in one fixed
shuffled order (``PATTERN``) that the seed rotates.  A fresh shuffle per
seed moved the tails by seed far more than between two runs of one seed
(the bursts it happened to make); a rotation keeps the bursts and moves
them in time, so every seed replays the same bursts at other instants.
The schedule starts ``UPLOAD_S`` after the run's start on the system's
clock: the DAG's upload proactively allocates the mix's sandboxes
(``prewarm_per_fn``), which are ready before the first request comes.
Prompts are uniform token ids drawn from the seed.  None of this reads
the program: a change to ``repro_torch/sim/workload.py`` cannot change
the traffic.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

# independent streams of one seed
_ARRIVALS, _PROMPTS, _SAMPLE, _WEIGHTS, _CALIB = range(5)
PATTERN = 0             # the seed of the one shuffled order of the gaps
UPLOAD_S = 10.0         # the DAG's upload to the first arrival, system clock


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def arrivals(traffic: Dict[str, Any], seconds: float, seed: int
             ) -> np.ndarray:
    """Sorted arrival instants in [UPLOAD_S, UPLOAD_S + seconds) on the
    system's clock."""
    n = max(1, int(round(float(traffic["rps"]) * seconds)))
    k = np.arange(n, dtype=np.float64)
    gaps = rng(PATTERN, _ARRIVALS).permutation(-np.log1p(-(k + 0.5) / n))
    gaps = np.roll(gaps, int(rng(seed, _ARRIVALS).integers(n)))
    gaps *= seconds / gaps.sum()
    return UPLOAD_S + np.cumsum(gaps) - gaps[0]


def prompts(traffic: Dict[str, Any], n: int, vocab: int, seed: int
            ) -> np.ndarray:
    """(n, prompt_len) int64 token ids, one row per request."""
    return rng(seed, _PROMPTS).integers(
        0, vocab, (n, int(traffic["prompt_len"])), dtype=np.int64)


def calibration_prompts(traffic: Dict[str, Any], n: int, vocab: int,
                        seed: int) -> np.ndarray:
    """Prompts for the program's own set-up runs (calibration)."""
    return rng(seed, _CALIB).integers(
        0, vocab, (n, int(traffic["prompt_len"])), dtype=np.int64)


def check_sample(n: int, k: int, seed: int) -> np.ndarray:
    """Rows of ``k`` of the ``n`` requests, drawn from the seed, sorted.
    Every request of a mix has the same lengths, so any row is among the
    longest."""
    k = min(k, n)
    return np.sort(rng(seed, _SAMPLE).choice(n, size=k, replace=False))


def weight_seed(seed: int) -> int:
    """The seed of the torch generator the weights are drawn with."""
    return int(rng(seed, _WEIGHTS).integers(0, 2 ** 62))
