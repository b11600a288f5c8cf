"""Sandbox demand estimation (§4.3.1).

Each SGS continuously records the per-function arrival rate over a fixed
interval (100 ms in the prototype) and maintains an EWMA estimate.  Given the
SLA percentile (e.g. 99%), the number of sandboxes to keep proactively
allocated is the Poisson inverse-CDF at that percentile over the interval,
scaled up when a function's execution time overflows the interval (requests
from interval *k* still occupy sandboxes during interval *k+1*...).

Copy of ``src/repro/core/estimator.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict


def poisson_ppf(p: float, lam: float, max_n: int = 100_000) -> int:
    """Smallest n with  P[X <= n] >= p  for X ~ Poisson(lam).

    Pure-python CDF walk (no scipy dependency); numerically stable via
    multiplicative pmf recurrence pmf(k) = pmf(k-1) * lam / k.
    """
    if not 0.0 <= p < 1.0:
        raise ValueError(f"p must be in [0,1), got {p}")
    if lam < 0:
        raise ValueError(f"lam must be >= 0, got {lam}")
    if lam == 0.0:
        return 0
    if lam > 50:
        # normal approximation with continuity correction for the far tail,
        # refined by an exact walk from the approximate point.
        from statistics import NormalDist

        z = NormalDist().inv_cdf(p)
        n = int(lam + z * math.sqrt(lam) + 0.5)
        n = max(n, 0)
        # refine: walk until CDF crosses p (cheap: few steps)
        return _refine_ppf(p, lam, n, max_n)
    # exact walk from 0
    pmf = math.exp(-lam)
    cdf = pmf
    n = 0
    while cdf < p and n < max_n:
        n += 1
        pmf *= lam / n
        cdf += pmf
    return n


def _poisson_cdf(lam: float, n: int) -> float:
    pmf = math.exp(-lam)
    cdf = pmf
    for k in range(1, n + 1):
        pmf *= lam / k
        cdf += pmf
    return cdf


def _refine_ppf(p: float, lam: float, n0: int, max_n: int) -> int:
    n = max(n0, 0)
    cdf = _poisson_cdf(lam, n)
    if cdf >= p:
        while n > 0 and _poisson_cdf(lam, n - 1) >= p:
            n -= 1
        return n
    while cdf < p and n < max_n:
        n += 1
        cdf = _poisson_cdf(lam, n)
    return n


@dataclass(slots=True)
class RateEstimator:
    """EWMA arrival-rate estimator over fixed measurement intervals."""

    interval: float = 0.100        # 100 ms (§4.3.1)
    alpha: float = 0.3             # EWMA weight on the newest measurement

    _count: int = 0
    _window_start: float = 0.0
    _rate: float = 0.0             # requests / second
    _initialized: bool = False

    def record_arrival(self, now: float) -> None:
        # fast path: no window boundary crossed since the last sample (the
        # overwhelmingly common case on the per-invocation hot path)
        if now - self._window_start >= self.interval:
            self._roll(now)
        self._count += 1

    def rate(self, now: float) -> float:
        """Current EWMA estimate in requests/second."""
        self._roll(now)
        return self._rate

    def _roll(self, now: float) -> None:
        # close out any fully elapsed windows
        while now - self._window_start >= self.interval:
            measured = self._count / self.interval
            if not self._initialized:
                # first window: adopt the measurement directly
                if self._count > 0:
                    self._rate = measured
                    self._initialized = True
            else:
                self._rate = self.alpha * measured + (1 - self.alpha) * self._rate
            self._count = 0
            self._window_start += self.interval


@dataclass
class DemandEstimator:
    """Per-function sandbox demand (Fig. 5): EWMA rate -> Poisson ppf @ SLA."""

    sla: float = 0.99
    interval: float = 0.100
    alpha: float = 0.3
    _rates: Dict[str, RateEstimator] = field(default_factory=dict)

    def _est(self, fn_name: str) -> RateEstimator:
        est = self._rates.get(fn_name)
        if est is None:
            est = self._rates[fn_name] = RateEstimator(self.interval,
                                                       self.alpha)
        return est

    def record_arrival(self, fn_name: str, now: float) -> None:
        # hand-inlined _est + RateEstimator.record_arrival: this runs once
        # per function invocation
        est = self._rates.get(fn_name)
        if est is None:
            est = self._rates[fn_name] = RateEstimator(self.interval,
                                                       self.alpha)
        if now - est._window_start >= est.interval:
            est._roll(now)
        est._count += 1

    def rate(self, fn_name: str, now: float) -> float:
        return self._est(fn_name).rate(now)

    def demand(self, fn_name: str, exec_time: float, now: float) -> int:
        """Minimum number of sandboxes so that, with probability >= sla, every
        request arriving in the next interval finds a sandbox.

        The paper takes the Poisson inverse CDF of the per-interval arrival
        count at the SLA, then scales up for requests that overflow the
        interval (exec_time > T).  The two steps combine into one via
        Little's law: the number of in-flight requests (busy sandboxes) at
        any instant is Poisson with mean  rate * max(T, exec_time), so the
        inverse CDF of *that* distribution is the demand.  (The naive
        ppf(rate*T) * ceil(exec/T) over-counts by up to ~2x at high rates
        because tail mass doesn't scale linearly across windows.)
        """
        occupancy_window = max(self.interval, exec_time)
        lam = self.rate(fn_name, now) * occupancy_window
        return poisson_ppf(self.sla, lam)
