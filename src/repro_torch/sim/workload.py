"""Workload generators reproducing §7.1 Table 1.

Four DAG classes:
  C1  single function, short exec, tight deadline        (user-facing)
  C2  single function, short exec, looser deadline       (non-critical UI)
  C3  chained functions, medium exec, relatively strict  (expensive UI)
  C4  branched DAG, high exec, loose deadline            (background batch)

Workload 1: Poisson arrivals whose mean rate is resampled every second.
Workload 2: sinusoidal rate  lam(t) = avg + amp * sin(2*pi*t / period).

Arrival sampling comes in two flavors:

* ``method="numpy"`` (default) — vectorized Lewis-Shedler thinning: sample a
  homogeneous Poisson process at the rate-function's upper bound and accept
  each point with probability rate(t)/max_rate.  Exact for any bounded rate
  function, O(expected arrivals) with numpy-level constants, and
  deterministic per seed across processes and platforms.
* ``method="legacy"`` — the original pure-Python dt=0.01 binning loop, kept
  as the reference implementation (the scheduler-equivalence goldens in
  ``tests/data/golden_equivalence.json`` were captured against it).

Copy of ``src/repro/sim/workload.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import math
import random
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.types import DagSpec, FunctionSpec

# ---------------------------------------------------------------------------
# Arrival processes (non-homogeneous Poisson)
# ---------------------------------------------------------------------------


class ArrivalProcess:
    def rate(self, t: float) -> float:
        raise NotImplementedError

    # -- vectorized interface ------------------------------------------------
    def rate_array(self, ts: "np.ndarray") -> "np.ndarray":
        """Vectorized ``rate``; subclasses override with numpy-native
        implementations.  The fallback maps the scalar rate (correct for any
        process, but slow)."""
        return np.fromiter((self.rate(float(t)) for t in ts),
                           dtype=np.float64, count=len(ts))

    def max_rate(self, t_end: float) -> float:
        """An upper bound on ``rate`` over [0, t_end] (thinning envelope)."""
        raise NotImplementedError

    def generate(self, t_end: float, rng: random.Random,
                 dt: float = 0.01) -> List[float]:
        """Legacy generator: per-``dt``-bin Poisson counts spread uniformly
        inside each bin (pure-Python reference implementation)."""
        out: List[float] = []
        t = 0.0
        while t < t_end:
            lam = max(0.0, self.rate(t)) * dt
            n = _poisson_sample(lam, rng)
            for _ in range(n):
                out.append(t + rng.random() * dt)
            t += dt
        out.sort()
        return out

    def generate_np(self, t_end: float,
                    rng: "np.random.Generator") -> "np.ndarray":
        """Vectorized exact NHPP sampling via thinning [Lewis & Shedler '79]:
        N ~ Poisson(lam_max * T) uniform candidate points, each kept with
        probability rate(t) / lam_max."""
        lam_max = float(self.max_rate(t_end))
        if lam_max <= 0.0 or t_end <= 0.0:
            return np.empty(0, dtype=np.float64)
        n = rng.poisson(lam_max * t_end)
        ts = rng.uniform(0.0, t_end, n)
        keep = rng.uniform(0.0, lam_max, n) < np.maximum(
            0.0, self.rate_array(ts))
        out = ts[keep]
        out.sort()
        return out


def _poisson_sample(lam: float, rng: random.Random) -> int:
    if lam <= 0:
        return 0
    if lam > 30:
        # normal approximation for large means
        return max(0, int(rng.gauss(lam, math.sqrt(lam)) + 0.5))
    L = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= L:
            return k
        k += 1


@dataclass
class ConstantRate(ArrivalProcess):
    rps: float

    def rate(self, t: float) -> float:
        return self.rps

    def rate_array(self, ts: "np.ndarray") -> "np.ndarray":
        return np.full(len(ts), self.rps)

    def max_rate(self, t_end: float) -> float:
        return self.rps


@dataclass
class Sinusoidal(ArrivalProcess):
    avg: float
    amplitude: float
    period: float
    phase: float = 0.0

    def rate(self, t: float) -> float:
        if not math.isfinite(self.period) or self.period <= 0:
            return self.avg
        return self.avg + self.amplitude * math.sin(
            2 * math.pi * t / self.period + self.phase)

    def rate_array(self, ts: "np.ndarray") -> "np.ndarray":
        if not math.isfinite(self.period) or self.period <= 0:
            return np.full(len(ts), self.avg)
        return self.avg + self.amplitude * np.sin(
            2 * math.pi * ts / self.period + self.phase)

    def max_rate(self, t_end: float) -> float:
        if not math.isfinite(self.period) or self.period <= 0:
            return self.avg
        return self.avg + abs(self.amplitude)


@dataclass
class OnOffRate(ArrivalProcess):
    rps: float
    on_duration: float
    off_duration: float

    def rate(self, t: float) -> float:
        phase = t % (self.on_duration + self.off_duration)
        return self.rps if phase < self.on_duration else 0.0

    def rate_array(self, ts: "np.ndarray") -> "np.ndarray":
        phase = ts % (self.on_duration + self.off_duration)
        return np.where(phase < self.on_duration, self.rps, 0.0)

    def max_rate(self, t_end: float) -> float:
        return self.rps


@dataclass
class PoissonResampled(ArrivalProcess):
    """Workload 1: mean rate resampled every ``resample_every`` seconds."""

    rps_range: Tuple[float, float]
    resample_every: float = 1.0
    seed: int = 0
    _cache: Dict[int, float] = field(default_factory=dict)

    def _rate_for_bin(self, k: int) -> float:
        v = self._cache.get(k)
        if v is None:
            r = random.Random((self.seed << 20) ^ k)
            lo, hi = self.rps_range
            v = self._cache[k] = lo + r.random() * (hi - lo)
        return v

    def rate(self, t: float) -> float:
        return self._rate_for_bin(int(t / self.resample_every))

    def _bin_rates(self, t_end: float) -> "np.ndarray":
        """Per-resample-bin rates covering [0, t_end], indexed by bin number
        directly (evaluating ``rate(k * resample_every)`` instead can land in
        bin k-1 when the bin width is not exactly representable), so both
        samplers see one rate function."""
        n_bins = int(t_end / self.resample_every) + 1
        return np.array([self._rate_for_bin(k) for k in range(n_bins)])

    def rate_array(self, ts: "np.ndarray") -> "np.ndarray":
        if len(ts) == 0:
            return np.empty(0)
        bins = self._bin_rates(float(ts.max()))
        k = (ts / self.resample_every).astype(np.int64)
        return bins[k]

    def max_rate(self, t_end: float) -> float:
        return float(self._bin_rates(t_end).max())


# ---------------------------------------------------------------------------
# Composable rate modulators (traffic scenarios, repro_torch.sim.traffic)
# ---------------------------------------------------------------------------
#
# Each wraps a base ArrivalProcess and reshapes its rate function with a
# deterministic envelope, keeping the full vectorized interface (``rate`` /
# ``rate_array`` / ``max_rate``) so the Lewis-Shedler thinning generator
# stays exact.  All are plain dataclasses: picklable (run_sweep workers) and
# freely nestable (e.g. DiurnalRate over BurstRate over ConstantRate).


@dataclass
class ScaledRate(ArrivalProcess):
    """``factor x`` the base process's instantaneous rate (Zipf-skewed
    multi-tenant mixes reweight tenants with this)."""

    base: ArrivalProcess
    factor: float

    def rate(self, t: float) -> float:
        return self.factor * self.base.rate(t)

    def rate_array(self, ts: "np.ndarray") -> "np.ndarray":
        return self.factor * self.base.rate_array(ts)

    def max_rate(self, t_end: float) -> float:
        return max(0.0, self.factor) * self.base.max_rate(t_end)


@dataclass
class DiurnalRate(ArrivalProcess):
    """Day-cycle envelope: ``base.rate(t) * (1 + depth*sin(2pi t/period +
    phase))``.  ``depth`` in [0, 1) keeps the rate non-negative; the default
    phase starts the run at the trough so one ``period`` spans
    trough → peak → trough (a compressed diurnal day)."""

    base: ArrivalProcess
    period: float
    depth: float = 0.6
    phase: float = -math.pi / 2.0

    def _env(self, t: float) -> float:
        return 1.0 + self.depth * math.sin(
            2.0 * math.pi * t / self.period + self.phase)

    def rate(self, t: float) -> float:
        return self.base.rate(t) * self._env(t)

    def rate_array(self, ts: "np.ndarray") -> "np.ndarray":
        env = 1.0 + self.depth * np.sin(
            2.0 * math.pi * ts / self.period + self.phase)
        return self.base.rate_array(ts) * env

    def max_rate(self, t_end: float) -> float:
        return self.base.max_rate(t_end) * (1.0 + abs(self.depth))


@dataclass
class BurstRate(ArrivalProcess):
    """Flash-crowd envelope: rate is amplified ``amplify``x inside
    ``[at, at + duration)`` with linear ``ramp``-second edges (crowds build
    and disperse; a square wave would be a step discontinuity in the
    thinning envelope)."""

    base: ArrivalProcess
    at: float
    duration: float
    amplify: float = 8.0
    ramp: float = 0.0

    def _env(self, t: float) -> float:
        if t < self.at or t >= self.at + self.duration:
            return 1.0
        m = 1.0
        if self.ramp > 0.0:
            m = min(1.0, (t - self.at) / self.ramp,
                    (self.at + self.duration - t) / self.ramp)
        return 1.0 + (self.amplify - 1.0) * m

    def rate(self, t: float) -> float:
        return self.base.rate(t) * self._env(t)

    def rate_array(self, ts: "np.ndarray") -> "np.ndarray":
        inside = (ts >= self.at) & (ts < self.at + self.duration)
        if self.ramp > 0.0:
            m = np.minimum(1.0, np.minimum(
                (ts - self.at) / self.ramp,
                (self.at + self.duration - ts) / self.ramp))
        else:
            m = 1.0
        env = np.where(inside, 1.0 + (self.amplify - 1.0) * m, 1.0)
        return self.base.rate_array(ts) * env

    def max_rate(self, t_end: float) -> float:
        peak = max(1.0, self.amplify) if t_end > self.at else 1.0
        return self.base.max_rate(t_end) * peak


@dataclass
class WindowedRate(ArrivalProcess):
    """Tenant lifetime window: the base rate inside ``[start, end)``, zero
    outside (tenants arriving and departing mid-run)."""

    base: ArrivalProcess
    start: float = 0.0
    end: Optional[float] = None

    def rate(self, t: float) -> float:
        if t < self.start or (self.end is not None and t >= self.end):
            return 0.0
        return self.base.rate(t)

    def rate_array(self, ts: "np.ndarray") -> "np.ndarray":
        alive = ts >= self.start
        if self.end is not None:
            alive &= ts < self.end
        return np.where(alive, self.base.rate_array(ts), 0.0)

    def max_rate(self, t_end: float) -> float:
        return self.base.max_rate(t_end)


# ---------------------------------------------------------------------------
# Paper DAG classes
# ---------------------------------------------------------------------------


def make_paper_dag(cls: str, dag_id: str, rng: random.Random,
                   setup_range: Tuple[float, float] = (0.125, 0.400),
                   ) -> DagSpec:
    """Sample a DAG from class C1..C4 per Table 1.

    Exec-time/slack ranges (seconds):
      C1: exec [0.050,0.100], slack [0.100,0.150], single fn
      C2: exec [0.100,0.200], slack [0.300,0.500], single fn
      C3: exec [0.250,0.400] total over a 2-chain, slack [0.200,0.300]
      C4: exec [0.300,0.600] per fn over a branched 4-fn DAG,
          slack [0.500,1.000]
    Sandbox setup overheads sampled from [125,400] ms (§7.1).
    """
    u = lambda lo, hi: lo + rng.random() * (hi - lo)
    setup = u(*setup_range)
    if cls == "C1":
        e = u(0.050, 0.100)
        fns = (FunctionSpec(f"{dag_id}/f0", e, mem_mb=128, setup_time=setup),)
        edges: Tuple[Tuple[str, str], ...] = ()
        cp = e
        slack = u(0.100, 0.150)
    elif cls == "C2":
        e = u(0.100, 0.200)
        fns = (FunctionSpec(f"{dag_id}/f0", e, mem_mb=128, setup_time=setup),)
        edges = ()
        cp = e
        slack = u(0.300, 0.500)
    elif cls == "C3":
        total = u(0.250, 0.400)
        e0, e1 = total * 0.5, total * 0.5
        fns = (FunctionSpec(f"{dag_id}/f0", e0, mem_mb=128, setup_time=setup),
               FunctionSpec(f"{dag_id}/f1", e1, mem_mb=128, setup_time=setup))
        edges = ((f"{dag_id}/f0", f"{dag_id}/f1"),)
        cp = total
        slack = u(0.200, 0.300)
    elif cls == "C4":
        total = u(0.300, 0.600)     # Table 1 exec time is per-DAG total
        e = [total / 4.0] * 4
        names = [f"{dag_id}/f{i}" for i in range(4)]
        fns = tuple(FunctionSpec(n, t, mem_mb=256, setup_time=setup)
                    for n, t in zip(names, e))
        # diamond: f0 -> (f1, f2) -> f3
        edges = ((names[0], names[1]), (names[0], names[2]),
                 (names[1], names[3]), (names[2], names[3]))
        cp = e[0] + max(e[1], e[2]) + e[3]
        slack = u(0.500, 1.000)
    else:
        raise ValueError(f"unknown class {cls}")
    return DagSpec(dag_id=dag_id, functions=fns, edges=edges,
                   deadline=cp + slack)


@dataclass
class WorkloadSpec:
    """A set of (DAG, arrival process) tenants plus a duration."""

    tenants: List[Tuple[DagSpec, ArrivalProcess]]
    duration: float

    def _tenant_seed(self, seed: int, i: int) -> int:
        return (seed << 16) ^ (i * 2654435761 & 0xFFFFFFFF)

    def generate_arrays(self, seed: int = 0
                        ) -> Tuple["np.ndarray", "np.ndarray",
                                   List[DagSpec]]:
        """Vectorized arrival generation: returns time-sorted arrival times,
        the per-arrival tenant index, and the tenant DAG list.  The runner
        streams straight off these arrays without materializing per-arrival
        tuples or closures."""
        times: List[np.ndarray] = []
        idxs: List[np.ndarray] = []
        dags: List[DagSpec] = []
        for i, (dag, proc) in enumerate(self.tenants):
            rng = np.random.default_rng(self._tenant_seed(seed, i))
            ts = proc.generate_np(self.duration, rng)
            times.append(ts)
            idxs.append(np.full(len(ts), i, dtype=np.int64))
            dags.append(dag)
        all_t = np.concatenate(times) if times else np.empty(0)
        all_i = np.concatenate(idxs) if idxs else np.empty(0, dtype=np.int64)
        order = np.argsort(all_t, kind="stable")
        return all_t[order], all_i[order], dags

    def generate(self, seed: int = 0,
                 method: str = "numpy") -> List[Tuple[float, DagSpec]]:
        """All (arrival_time, dag) pairs across tenants, time-sorted.

        ``method="numpy"`` (default) uses vectorized thinning;
        ``method="legacy"`` is the original per-dt-bin Python loop (the
        reference for the scheduler-equivalence goldens).
        """
        if method == "numpy":
            ts, idx, dags = self.generate_arrays(seed)
            return [(t, dags[i]) for t, i in zip(ts.tolist(), idx.tolist())]
        if method != "legacy":
            raise ValueError(f"unknown generation method {method!r}")
        out: List[Tuple[float, DagSpec]] = []
        for i, (dag, proc) in enumerate(self.tenants):
            sub = random.Random(self._tenant_seed(seed, i))
            for t in proc.generate(self.duration, sub):
                out.append((t, dag))
        out.sort(key=lambda p: p[0])
        return out

    def offered_core_load(self) -> float:
        """Mean core-seconds demanded per second (for utilization checks)."""
        total = 0.0
        for dag, proc in self.tenants:
            # average rate over the duration (coarse numeric mean)
            n = 200
            mean_rate = sum(max(0.0, proc.rate(self.duration * k / n))
                            for k in range(n)) / n
            work = sum(f.exec_time for f in dag.functions)
            total += mean_rate * work
        return total


# -- the two macro workloads (§7.1), scalable for small machines ------------


def paper_workload_1(duration: float = 30.0, scale: float = 1.0,
                     dags_per_class: int = 2, seed: int = 7) -> WorkloadSpec:
    """Poisson arrivals; mean resampled each second from per-class ranges."""
    rng = random.Random(seed)
    ranges = {"C1": (800, 1200), "C2": (600, 900),
              "C3": (600, 800), "C4": (50, 150)}
    tenants = []
    for cls, (lo, hi) in ranges.items():
        for k in range(dags_per_class):
            dag = make_paper_dag(cls, f"{cls}-{k}", rng)
            # stable per-tenant seed: builtin hash() is salted per process
            # (PYTHONHASHSEED), which silently made every run irreproducible
            proc = PoissonResampled(
                (lo * scale / dags_per_class, hi * scale / dags_per_class),
                seed=seed ^ zlib.crc32(f"{cls}-{k}".encode()) & 0xFFFF)
            tenants.append((dag, proc))
    return WorkloadSpec(tenants, duration)


def paper_workload_2(duration: float = 30.0, scale: float = 1.0,
                     dags_per_class: int = 2, seed: int = 11) -> WorkloadSpec:
    """Sinusoidal arrivals with Table 1 parameters."""
    rng = random.Random(seed)
    params = {  # avg-range, amplitude-range, period-range
        "C1": ((600, 1200), (100, 800), (10, 20)),
        "C2": ((400, 800), (200, 400), (30, 40)),
        "C3": ((500, 1000), (200, 600), (10, 20)),
        "C4": ((200, 200), (0, 0), (math.inf, math.inf)),
    }
    u = lambda lo, hi: lo if lo == hi else lo + rng.random() * (hi - lo)
    tenants = []
    for cls, (avg_r, amp_r, per_r) in params.items():
        for k in range(dags_per_class):
            dag = make_paper_dag(cls, f"{cls}-{k}", rng)
            avg = u(*avg_r) * scale / dags_per_class
            amp = u(*amp_r) * scale / dags_per_class
            per = u(*per_r) if math.isfinite(per_r[0]) else math.inf
            # keep instantaneous rate non-negative; random phase decorrelates
            # tenant peaks (utilization oscillates rather than spiking as one)
            amp = min(amp, avg)
            tenants.append((dag, Sinusoidal(avg, amp, per,
                                            phase=rng.random() * 2 * math.pi)))
    return WorkloadSpec(tenants, duration)
