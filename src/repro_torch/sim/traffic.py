"""Traffic scenarios: realistic arrival shapes as a sweepable axis.

Dirigent's yardstick (PAPERS.md) is that cluster managers are judged under
churn and bursts, not steady state, and NOAH shows scheduling verdicts flip
under bursty workload-adaptive traffic — so traffic shapes are first-class
here, not hand-edited workload kwargs.  A *scenario* is a registered, seeded
transformation of a :class:`~repro_torch.sim.workload.WorkloadSpec`: it rewrites
tenants' :class:`~repro_torch.sim.workload.ArrivalProcess`\\ es with the composable
rate modulators (``DiurnalRate``/``BurstRate``/``WindowedRate``/
``ScaledRate``) and may add or retire tenants outright.

Scenarios are carried on ``Experiment.traffic`` — a registered name
(``"flash_crowd"``) or a :class:`TrafficSpec` with kwargs — so they sweep
and parallelize like any other field:

    run_sweep(base, {"traffic": ["steady", "diurnal", "flash_crowd"],
                     "stack": ["archipelago", "sparrow"]})

Built-in scenarios (all seeded through ``TrafficSpec.seed``, independent of
``Experiment.seed`` so arrival draws vary per cell while the scenario shape
stays fixed):

* ``steady`` — identity (explicit no-op baseline for matrices).
* ``diurnal`` — a shared day-cycle envelope over every tenant (correlated
  trough → peak → trough across the run).
* ``flash_crowd`` — a seeded fraction of tenants is amplified ``amplify``x
  inside a burst window (the crowd hits specific applications).
* ``tenant_churn`` — a seeded fraction of tenants departs mid-run and fresh
  tenants (new DAG ids, never seen at t=0) arrive mid-run.
* ``zipf_mix`` — per-tenant rates reweighted by a seeded Zipf permutation
  (skewed multi-tenant popularity), mean factor 1 so aggregate load is
  comparable to the unskewed run.

New scenarios register with :func:`register_traffic`, mirroring the
stack/backend/fault registries (docs/SCENARIOS.md)::

    @register_traffic("my_shape")
    def my_shape(spec, rng, **kwargs):    # -> new WorkloadSpec
        ...

Copy of ``src/repro/sim/traffic.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Tuple, Union

from .workload import (ArrivalProcess, BurstRate, DiurnalRate, ScaledRate,
                       WindowedRate, WorkloadSpec, make_paper_dag)

__all__ = [
    "TrafficSpec", "register_traffic", "get_traffic", "available_traffic",
    "apply_traffic",
]


def _freeze_kwargs(kw: Mapping[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted(kw.items()))


@dataclass(frozen=True)
class TrafficSpec:
    """One declarative traffic scenario: a registered name plus kwargs.

    Frozen with kwargs as a sorted tuple of pairs (the ``FaultEvent``
    convention) so specs hash, pickle (``run_sweep`` workers) and compare
    cleanly.  ``seed`` drives only the scenario's own choices (which tenants
    burst/churn, Zipf rank order) — arrival sampling stays on the
    experiment's seed."""

    name: str
    kwargs: Tuple[Tuple[str, Any], ...] = ()
    seed: int = 0

    def arg_dict(self) -> Dict[str, Any]:
        return dict(self.kwargs)

    def label(self) -> str:
        return self.name

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "kwargs": dict(self.kwargs),
                "seed": self.seed}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TrafficSpec":
        return cls(name=d["name"], kwargs=_freeze_kwargs(d.get("kwargs", {})),
                   seed=d.get("seed", 0))


def scenario(name: str, seed: int = 0, **kwargs: Any) -> TrafficSpec:
    """Convenience constructor: ``scenario("flash_crowd", amplify=4.0)``."""
    return TrafficSpec(name=name, kwargs=_freeze_kwargs(kwargs), seed=seed)


# -- registry (mirrors stacks/backends/faults) -------------------------------

# builder(spec, rng, **kwargs) -> new WorkloadSpec
TrafficBuilder = Callable[..., WorkloadSpec]

_TRAFFIC: Dict[str, TrafficBuilder] = {}


def register_traffic(name: str, *aliases: str
                     ) -> Callable[[TrafficBuilder], TrafficBuilder]:
    """Decorator: make a scenario constructible by name through
    ``Experiment(traffic=name)``.  Raises on duplicate registration."""

    def deco(fn: TrafficBuilder) -> TrafficBuilder:
        names = (name, *aliases)
        taken = [n for n in names if n in _TRAFFIC]
        if taken:       # validate before inserting: no partial registration
            raise ValueError(
                f"traffic scenario {taken[0]!r} is already registered")
        for n in names:
            _TRAFFIC[n] = fn
        return fn

    return deco


def get_traffic(name: str) -> TrafficBuilder:
    try:
        return _TRAFFIC[name]
    except KeyError:
        raise ValueError(
            f"unknown traffic scenario {name!r}; registered scenarios: "
            f"{', '.join(sorted(_TRAFFIC))}") from None


def available_traffic() -> List[str]:
    return sorted(_TRAFFIC)


def apply_traffic(spec: WorkloadSpec,
                  traffic: Union[str, TrafficSpec]) -> WorkloadSpec:
    """Resolve and apply one scenario to a resolved workload spec.  A bare
    string is shorthand for ``TrafficSpec(name)`` with default kwargs."""
    ts = TrafficSpec(name=traffic) if isinstance(traffic, str) else traffic
    builder = get_traffic(ts.name)
    return builder(spec, random.Random(ts.seed), **ts.arg_dict())


# -- built-in scenarios ------------------------------------------------------


@register_traffic("steady")
def steady(spec: WorkloadSpec, rng: random.Random) -> WorkloadSpec:
    """Identity scenario: the explicit no-op baseline of a scenario matrix
    (``traffic=None`` skips the subsystem entirely and is decision-identical
    to pre-scenario runs; ``"steady"`` routes through it)."""
    return WorkloadSpec(list(spec.tenants), spec.duration)


@register_traffic("diurnal")
def diurnal(spec: WorkloadSpec, rng: random.Random, period: float = 0.0,
            depth: float = 0.6,
            phase: float = -math.pi / 2.0) -> WorkloadSpec:
    """Correlated day-cycle load: every tenant's rate swings together
    between ``(1-depth)x`` and ``(1+depth)x`` — the whole-population
    utilization wave autoscalers are sized against.  ``period`` defaults to
    the run duration (one compressed day per run)."""
    per = period if period > 0.0 else spec.duration
    tenants = [(dag, DiurnalRate(proc, period=per, depth=depth, phase=phase))
               for dag, proc in spec.tenants]
    return WorkloadSpec(tenants, spec.duration)


@register_traffic("flash_crowd")
def flash_crowd(spec: WorkloadSpec, rng: random.Random, at: float = 0.0,
                duration: float = 0.0, amplify: float = 8.0,
                frac: float = 0.25, ramp: float = 0.0) -> WorkloadSpec:
    """A flash crowd hits a seeded ``frac`` of tenants: their rates are
    amplified ``amplify``x inside ``[at, at+duration)`` with
    ``ramp``-second linear edges.  Defaults: the burst is centered at
    mid-run, lasts 10% of the run, and ramps over 20% of its width."""
    t0 = at if at > 0.0 else 0.5 * spec.duration
    dur = duration if duration > 0.0 else 0.1 * spec.duration
    edge = ramp if ramp > 0.0 else 0.2 * dur
    n = len(spec.tenants)
    k = max(1, int(round(frac * n)))
    hot = set(rng.sample(range(n), min(k, n)))
    tenants = [
        (dag, BurstRate(proc, at=t0, duration=dur, amplify=amplify,
                        ramp=edge) if i in hot else proc)
        for i, (dag, proc) in enumerate(spec.tenants)]
    return WorkloadSpec(tenants, spec.duration)


@register_traffic("tenant_churn")
def tenant_churn(spec: WorkloadSpec, rng: random.Random,
                 leave_frac: float = 0.3, join_frac: float = 0.3,
                 window: Tuple[float, float] = (0.2, 0.8)) -> WorkloadSpec:
    """Tenant arrival/departure churn: a seeded ``leave_frac`` of tenants
    departs at seeded times inside ``window`` (fraction of the run), and
    ``join_frac * n`` fresh tenants — *new* DAG ids the control plane has
    never seen, cloned from seeded templates' class and arrival shape —
    join at seeded times.  This is Dirigent's lifecycle-churn regime: the
    consistent-hash ring and per-DAG state meet DAGs mid-run instead of a
    fixed t=0 population."""
    n = len(spec.tenants)
    lo, hi = window
    u = lambda: spec.duration * (lo + rng.random() * (hi - lo))
    n_leave = int(round(leave_frac * n))
    leavers = set(rng.sample(range(n), min(n_leave, n)))
    tenants: List[Tuple[Any, ArrivalProcess]] = [
        (dag, WindowedRate(proc, end=u()) if i in leavers else proc)
        for i, (dag, proc) in enumerate(spec.tenants)]
    n_join = int(round(join_frac * n))
    for j in range(n_join):
        dag_t, proc_t = spec.tenants[rng.randrange(n)]
        cls = dag_t.dag_id.split("-")[0]
        new_dag = make_paper_dag(cls, f"{cls}-join{j}", rng)
        tenants.append((new_dag, WindowedRate(proc_t, start=u())))
    return WorkloadSpec(tenants, spec.duration)


@register_traffic("zipf_mix")
def zipf_mix(spec: WorkloadSpec, rng: random.Random,
             s: float = 1.1) -> WorkloadSpec:
    """Skewed multi-tenant popularity: tenant rates reweighted by a seeded
    Zipf(s) permutation, normalized to mean factor 1 (aggregate offered
    load stays comparable to the unskewed mix — the skew moves load between
    tenants, concentrating per-DAG hotspots)."""
    n = len(spec.tenants)
    if n == 0:
        return WorkloadSpec([], spec.duration)
    ranks = list(range(n))
    rng.shuffle(ranks)
    weights = [(r + 1) ** -s for r in ranks]
    norm = n / sum(weights)
    tenants = [(dag, ScaledRate(proc, factor=w * norm))
               for (dag, proc), w in zip(spec.tenants, weights)]
    return WorkloadSpec(tenants, spec.duration)
