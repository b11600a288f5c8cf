"""Declarative experiment API: one generic pump loop for every stack.

The paper's evaluation (§7) is a matrix of scheduler stacks × workloads ×
cluster shapes.  ``Experiment`` names one cell of that matrix declaratively;
``simulate`` drives any registered stack (``repro_torch.core.stacks``)
through a single arrival-pump loop; ``ExperimentResult`` is the typed, JSON-round-
trippable summary; ``run_sweep`` expands seed/scale/cluster grids with a
stable row schema.

    from repro_torch.sim import Experiment, simulate

    r = simulate(Experiment(stack="archipelago",
                            workload_factory="paper_workload_2",
                            workload_kwargs=dict(duration=10.0, scale=0.1),
                            warmup=3.0))
    print(r.latency_percentiles["p99.9"], r.deadline_met_frac)

The legacy ``run_archipelago``/``run_baseline``/``run_sparrow`` drivers in
``repro_torch.sim.runner`` are thin shims over this loop and remain
decision-identical to the JAX package's (``tests/test_torch_control_plane.py``
holds them to its equivalence goldens).

The ``backend`` axis selects *what executes an invocation* (``modeled`` —
the default analytic simulation — ``stub`` scripted times, or ``torch`` /
``torch-batched`` real hardware-in-the-loop execution on the card;
``repro_torch.core.backends``), orthogonal to the scheduler stack, so
real-execution scenarios are ordinary sweep cells.

Copy of ``src/repro/sim/experiment.py`` (the port imports nothing of
``repro``), with one difference: ``run_sweep`` runs cells whose backend
times work on a device one after another instead of in its process pool.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time

import numpy as np
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

from ..core.autoscale import AutoscaleConfig
from ..core.backends import (ExecutionBackend, get_backend,
                             resolve_backend)
from ..core.cluster import ClusterConfig
from ..core.fault import FaultInjector, FaultPlan, recovery_summary
from ..core.lbs import LBSConfig, LoadBalancer
from ..core.sgs import SGSConfig
from ..core.stacks import (LB_DECISION_COST, SGS_DECISION_COST, Stack,
                           get_stack)
from ..core.types import DagSpec, Request
from .engine import SimEnv
from .metrics import Metrics, percentile
from .traffic import TrafficSpec, apply_traffic
from .workload import WorkloadSpec, paper_workload_1, paper_workload_2

__all__ = [
    "Experiment", "ExperimentResult", "ClassStats", "SimResult",
    "simulate", "run_sweep", "SweepResult", "WORKLOAD_FACTORIES",
    "register_workload", "get_workload_factory", "available_workloads",
]

# Named workload factories so sweeps can construct per-cell workloads from a
# string + kwargs (a shared WorkloadSpec would pin scale/duration/seed).
# Registered through ``register_workload`` — same shape as ``register_stack``
# and ``register_backend``.
WORKLOAD_FACTORIES: Dict[str, Callable[..., WorkloadSpec]] = {}


def register_workload(name: str, *aliases: str
                      ) -> Callable[[Callable[..., WorkloadSpec]],
                                    Callable[..., WorkloadSpec]]:
    """Decorator: make a workload factory constructible by name through
    ``Experiment(workload_factory=name)``.  Raises on duplicate
    registration."""

    def deco(fn: Callable[..., WorkloadSpec]) -> Callable[..., WorkloadSpec]:
        names = (name, *aliases)
        taken = [n for n in names if n in WORKLOAD_FACTORIES]
        if taken:       # validate before inserting: no partial registration
            raise ValueError(
                f"workload factory {taken[0]!r} is already registered")
        for n in names:
            WORKLOAD_FACTORIES[n] = fn
        return fn

    return deco


def get_workload_factory(name: str) -> Callable[..., WorkloadSpec]:
    import_err: Optional[BaseException] = None
    if name not in WORKLOAD_FACTORIES:
        # serving factories register on import of repro_torch.serving.engine;
        # pull it in lazily so `workload_factory="serving_apps"` works without
        # the caller importing the (torch-dependent) serving package first
        try:
            from ..serving import engine as _serving_engine  # noqa: F401
        except ImportError as e:                        # pragma: no cover
            import_err = e
    try:
        return WORKLOAD_FACTORIES[name]
    except KeyError:
        extra = (f" (importing repro_torch.serving failed: {import_err})"
                 if import_err is not None else "")
        raise ValueError(
            f"unknown workload factory {name!r}; registered factories: "
            f"{', '.join(sorted(WORKLOAD_FACTORIES))}{extra}") from import_err


def available_workloads() -> List[str]:
    return sorted(WORKLOAD_FACTORIES)


register_workload("paper_workload_1")(paper_workload_1)
register_workload("paper_workload_2")(paper_workload_2)


@dataclass
class SimResult:
    """Raw simulation handles (the legacy ``run_*`` return type)."""

    metrics: Metrics
    env: SimEnv
    lbs: Optional[LoadBalancer] = None
    scheduler: object = None
    # the built execution backend (executor handles, counters) — None only
    # for legacy constructions
    backend: Optional[ExecutionBackend] = None
    # this run's data-plane counter deltas (n_executions, batch occupancy,
    # ...): backend.counters() accumulates across sweep cells when one
    # instance is shared, so the per-run view is a before/after difference
    backend_counters: Dict[str, int] = field(default_factory=dict)
    # the FaultInjector when the experiment carried a FaultPlan (fired
    # events, retry counters, the §6.1 StateStore) — None on fault-free runs
    injector: Optional[FaultInjector] = None


@dataclass
class Experiment:
    """One declarative simulation: workload × cluster × stack × knobs.

    Workload is either an explicit ``workload`` spec or a
    ``workload_factory`` (callable or a registered name) applied to
    ``workload_kwargs`` — use the factory form in sweeps so each cell can
    vary scale/duration.  ``backend`` selects the execution backend
    (registered name + ``backend_kwargs``, or a ready
    ``ExecutionBackend`` instance — share one across sweep cells so e.g.
    torch models calibrate once); the default ``"modeled"`` is the pure
    analytic simulation.  ``params`` holds stack-specific knobs (``n_lbs``,
    ``keepalive``, ``probes``, ``scan_limit``, ...); ``sgs``/``lbs`` carry
    the Archipelago policy configs; ``lb_cost``/``sgs_cost`` are the §7.4
    control-plane decision costs.
    """

    stack: str = "archipelago"
    backend: Union[str, ExecutionBackend] = "modeled"
    backend_kwargs: Dict[str, Any] = field(default_factory=dict)
    workload: Optional[WorkloadSpec] = None
    workload_factory: Union[str, Callable[..., WorkloadSpec], None] = None
    workload_kwargs: Dict[str, Any] = field(default_factory=dict)
    cluster: Optional[ClusterConfig] = None
    sgs: Optional[SGSConfig] = None
    lbs: Optional[LBSConfig] = None
    params: Dict[str, Any] = field(default_factory=dict)
    lb_cost: float = LB_DECISION_COST
    sgs_cost: float = SGS_DECISION_COST
    seed: int = 0
    warmup: float = 0.0            # steady-state window start (metrics only)
    drain: float = 5.0             # extra simulated time after last arrival
    workload_method: str = "numpy"
    # declarative chaos schedule (core.fault, docs/FAULTS.md): compiled into
    # the event loop by ``simulate``; None (the default) adds nothing to the
    # run, so zero-fault experiments stay decision-identical
    faults: Optional[FaultPlan] = None
    # declarative traffic scenario (sim.traffic, docs/SCENARIOS.md): a
    # registered name or TrafficSpec applied to the resolved workload —
    # None (the default) leaves the workload untouched, so scenario-free
    # experiments stay decision-identical
    traffic: Union[str, TrafficSpec, None] = None
    # elastic control plane (core.autoscale, docs/SCENARIOS.md): when set,
    # the archipelago stack's LBS replica pool autoscales from observed
    # decision-clock utilization instead of the static params["n_lbs"]
    autoscale: Optional[AutoscaleConfig] = None
    # sharded parallel core (sim/shard.py, docs/PERF.md "Sharded core"): N > 1
    # partitions the SGSs into N process-local islands advancing their own
    # event loops, synchronized at LBS epoch boundaries.  None (the default)
    # keeps the single-process path untouched; any shard count is required
    # to produce byte-identical ExperimentResult rows (a hard contract,
    # pinned by tests/test_shards.py, and in the port
    # by tests/test_torch_shards.py).  Sweepable like any top-level field:
    # ``run_sweep(base, {"shards": [None, 2, 4]})``.
    shards: Optional[int] = None
    name: str = ""

    def resolve_workload(self) -> WorkloadSpec:
        spec = self.workload
        if spec is None:
            f = self.workload_factory
            if isinstance(f, str):
                f = get_workload_factory(f)
            if f is None:
                raise ValueError(
                    "Experiment needs either `workload` or "
                    "`workload_factory`")
            spec = f(**self.workload_kwargs)
        if self.traffic is not None:
            spec = apply_traffic(spec, self.traffic)
        return spec

    def backend_name(self) -> str:
        return self.backend if isinstance(self.backend, str) \
            else self.backend.name

    def label(self) -> str:
        if self.name:
            return self.name
        wl = (self.workload_factory
              if isinstance(self.workload_factory, str) else "custom")
        b = self.backend_name()
        tail = "" if b == "modeled" else f"/{b}"
        t = self.traffic
        scen = "" if t is None else \
            f"+{t if isinstance(t, str) else t.label()}"
        return f"{self.stack}/{wl}/seed{self.seed}{tail}{scen}"


# ---------------------------------------------------------------------------
# Typed results
# ---------------------------------------------------------------------------

_PCTS: Tuple[Tuple[str, float], ...] = (
    ("p50", 50.0), ("p90", 90.0), ("p99", 99.0), ("p99.9", 99.9))


def _pct_dict(xs: Sequence[float]) -> Dict[str, Optional[float]]:
    """Nearest-rank percentiles (same rule as ``metrics.percentile``), one
    vectorized sort for all requested ranks — this runs on ~1e6-sample
    arrays per ``simulate`` call (flat metrics hand numpy arrays straight
    through; lists are converted once)."""
    n = len(xs)
    if n == 0:
        return {k: None for k, _ in _PCTS}
    s = np.sort(np.asarray(xs, dtype=np.float64))
    n1 = n - 1
    return {k: float(s[max(0, min(n1, int(round(p / 100.0 * n1))))])
            for k, p in _PCTS}


def _none_if_nan(x: float) -> Optional[float]:
    return None if math.isnan(x) else x


@dataclass
class ClassStats:
    """Per-DAG-class (C1..C4 style) steady-state breakdown."""

    n_requests: int
    n_completed: int
    p50: Optional[float]
    p99: Optional[float]
    deadline_met_frac: Optional[float]
    cold_starts: int

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ClassStats":
        return cls(**d)


@dataclass
class ExperimentResult:
    """Structured summary of one ``simulate`` run.

    All latency/queuing/deadline statistics are computed on the steady-state
    window (arrivals at ``t >= warmup``; queuing-delay samples are timestamp-
    filtered the same way).  ``warm_hits`` is a whole-run scheduler counter.
    ``to_dict``/``from_dict`` round-trip losslessly through JSON (``sim``,
    the raw simulation handle, is deliberately excluded and ``None`` after
    ``from_dict``).
    """

    name: str
    stack: str
    seed: int
    duration: float
    warmup: float
    n_requests_total: int          # whole run, including warmup
    n_requests: int                # steady-state window
    n_completed: int
    latency_percentiles: Dict[str, Optional[float]]
    queuing_percentiles: Dict[str, Optional[float]]
    deadline_met_frac: Optional[float]
    cold_start_count: int
    cold_start_frac: Optional[float]
    warm_hits: int
    per_class: Dict[str, ClassStats]
    n_events: int
    wall_s: float
    backend: str = "modeled"       # execution backend the run used
    # per-run data-plane counters (this cell only, even when a backend
    # instance is shared across sweep cells): n_executions for stub/torch;
    # batched backends add n_batches / n_batched_invocations / n_batch_slots
    # / max_batch_occupancy (see docs/SERVING.md "Batched serving")
    backend_counters: Dict[str, int] = field(default_factory=dict)
    # data-plane identity: {"device": cuda|cpu, "batching":
    # none|windowed|continuous} for the torch backends, {"kernels": "none",
    # "batching": ...} for stub-batched, {} for modeled
    data_plane: Dict[str, str] = field(default_factory=dict)
    # chaos-run fields (empty/zero on fault-free runs): fired fault events
    # ({"kind", "t", ...} per occurrence), total retried invocations, and
    # the per-fault windowed recovery report ({"window_s", "tolerance",
    # "events": [{"kind", "t", "baseline_met", "dip_met", "recovery_s"}]})
    # — see docs/FAULTS.md "Recovery metrics"
    fault_events: List[Dict[str, Any]] = field(default_factory=list)
    n_retries: int = 0
    recovery: Dict[str, Any] = field(default_factory=dict)
    # whole-run request accounting (Metrics.accounting): {"arrivals",
    # "completed", "unique_completed", "pending", "lost",
    # "duplicate_completions"} — the fault-tolerance invariant is
    # lost == 0 and duplicate_completions == 0 (docs/FAULTS.md)
    accounting: Dict[str, int] = field(default_factory=dict)
    # hedged-retry dispatches the SGSs issued (params["hedge_timeout"],
    # docs/FAULTS.md "Straggler mitigation"); 0 when hedging is off
    n_hedges: int = 0
    # typed control-plane scaling decisions in time order (LBS replica pool
    # + per-DAG SGS set; ``core.autoscale.ScalingEvent.to_dict`` shape:
    # {"t", "component", "action", "n_before", "n_after", "metric",
    # "detail"}) — see docs/SCENARIOS.md "Reading scaling_events"
    scaling_events: List[Dict[str, Any]] = field(default_factory=list)
    sim: Optional[SimResult] = field(default=None, repr=False, compare=False)

    def to_dict(self) -> Dict[str, Any]:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "sim"}
        d["latency_percentiles"] = dict(self.latency_percentiles)
        d["queuing_percentiles"] = dict(self.queuing_percentiles)
        d["backend_counters"] = dict(self.backend_counters)
        d["data_plane"] = dict(self.data_plane)
        d["fault_events"] = [dict(e) for e in self.fault_events]
        d["recovery"] = dict(self.recovery)
        d["accounting"] = dict(self.accounting)
        d["scaling_events"] = [dict(e) for e in self.scaling_events]
        d["per_class"] = {k: v.to_dict()
                          for k, v in sorted(self.per_class.items())}
        return d

    def detach_sim(self) -> "ExperimentResult":
        """Drop the live simulation handle (``sim``: metrics columns, event
        loop, scheduler objects).  After detaching, the result is a plain
        record — everything left round-trips losslessly through
        ``to_dict``/``from_dict`` and pickles across process boundaries,
        which is what lets ``run_sweep`` farm cells to worker processes.
        ``run_sweep`` detaches every cell unless ``keep_sim=True``.
        Returns self for chaining."""
        self.sim = None
        return self

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentResult":
        kw = dict(d)
        kw["per_class"] = {k: ClassStats.from_dict(v)
                           for k, v in d["per_class"].items()}
        return cls(**kw)


def _build_result(exp: Experiment, spec: WorkloadSpec, sim: SimResult,
                  warm_hits: int, wall_s: float,
                  scaling_events: Optional[List[Dict[str, Any]]] = None,
                  n_hedges: int = 0) -> ExperimentResult:
    # one code path for both metrics modes: flat (column) metrics serve
    # ``latencies``/``n_requests``/``by_class`` as vectorized views, the
    # legacy object mode scans its request list exactly as before
    m = sim.metrics.after_warmup(exp.warmup) if exp.warmup > 0 \
        else sim.metrics
    per_class = {}
    for cls_name, cm in m.by_class().items():
        pcts = _pct_dict(cm.latencies())
        per_class[cls_name] = ClassStats(
            n_requests=cm.n_requests,
            n_completed=cm.n_completed,
            p50=pcts["p50"],
            p99=pcts["p99"],
            deadline_met_frac=_none_if_nan(cm.deadline_met_frac()),
            cold_starts=cm.cold_start_count())
    fault_events: List[Dict[str, Any]] = []
    n_retries = 0
    recovery: Dict[str, Any] = {}
    if sim.injector is not None:
        fault_events = list(sim.injector.fault_events)
        n_retries = sim.injector.n_retries
        # recovery windows are absolute-time views over the whole trace
        # (the pre-fault baseline may predate the warmup cutoff)
        recovery = recovery_summary(sim.metrics, sim.injector,
                                    spec.duration + exp.drain)
    return ExperimentResult(
        name=exp.label(),
        stack=exp.stack,
        seed=exp.seed,
        duration=spec.duration,
        warmup=exp.warmup,
        n_requests_total=sim.metrics.n_requests,
        n_requests=m.n_requests,
        n_completed=m.n_completed,
        latency_percentiles=_pct_dict(m.latencies()),
        queuing_percentiles=_pct_dict(m.queuing_delays),
        deadline_met_frac=_none_if_nan(m.deadline_met_frac()),
        cold_start_count=m.cold_start_count(),
        cold_start_frac=_none_if_nan(m.cold_start_frac()),
        warm_hits=warm_hits,
        per_class=per_class,
        n_events=sim.env.n_events,
        wall_s=round(wall_s, 4),
        backend=exp.backend_name(),
        backend_counters=dict(sim.backend_counters),
        data_plane=(dict(sim.backend.data_plane())
                    if sim.backend is not None else {}),
        fault_events=fault_events,
        n_retries=n_retries,
        recovery=recovery,
        accounting=sim.metrics.accounting(),
        n_hedges=n_hedges,
        scaling_events=list(scaling_events or []),
        sim=sim)


# ---------------------------------------------------------------------------
# The one generic arrival-pump loop
# ---------------------------------------------------------------------------


def _arrival_stream(spec: WorkloadSpec, seed: int, method: str
                    ) -> Tuple[List[float], List[DagSpec]]:
    """Time-sorted arrival times + per-arrival DAGs.

    The vectorized path never materializes per-arrival tuples; numpy floats
    are converted once (``tolist`` round-trips float64 exactly)."""
    times, dags, _, _, _ = _arrival_columns(spec, seed, method)
    return times, dags


def _arrival_columns(spec: WorkloadSpec, seed: int, method: str
                     ) -> Tuple[List[float], List[DagSpec], np.ndarray,
                                np.ndarray, List[DagSpec]]:
    """``_arrival_stream`` plus the raw arrival columns the flat metrics
    plane attaches wholesale: (times, per-arrival dags, time array,
    per-arrival tenant-dag index array, tenant dag list)."""
    if method == "legacy":
        pairs = spec.generate(seed, method="legacy")
        times = [t for t, _ in pairs]
        dags = [d for _, d in pairs]
        # rebuild the tenant index from object identity (the legacy
        # generator hands per-arrival DAG objects, one per tenant)
        tenant_dags: List[DagSpec] = []
        by_id: Dict[int, int] = {}
        idx = []
        for d in dags:
            k = by_id.get(id(d))
            if k is None:
                k = by_id[id(d)] = len(tenant_dags)
                tenant_dags.append(d)
            idx.append(k)
        return (times, dags, np.asarray(times, dtype=np.float64),
                np.asarray(idx, dtype=np.int64), tenant_dags)
    if method != "numpy":
        raise ValueError(f"unknown generation method {method!r}")
    ts, idx_arr, tenant_dags = spec.generate_arrays(seed)
    dags = list(map(tenant_dags.__getitem__, idx_arr.tolist()))
    return ts.tolist(), dags, ts, idx_arr, tenant_dags


def _validate_params(exp: Experiment, stack_cls: type) -> None:
    """Reject unknown ``Experiment.params`` keys for stacks that declare a
    ``PARAMS`` frozenset (every built-in does) — a typo like
    ``params={"n_lb": 4}`` silently no-ops otherwise.  Custom stacks
    without the attribute skip validation (back-compat); the error style
    matches the stack/backend registry lookups."""
    allowed = getattr(stack_cls, "PARAMS", None)
    if allowed is None or not exp.params:
        return
    unknown = sorted(k for k in exp.params if k not in allowed)
    if unknown:
        raise ValueError(
            f"unknown param(s) {', '.join(map(repr, unknown))} for stack "
            f"{exp.stack!r}; known params: "
            f"{', '.join(sorted(allowed)) or '(none)'}")


Hook = Callable[[SimEnv, Stack], None]


def simulate(exp: Experiment, *,
             hooks: Sequence[Tuple[float, Hook]] = (),
             timed_calls: Sequence[Tuple[float, Hook]] = ()
             ) -> ExperimentResult:
    """Run one experiment through the generic pump loop.

    ``hooks`` are periodic observers ``(interval, fn(env, stack))``
    (demand sampling, custom telemetry); ``timed_calls`` fire once at the
    given simulated time (fault injection).  Both run inside the event loop
    and may mutate the stack — they exist so benchmarks never have to
    re-plumb the pump by hand.

    ``exp.shards`` > 1 routes the run through the sharded parallel core
    (``repro_torch.sim.shard``): SGS islands advance in separate processes with
    epoch synchronization at LBS decision boundaries, returning a result
    byte-identical to this single-process path.  Inside a daemonic
    ``run_sweep`` pool worker (which cannot spawn children) the request is
    honored by the sequential path instead — identical rows either way.
    """
    if exp.shards is not None and int(exp.shards) > 1:
        import multiprocessing

        from .shard import simulate_sharded, validate_shardable
        validate_shardable(exp, hooks, timed_calls)
        if not multiprocessing.current_process().daemon:
            return simulate_sharded(exp)
    exp_spec, sim, stack, wall = _run_experiment(exp, hooks, timed_calls)
    counters = stack.counters()
    warm_hits = counters.get("warm_hits", 0)
    sev = getattr(stack, "scaling_events", None)
    scaling = sev() if callable(sev) else []
    return _build_result(exp, exp_spec, sim, warm_hits, wall, scaling,
                         n_hedges=counters.get("hedges", 0))


def _run_experiment(exp: Experiment,
                    hooks: Sequence[Tuple[float, Hook]] = (),
                    timed_calls: Sequence[Tuple[float, Hook]] = ()
                    ) -> Tuple[WorkloadSpec, SimResult, Stack, float]:
    """The pump loop without result summarization (the legacy ``run_*``
    shims return the raw ``SimResult`` and skip the summary entirely).

    Order of construction: workload resolves first, then the execution
    backend re-specs it (calibration / scripted times), then ``bind`` hands
    the backend the live event loop (building its asynchronous ``submit``
    seam — legacy ``execute``-only backends are adapted here), then the
    stack builds against the resolved backend.  A spec-provided ``pre_pump``
    hook (serving prewarm — the §3 "initial DAG upload") runs after the
    stack is built but before any arrival fires.
    """
    stack_cls = get_stack(exp.stack)
    _validate_params(exp, stack_cls)
    spec = exp.resolve_workload()
    backend = resolve_backend(exp.backend, exp.backend_kwargs)
    spec = backend.build(exp, spec)
    env = SimEnv()
    backend.bind(env)
    stack: Stack = stack_cls()
    stack.build(env, exp, spec, backend)
    pre_pump = getattr(spec, "pre_pump", None)
    if pre_pump is not None:
        pre_pump(env, stack)
    # snapshot data-plane counters so the reported view is this run's delta
    # (a shared backend instance accumulates across sweep cells)
    counters_before = dict(backend.counters())

    t0 = time.perf_counter()
    times, dags, arr_np, idx_np, tenant_dags = _arrival_columns(
        spec, exp.seed, exp.workload_method)
    # flat metrics plane: arrival columns attach wholesale, schedulers
    # record completions straight into column buffers and release the
    # Request objects.  Stacks that cannot wire the completion hook (custom
    # schedulers predating it) fall back to the legacy per-object list.
    flat = Metrics.flat(arr_np, idx_np, tenant_dags)
    attach = getattr(stack, "attach_metrics", None)
    if attach is not None and attach(flat):
        metrics = flat
        pending = flat._cols.pending
        requests = None
    else:
        metrics = Metrics()
        pending = None
        requests = metrics.requests
    n = len(times)
    submit = stack.submit

    # arrival i fires exactly at times[i] (the event heap is driven by the
    # same float), so the pump reads the clock off the trace instead of
    # calling env.now() per arrival
    if pending is not None:
        def pump(i: int) -> None:
            # fire arrival i, then lazily schedule arrival i+1: the event
            # heap holds one pending arrival instead of the whole trace
            now = times[i]
            req = Request(dag=dags[i], arrival_time=now)
            req.m_idx = i
            pending[i] = req
            submit(req, now)
            i += 1
            if i < n:
                env.call_at(times[i], pump, i)
    else:
        def pump(i: int) -> None:
            now = times[i]
            req = Request(dag=dags[i], arrival_time=now)
            requests.append(req)
            submit(req, now)
            i += 1
            if i < n:
                env.call_at(times[i], pump, i)

    if n:
        env.call_at(times[0], pump, 0)
    stack.start_background()
    horizon = spec.duration + exp.drain
    for interval, fn in hooks:
        env.every(interval, lambda fn=fn: fn(env, stack), until=horizon)
    for t, fn in timed_calls:
        env.call_at(t, fn, env, stack)
    injector: Optional[FaultInjector] = None
    if exp.faults is not None and exp.faults.events:
        injector = FaultInjector(exp.faults)
        injector.install(env, stack, horizon)

    env.run_until(horizon)
    stack.collect(metrics)
    wall = time.perf_counter() - t0

    counters = {k: v - counters_before.get(k, 0)
                for k, v in backend.counters().items()}
    sim = SimResult(metrics=metrics, env=env,
                    lbs=getattr(stack, "lbs", None),
                    scheduler=getattr(stack, "scheduler", None),
                    backend=backend, backend_counters=counters,
                    injector=injector)
    return spec, sim, stack, wall


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


def _override(exp: Experiment, path: str, value: Any) -> Experiment:
    """Return a copy of ``exp`` with one (possibly dotted) field replaced.

    ``"seed"`` (or ``"backend"``, ``"stack"``, ...) replaces a top-level
    field; ``"cluster.n_sgs"`` / ``"sgs.proactive"`` /
    ``"lbs.scale_out_threshold"`` replace a field of a nested config
    (instantiating the default config when unset); ``"params.probes"`` /
    ``"workload_kwargs.scale"`` / ``"backend_kwargs.exec_time"`` set one
    dict key.
    """
    head, _, rest = path.partition(".")
    if not rest:
        if head not in {f.name for f in dataclasses.fields(exp)}:
            raise ValueError(f"unknown Experiment field {head!r}")
        return dataclasses.replace(exp, **{head: value})
    if head in ("params", "workload_kwargs", "backend_kwargs"):
        d = dict(getattr(exp, head))
        d[rest] = value
        return dataclasses.replace(exp, **{head: d})
    defaults = {"cluster": ClusterConfig, "sgs": SGSConfig, "lbs": LBSConfig,
                "autoscale": AutoscaleConfig}
    if head not in defaults:
        raise ValueError(f"cannot sweep over {path!r}")
    sub = getattr(exp, head) or defaults[head]()
    return dataclasses.replace(
        exp, **{head: dataclasses.replace(sub, **{rest: value})})


@dataclass
class SweepResult:
    """Grid-sweep output with a stable row schema.

    Each row is ``{"cell": {axis: value, ...}, "result": <ExperimentResult
    dict>}``; rows appear in cartesian-product order of ``axes`` (first axis
    slowest).  Every cell is an independent fresh simulation, so rows are
    deterministic per (seed, config) and independent of execution order.
    """

    axes: Dict[str, List[Any]]
    rows: List[Dict[str, Any]]
    # live ExperimentResult objects (with .sim) when run with keep_sim=True
    experiment_results: Optional[List[ExperimentResult]] = None

    def __iter__(self):
        return iter(self.rows)

    def __len__(self) -> int:
        return len(self.rows)

    def to_dict(self) -> Dict[str, Any]:
        # axis/cell values may be rich objects (e.g. FaultPlan): serialize
        # through their own to_dict so sweep JSONs stay self-contained
        def val(v: Any) -> Any:
            to_d = getattr(v, "to_dict", None)
            return to_d() if callable(to_d) else v

        return {"schema": 1,
                "axes": {k: [val(v) for v in vs]
                         for k, vs in self.axes.items()},
                "rows": [{"cell": {k: val(v) for k, v in r["cell"].items()},
                          "result": r["result"]} for r in self.rows]}

    def results(self) -> List[ExperimentResult]:
        if self.experiment_results is not None:
            return list(self.experiment_results)
        return [ExperimentResult.from_dict(r["result"]) for r in self.rows]


def _expand_cells(base: Experiment, axes: Mapping[str, Sequence[Any]]
                  ) -> List[Tuple[Dict[str, Any], Experiment]]:
    """The sweep grid in cartesian-product order (first axis slowest):
    [(cell dict, fully-overridden Experiment), ...]."""
    names = list(axes)
    cells: List[Tuple[Dict[str, Any], Experiment]] = []
    for combo in itertools.product(*(list(axes[k]) for k in names)):
        exp = base
        cell: Dict[str, Any] = {}
        for k, v in zip(names, combo):
            exp = _override(exp, k, v)
            cell[k] = v
        cells.append((cell, exp))
    return cells


def _picklable(v: Any) -> bool:
    import pickle
    try:
        pickle.dumps(v)
    except Exception:
        return False
    return True


def _on_device(backend: Union[str, ExecutionBackend]) -> bool:
    cls = get_backend(backend) if isinstance(backend, str) else backend
    return bool(cls.on_device)


def _run_cell(exp: Experiment) -> Dict[str, Any]:
    """Worker-process entry point: one fresh simulation, serialized through
    the lossless ``to_dict`` round-trip (the live ``sim`` handle never
    crosses the process boundary)."""
    return simulate(exp).detach_sim().to_dict()


def run_sweep(base: Experiment, axes: Mapping[str, Sequence[Any]],
              keep_sim: bool = False, workers: int = 1) -> SweepResult:
    """Cartesian sweep over ``axes`` (axis name → values; names follow
    ``_override``'s dotted-path rules) starting from ``base``.

    ``workers=N`` (N > 1) farms the cells to a spawn-context process pool.
    Every cell is an independent fresh simulation with per-cell seeding, so
    rows come back in the same deterministic cartesian order with payloads
    identical to sequential execution (``wall_s``, the one wall-clock
    timing field, is the only value that can differ between runs at all —
    parallel or not).  Parallel execution requires the per-cell
    ``Experiment``s to pickle: use *named* workload factories and *named*
    backends; a base experiment carrying live objects (a shared
    ``ExecutionBackend`` instance, a spec with closure hooks) falls back to
    sequential execution with a warning.  So do cells whose backend times
    real work on a device (``ExecutionBackend.on_device``: ``torch``,
    ``torch-batched``): parallel cells would share the card and skew each
    other's measured times, and no worker process starts after CUDA is
    initialised.  ``keep_sim=True`` retains the live per-cell results
    (including ``.sim``) on ``SweepResult.experiment_results`` for bespoke
    analysis and therefore always runs sequentially in-process."""
    cells = _expand_cells(base, axes)
    rows: List[Dict[str, Any]] = []
    objs: List[ExperimentResult] = []
    use_pool = workers > 1 and not keep_sim and len(cells) > 1
    if workers > 1 and keep_sim:
        import warnings
        warnings.warn(
            f"run_sweep(workers={workers}): keep_sim=True retains live "
            f"simulation handles that cannot cross a process boundary; "
            f"falling back to sequential execution",
            RuntimeWarning, stacklevel=2)
    if use_pool:
        on_device = sorted({exp.backend_name() for _, exp in cells
                            if _on_device(exp.backend)})
        if on_device:
            import warnings
            warnings.warn(
                f"run_sweep(workers={workers}): backend(s) "
                f"{', '.join(map(repr, on_device))} time real work on a "
                f"device, which parallel cells would share; running the "
                f"cells sequentially", RuntimeWarning, stacklevel=2)
            use_pool = False
    if use_pool:
        import pickle
        try:
            pickle.dumps([exp for _, exp in cells])
        except Exception as e:
            import warnings
            # name the offending field so the fix ("use a *named* workload
            # factory/backend") is obvious from the warning alone
            bad = sorted({f.name for f in dataclasses.fields(base)
                          for _, exp in cells
                          if not _picklable(getattr(exp, f.name))})
            detail = (f"field(s) {', '.join(map(repr, bad))} are not "
                      f"picklable" if bad else "cells are not picklable")
            warnings.warn(
                f"run_sweep(workers={workers}): {detail} ({e!r}); falling "
                f"back to sequential execution",
                RuntimeWarning, stacklevel=2)
            use_pool = False
    if use_pool:
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, len(cells))) as pool:
            results = pool.map(_run_cell, [exp for _, exp in cells])
        rows = [{"cell": cell, "result": d}
                for (cell, _), d in zip(cells, results)]
    else:
        for cell, exp in cells:
            res = simulate(exp)
            rows.append({"cell": cell, "result": res.to_dict()})
            if keep_sim:
                objs.append(res)
            else:
                # explicit detach: frees the event loop/metrics columns and
                # keeps the appended row the single serializable source
                res.detach_sim()
    return SweepResult(axes={k: list(v) for k, v in axes.items()}, rows=rows,
                       experiment_results=objs if keep_sim else None)
