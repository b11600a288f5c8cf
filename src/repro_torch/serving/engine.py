"""Serving apps as workloads: hardware-in-the-loop through the experiment API.

A :class:`ServingApp` is a tenant — one DAG over :class:`ServedModel`s with a
latency slack.  ``serving_workload`` (registered as the ``"serving_apps"``
workload factory) turns a list of apps into an ordinary
:class:`~repro_torch.sim.workload.WorkloadSpec`, so serving runs route through
the same ``simulate``/``run_sweep`` pipeline, stacks, warmup/drain semantics
and ``ExperimentResult`` reporting as every simulation::

    from repro_torch.sim import Experiment, simulate

    r = simulate(Experiment(
        stack="archipelago", backend="torch-batched",
        workload_factory="serving_apps",
        workload_kwargs=dict(apps=[app], duration=20.0, rps=10.0),
        warmup=5.0))

With ``backend="torch"`` the scheduler layers (LBS + SGSs) are the exact
objects from ``repro_torch.core``; time is advanced by the discrete-event
engine, but *every execution and every sandbox setup is a real PyTorch call
on the card whose wall time is measured and fed back* — queuing, placement,
proactive allocation and scaling all operate on real numbers.  The same
workload runs under ``backend="torch-batched"`` (the batching data plane:
concurrently in-flight invocations of one model coalesce into padded
batched executions, or, with ``batching="continuous"``, join a running
batch at decode-step boundaries — ``batch_window``/``max_batch`` are
sweepable ``backend_kwargs``), ``"stub"``/``"stub-batched"`` (scripted
times, CI) or ``"modeled"`` (placeholder times) unchanged.

The spec's ``pre_pump`` hook reproduces the paper's "initial DAG upload"
(§3): before traffic, each app's initial SGS proactively allocates
``prewarm`` sandboxes per function.  Set ``Experiment.warmup`` past the
largest measured setup time to report steady-state numbers.

Copy of ``src/repro/serving/engine.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

from ..core.types import DagSpec, FunctionSpec, Request
from ..sim.experiment import register_workload
from ..sim.workload import ArrivalProcess, ConstantRate, WorkloadSpec
from .executor import ServedModel

# Placeholder costs until a backend resolves real numbers: the torch backends
# replace them with calibrated measurements, the stub backend with scripted
# values; the modeled backend runs them as-is (cheap structural smoke).
PLACEHOLDER_EXEC = 0.010
PLACEHOLDER_SETUP = 1.0
PLACEHOLDER_MEM_MB = 512.0


@dataclass
class ServingApp:
    """A tenant: one DAG over served models, with a latency deadline.

    ``slack`` is granted on top of the DAG's critical-path execution time —
    with the torch backends that path is *measured*, so the deadline tracks
    real hardware speed.
    """

    dag_id: str
    models: Dict[str, ServedModel]          # fn name -> model
    edges: Tuple[Tuple[str, str], ...] = ()
    slack: float = 0.5                      # deadline = critical path + slack

    def dag(self, fn_specs: Optional[Mapping[str, FunctionSpec]] = None
            ) -> DagSpec:
        """The app as a ``DagSpec``: function specs from ``fn_specs`` where
        given (calibrated/scripted), placeholders otherwise; the deadline is
        derived from the DAG's own critical path via ``with_deadline`` —
        computed once, from whatever specs the DAG actually carries."""
        fn_specs = fn_specs or {}
        fns = tuple(
            fn_specs.get(name) or FunctionSpec(
                name=name, exec_time=PLACEHOLDER_EXEC,
                mem_mb=PLACEHOLDER_MEM_MB, setup_time=PLACEHOLDER_SETUP)
            for name in self.models)
        return DagSpec(dag_id=self.dag_id, functions=fns,
                       edges=self.edges).with_deadline(slack=self.slack)


@dataclass
class ServingWorkloadSpec(WorkloadSpec):
    """A ``WorkloadSpec`` over served models.

    Extra fields ride along through backend re-speccing
    (``dataclasses.replace`` keeps them): ``served`` lets the torch backends
    find the models to calibrate, ``slacks`` re-derives each deadline as
    measured-critical-path + slack, and ``prewarm`` drives the ``pre_pump``
    proactive-allocation hook.
    """

    served: Dict[str, ServedModel] = field(default_factory=dict)
    slacks: Dict[str, float] = field(default_factory=dict)
    prewarm: Dict[str, int] = field(default_factory=dict)   # dag_id -> n/fn

    def pre_pump(self, env, stack) -> None:
        """Prewarm hook, run by ``simulate`` after the stack is built and
        before the first arrival: each app's initial SGS proactively
        allocates ``prewarm[dag_id]`` sandboxes per function (§3 "initial
        DAG upload" / §5.2.3 warm-up).  Stacks without proactive allocation
        (the reactive baselines) simply ignore it — exactly the paper's
        cold-start handicap."""
        lbs = getattr(stack, "lbs", None)
        scheduler = getattr(stack, "scheduler", None)
        for dag, _ in self.tenants:
            n = self.prewarm.get(dag.dag_id, 0)
            if n <= 0:
                continue
            if lbs is not None:
                sgs = lbs.select(Request(dag=dag, arrival_time=0.0), 0.0)
                sgs.preallocate(dag, n)
            elif hasattr(scheduler, "preallocate"):
                scheduler.preallocate(dag, n)


@register_workload("serving_apps")
def serving_workload(apps: Sequence[ServingApp],
                     duration: float = 30.0,
                     rps: Union[float, Mapping[str, float]] = 10.0,
                     arrivals: Optional[Mapping[str, ArrivalProcess]] = None,
                     prewarm_per_fn: int = 2) -> ServingWorkloadSpec:
    """Serving apps as a workload: one tenant per app.

    ``rps`` is a constant Poisson rate (scalar, or a per-``dag_id`` mapping
    that must name every app); ``arrivals`` overrides the arrival process
    per app (any ``ArrivalProcess`` — sinusoidal diurnal load, on/off
    bursts, ...).  ``prewarm_per_fn`` proactive sandboxes per function are
    allocated before traffic via ``pre_pump``.
    """
    arrivals = arrivals or {}
    app_ids = [a.dag_id for a in apps]
    if len(set(app_ids)) != len(app_ids):
        raise ValueError(f"duplicate dag_id(s) across apps: "
                         f"{sorted({i for i in app_ids if app_ids.count(i) > 1})}")
    for label, mapping in (("rps", rps if isinstance(rps, Mapping) else {}),
                           ("arrivals", arrivals)):
        unknown = set(mapping) - set(app_ids)
        if unknown:
            raise ValueError(f"{label} names unknown dag_id(s) "
                             f"{sorted(unknown)}; apps: {sorted(app_ids)}")
    if isinstance(rps, Mapping):
        ambiguous = set(rps) & set(arrivals)
        if ambiguous:
            raise ValueError(f"dag_id(s) {sorted(ambiguous)} appear in both "
                             f"rps and arrivals; specify one")
        missing = [i for i in app_ids if i not in rps and i not in arrivals]
        if missing:
            raise ValueError(f"rps mapping must cover every app; missing: "
                             f"{sorted(missing)}")
    tenants = []
    served: Dict[str, ServedModel] = {}
    slacks: Dict[str, float] = {}
    prewarm: Dict[str, int] = {}
    for app in apps:
        overlap = set(app.models) & set(served)
        if overlap:
            raise ValueError(
                f"function name(s) {sorted(overlap)} served by more than "
                f"one app; names must be unique across apps")
        served.update(app.models)
        slacks[app.dag_id] = app.slack
        prewarm[app.dag_id] = prewarm_per_fn
        proc = arrivals.get(app.dag_id)
        if proc is None:
            r = rps[app.dag_id] if isinstance(rps, Mapping) else float(rps)
            proc = ConstantRate(r)
        tenants.append((app.dag(), proc))
    return ServingWorkloadSpec(tenants=tenants, duration=duration,
                               served=served, slacks=slacks, prewarm=prewarm)
