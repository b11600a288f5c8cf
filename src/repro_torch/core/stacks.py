"""Pluggable scheduler-stack registry for the experiment API.

The paper's evaluation (§7) is a matrix of *scheduler stacks* × workloads ×
cluster shapes.  A stack bundles everything between "a request arrived" and
"a scheduler object accepted it": cluster construction, control-plane
service clocks (the §7.4 per-decision costs), routing, and background loops.
``repro_torch.sim.experiment.simulate`` drives any registered stack through ONE
generic arrival-pump loop, so adding a scheduler is a one-class job:

    from repro_torch.core.stacks import register_stack, FlatWorkerStack

    @register_stack("my-scheduler")
    class MyStack(FlatWorkerStack):
        def make_scheduler(self, workers, env, exp):
            return MyScheduler(workers, env, **exp.params)

Built-in stacks: ``archipelago`` (LBS → SGSs, §4-§5), ``fifo`` (centralized
FIFO + keep-alive, §2.4 baseline, alias ``baseline``), ``sparrow``
(power-of-two probing, Fig. 2d), and ``pull`` — a worker-initiated
pull-based scheduler in the spirit of Hiku [Akbari & Hauswirth 2025],
registered purely through this module as the extensibility proof.

Copy of ``src/repro/core/stacks.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Protocol,
                    Type)

from .backends import ExecutionBackend
from .baselines import CentralizedFIFO, SparrowScheduler
from .cluster import build_cluster, build_flat_workers
from .lbs import LoadBalancer
from .sandbox import Worker
from .types import Request, Sandbox

if TYPE_CHECKING:       # pragma: no cover - typing only, avoids a core->sim cycle
    from ..sim.experiment import Experiment
    from ..sim.metrics import Metrics
    from ..sim.workload import WorkloadSpec

# §7.4 measured control-plane decision costs (Go prototype medians)
LB_DECISION_COST = 190e-6
SGS_DECISION_COST = 241e-6


@dataclass(slots=True)
class _ServiceClock:
    """Serializes work through one control-plane component (M/D/1 server).

    The paper's measured per-decision costs (§7.4): LBS routing ~190us,
    SGS scheduling ~241us.  A single centralized scheduler at several
    thousand RPS approaches rho=1 and its queue explodes — exactly the
    §2.4 scalability argument; Archipelago spreads this cost over many
    SGSs.
    """

    busy_until: float = 0.0

    def acquire(self, now: float, service: float) -> float:
        start = self.busy_until
        if now > start:
            start = now
        self.busy_until = start + service
        return self.busy_until


def make_archipelago_submit(lb_clocks: List[_ServiceClock],
                            sgs_clocks: Dict[int, _ServiceClock],
                            select, call_at, lb_cost: float, sgs_cost: float,
                            scaler=None, deliver=None):
    """Build the Archipelago per-arrival hot-path closure.

    The two-hop control-plane arithmetic (LBS routing clock → SGS decision
    clock, both hand-inlined M/D/1 acquires) is shared by four variants:

    * ``scaler is None`` — static LB replica pool, round-robin via
      ``itertools.cycle`` (the historical hot path, byte-identical to the
      equivalence goldens); otherwise the elastic pool re-reads the live
      clock-list length and counts routed requests for the autoscaler.
    * ``deliver is None`` — in-process submission: the routed request
      becomes an event (``call_at(t_sched, sgs.submit_request, req)``).
      A sharded coordinator (the JAX package's ``sim/shard.py``) instead passes
      ``deliver(t_sched, sgs_id, req)`` to route the submission into the
      owning shard's outbox; ``select`` then returns SGS *proxies* and
      ``call_at`` is unused.

    Each variant is its own flat closure so the dominant sequential path
    pays zero extra call frames or branches per arrival.
    """
    if deliver is None:
        if scaler is None:
            # static pool: round-robin over the LB replicas without a
            # counter/modulo.  This closure is the historical hot path —
            # byte-identical decisions to the equivalence goldens.
            next_lb_clock = itertools.cycle(lb_clocks).__next__

            def submit(req: Request, now: float) -> None:
                # hop 1: LBS routing decision (a scalable service: many
                # LBs).  Both clock acquires are hand-inlined M/D/1
                # waits (identical arithmetic to _ServiceClock.acquire).
                c = next_lb_clock()
                t = c.busy_until
                if now > t:
                    t = now
                c.busy_until = t_routed = t + lb_cost
                sgs = select(req, now)
                # hop 2: SGS scheduling decision, serialized per SGS
                c = sgs_clocks[sgs.sgs_id]
                t = c.busy_until
                if t_routed > t:
                    t = t_routed
                c.busy_until = t_sched = \
                    t + sgs_cost * req.dag._n_fns
                call_at(t_sched, sgs.submit_request, req)
        else:
            # elastic pool: the autoscaler grows/shrinks `clocks` in
            # place between arrivals, so round-robin with a cursor that
            # re-reads the live length, and count routed requests for
            # the utilization signal
            clocks = lb_clocks
            cursor = [0]

            def submit(req: Request, now: float) -> None:
                i = cursor[0]
                if i >= len(clocks):
                    i = 0
                cursor[0] = i + 1
                c = clocks[i]
                t = c.busy_until
                if now > t:
                    t = now
                c.busy_until = t_routed = t + lb_cost
                scaler.n_routed += 1
                sgs = select(req, now)
                c = sgs_clocks[sgs.sgs_id]
                t = c.busy_until
                if t_routed > t:
                    t = t_routed
                c.busy_until = t_sched = \
                    t + sgs_cost * req.dag._n_fns
                call_at(t_sched, sgs.submit_request, req)
    elif scaler is None:
        next_lb_clock = itertools.cycle(lb_clocks).__next__

        def submit(req: Request, now: float) -> None:
            c = next_lb_clock()
            t = c.busy_until
            if now > t:
                t = now
            c.busy_until = t_routed = t + lb_cost
            sgs = select(req, now)
            c = sgs_clocks[sgs.sgs_id]
            t = c.busy_until
            if t_routed > t:
                t = t_routed
            c.busy_until = t_sched = \
                t + sgs_cost * req.dag._n_fns
            deliver(t_sched, sgs.sgs_id, req)
    else:
        clocks = lb_clocks
        cursor = [0]

        def submit(req: Request, now: float) -> None:
            i = cursor[0]
            if i >= len(clocks):
                i = 0
            cursor[0] = i + 1
            c = clocks[i]
            t = c.busy_until
            if now > t:
                t = now
            c.busy_until = t_routed = t + lb_cost
            scaler.n_routed += 1
            sgs = select(req, now)
            c = sgs_clocks[sgs.sgs_id]
            t = c.busy_until
            if t_routed > t:
                t = t_routed
            c.busy_until = t_sched = \
                t + sgs_cost * req.dag._n_fns
            deliver(t_sched, sgs.sgs_id, req)

    return submit


class Stack(Protocol):
    """What ``simulate``'s generic pump loop needs from a scheduler stack.

    Lifecycle: ``build`` once (against the resolved execution backend —
    stacks thread the backend's asynchronous ``submit`` seam (falling back
    to the legacy ``execute`` hook) into their schedulers so *what runs an
    invocation* is orthogonal to *where it runs*, see ``core.backends``),
    ``submit`` per arrival (called inside the pump at the request's arrival
    instant), ``start_background`` once after the first arrival is scheduled
    (periodic scaling passes etc.), and ``collect`` after the run drains
    (fold per-scheduler samples into the run's Metrics).

    ``submit`` is the per-arrival hot path: the built-in stacks rebind
    ``self.submit`` in ``build`` to a closure over locals (clocks, costs,
    ``env.call_at``) so the pump pays no attribute lookups per arrival —
    exactly like the pre-registry drivers.  Subclasses that override
    ``submit`` as a plain method keep working (the rebinding is skipped).
    """

    name: str
    lbs: Optional[LoadBalancer]
    scheduler: object

    def build(self, env, exp: "Experiment", spec: "WorkloadSpec",
              backend: ExecutionBackend) -> None: ...
    def submit(self, req: Request, now: float) -> None: ...
    def start_background(self) -> None: ...
    def collect(self, metrics: "Metrics") -> None: ...
    def counters(self) -> Dict[str, int]: ...

    # Optional: wire the run's flat metrics plane into every scheduler's
    # ``on_complete`` hook (``Metrics.record_completion``) and return True.
    # Stacks without it — or whose schedulers lack the hook — make the pump
    # fall back to the legacy per-object request list.
    # def attach_metrics(self, metrics: "Metrics") -> bool: ...


_STACKS: Dict[str, Type] = {}


def register_stack(name: str, *aliases: str) -> Callable[[Type], Type]:
    """Class decorator: make a stack constructible by name through
    ``Experiment(stack=name)``.  Raises on duplicate registration."""

    def deco(cls: Type) -> Type:
        names = (name, *aliases)
        taken = [n for n in names if n in _STACKS]
        if taken:       # validate before inserting: no partial registration
            raise ValueError(f"stack {taken[0]!r} is already registered")
        for n in names:
            _STACKS[n] = cls
        cls.name = name
        return cls

    return deco


def get_stack(name: str) -> Type:
    try:
        return _STACKS[name]
    except KeyError:
        raise ValueError(
            f"unknown stack {name!r}; registered stacks: "
            f"{', '.join(sorted(_STACKS))}") from None


def available_stacks() -> List[str]:
    return sorted(_STACKS)


# ---------------------------------------------------------------------------
# Built-in stacks
# ---------------------------------------------------------------------------


@register_stack("archipelago")
class ArchipelagoStack:
    """Full paper stack: scalable LBS tier → semi-global schedulers (§4-§5).

    ``params``: ``n_lbs`` (parallel LB replicas, default 4; with
    ``Experiment.autoscale`` set it is only the *initial* pool size —
    default ``min_replicas`` — and the LBS replica autoscaler grows/shrinks
    the pool from observed decision-clock utilization, ``core.autoscale``).

    Straggler mitigation (docs/FAULTS.md "Hedged retries"):
    ``hedge_timeout`` — per-invocation dispatch timeout as a multiple of
    the invocation's expected ``exec_time`` (None/0 = off, the default); a
    dispatched copy that has not completed by ``setup + hedge_timeout ×
    exec_time`` gets a speculative duplicate enqueued, first completion
    wins.  ``hedge_jitter`` — seeded uniform fraction (default 0.25) the
    timeout is stretched by, so co-batched stragglers do not hedge in
    lockstep.
    """

    PARAMS = frozenset({"n_lbs", "hedge_timeout", "hedge_jitter"})

    lbs: Optional[LoadBalancer] = None
    scheduler: object = None
    _autoscaler = None

    def build(self, env, exp: "Experiment", spec: "WorkloadSpec",
              backend: ExecutionBackend) -> None:
        self.env = env
        self.exp = exp
        self.spec = spec
        self.lbs = build_cluster(env, exp.cluster, exp.sgs, exp.lbs,
                                 execute=backend.execute,
                                 backend_submit=backend.submit)
        # batching data planes expose a dead-member release hook: a worker
        # crash mid-batch must free the victims' pending/slot state
        drop = getattr(backend, "drop_invocations", None)
        # hedged-retry knobs (validated Experiment.params; zero-fault runs
        # leave them unset, so the SGS hot path stays decision-identical)
        hedge = exp.params.get("hedge_timeout")
        hedge = float(hedge) if hedge else None
        if hedge is not None and hedge <= 0.0:
            hedge = None
        jitter = float(exp.params.get("hedge_jitter", 0.25))
        if drop is not None or hedge is not None:
            for sid, s in self.lbs.sgss.items():
                s.backend_drop = drop
                if hedge is not None:
                    s._hedge_timeout = hedge
                    s._hedge_jitter = jitter
                    # seeded per-SGS stream, independent of the workload rng
                    s._hedge_rng = random.Random((exp.seed << 20) ^ sid)
        auto = getattr(exp, "autoscale", None)
        if auto is not None:
            n_lb = int(exp.params.get("n_lbs", auto.min_replicas))
            n_lb = max(1, max(auto.min_replicas,
                              min(n_lb, auto.max_replicas)))
        else:
            n_lb = max(1, int(exp.params.get("n_lbs", 4)))
        self._n_lb = n_lb
        self._lb_clocks = [_ServiceClock() for _ in range(n_lb)]
        self._sgs_clocks = {sid: _ServiceClock() for sid in self.lbs.sgss}
        self._arrival_no = 0
        if auto is not None:
            from .autoscale import LBSReplicaAutoscaler
            self._autoscaler = LBSReplicaAutoscaler(
                self._lb_clocks, exp.lb_cost, auto, make_clock=_ServiceClock)
        if type(self).submit is ArchipelagoStack.submit:
            # hot path: close over locals so the pump pays zero attribute
            # lookups per arrival (same constants as the pre-registry driver)
            self.submit = make_archipelago_submit(
                self._lb_clocks, self._sgs_clocks, self.lbs.select,
                env.call_at, exp.lb_cost, exp.sgs_cost,
                scaler=self._autoscaler)

    def submit(self, req: Request, now: float) -> None:
        # hop 1: LBS routing decision (LBS is a scalable service: many LBs)
        i = self._arrival_no
        self._arrival_no = i + 1
        t_routed = self._lb_clocks[i % self._n_lb].acquire(
            now, self.exp.lb_cost)
        sgs = self.lbs.select(req, now)
        # hop 2: SGS scheduling decision, serialized per SGS
        t_sched = self._sgs_clocks[sgs.sgs_id].acquire(
            t_routed, self.exp.sgs_cost * len(req.dag.functions))
        self.env.call_at(t_sched, sgs.submit_request, req)

    def start_background(self) -> None:
        # periodic scaling pass (the LBS's background loop, §5.2)
        lbs = self.lbs
        env = self.env
        horizon = self.spec.duration + self.exp.drain
        env.every(lbs.cfg.decision_interval / 5.0,
                  lambda: lbs.check_scaling(env.now()),
                  until=horizon)
        scaler = self._autoscaler
        if scaler is not None:
            # the LBS replica controller's observation/decision loop
            env.every(scaler.cfg.interval,
                      lambda: scaler.tick(env.now()), until=horizon)

    def scaling_events(self) -> List[dict]:
        """Typed control-plane scaling decisions this run made — LBS
        replica-pool actions (autoscaler) merged with per-DAG SGS set
        actions (``LoadBalancer.scaling_log``) in time order, as plain
        JSON-ready dicts for ``ExperimentResult.scaling_events``."""
        events = list(getattr(self.lbs, "scaling_log", ()))
        if self._autoscaler is not None:
            events.extend(self._autoscaler.events)
        events.sort(key=lambda e: (e.t, e.component))
        return [e.to_dict() for e in events]

    def attach_metrics(self, metrics: "Metrics") -> bool:
        rec = metrics.completion_recorder()
        for s in self.lbs.sgss.values():
            s.on_complete = rec
        return True

    def collect(self, metrics: "Metrics") -> None:
        for s in self.lbs.sgss.values():
            metrics.add_queuing_samples(s.queuing_delays,
                                        s.queuing_delay_times)

    def counters(self) -> Dict[str, int]:
        sgss = self.lbs.sgss.values()
        return {"cold_starts": sum(s.n_cold_starts for s in sgss),
                "warm_hits": sum(s.n_warm_hits for s in sgss),
                "hedges": sum(s.n_hedges for s in sgss)}


class FlatWorkerStack:
    """Base for centralized/decentralized baselines over one flat worker
    pool.  Subclasses provide ``make_scheduler``; the default ``submit``
    serializes every decision through ONE control-plane clock at
    ``exp.sgs_cost`` per DAG function (§2.4's centralized bottleneck).

    The execution backend's hook is wired onto the scheduler after
    construction (every built-in scheduler exposes ``backend_submit`` /
    ``execute`` attributes), so ``make_scheduler`` keeps its 3-argument
    signature and custom stacks run under any backend for free."""

    lbs: Optional[LoadBalancer] = None

    def build(self, env, exp: "Experiment", spec: "WorkloadSpec",
              backend: ExecutionBackend) -> None:
        self.env = env
        self.exp = exp
        self.spec = spec
        self.scheduler = self.make_scheduler(
            build_flat_workers(exp.cluster), env, exp)
        if backend.submit is not None:
            # asynchronous execution seam (core.backends.SubmitFn)
            self.scheduler.backend_submit = backend.submit
        elif backend.execute is not None:
            # pre-seam custom backends that were built without bind()
            self.scheduler.execute = backend.execute
        drop = getattr(backend, "drop_invocations", None)
        if drop is not None and hasattr(self.scheduler, "backend_drop"):
            # batched data plane: release dead members on worker crash
            self.scheduler.backend_drop = drop
        self._clock = _ServiceClock()
        if type(self).submit is FlatWorkerStack.submit:
            # hot path: same closure-over-locals trick as ArchipelagoStack,
            # with the M/D/1 clock acquire hand-inlined
            clock = self._clock
            call_at = env.call_at
            submit_request = self.scheduler.submit_request
            sgs_cost = exp.sgs_cost

            def submit(req: Request, now: float) -> None:
                t = clock.busy_until
                if now > t:
                    t = now
                clock.busy_until = t = t + sgs_cost * req.dag._n_fns
                call_at(t, submit_request, req)

            self.submit = submit

    def make_scheduler(self, workers: List[Worker], env,
                       exp: "Experiment") -> object:
        raise NotImplementedError

    def submit(self, req: Request, now: float) -> None:
        t_sched = self._clock.acquire(
            now, self.exp.sgs_cost * len(req.dag.functions))
        self.env.call_at(t_sched, self.scheduler.submit_request, req)

    def start_background(self) -> None:
        pass

    def attach_metrics(self, metrics: "Metrics") -> bool:
        # custom make_scheduler results may predate the hook: fall back
        if not hasattr(self.scheduler, "on_complete"):
            return False
        self.scheduler.on_complete = metrics.completion_recorder()
        return True

    def collect(self, metrics: "Metrics") -> None:
        metrics.add_queuing_samples(self.scheduler.queuing_delays,
                                    self.scheduler.queuing_delay_times)

    def counters(self) -> Dict[str, int]:
        return {"cold_starts": self.scheduler.n_cold_starts,
                "warm_hits": self.scheduler.n_warm_hits}


@register_stack("fifo", "baseline")
class CentralizedFIFOStack(FlatWorkerStack):
    """Centralized FIFO + reactive sandboxes + fixed keep-alive (§7.1).

    ``params``: ``keepalive`` (seconds, default 900).
    """

    PARAMS = frozenset({"keepalive"})

    def make_scheduler(self, workers, env, exp):
        return CentralizedFIFO(
            workers, env, keepalive=float(exp.params.get("keepalive", 900.0)))


@register_stack("sparrow")
class SparrowStack(FlatWorkerStack):
    """Sparrow-style power-of-two probing [41] (Fig. 2d).  No control-plane
    clock: probing is parallel, so submission is immediate (as in the
    original ``run_sparrow`` driver).

    ``params``: ``probes`` (default 2).
    """

    PARAMS = frozenset({"probes"})

    def make_scheduler(self, workers, env, exp):
        return SparrowScheduler(workers, env,
                                probes=int(exp.params.get("probes", 2)),
                                seed=exp.seed)

    def build(self, env, exp: "Experiment", spec: "WorkloadSpec",
              backend: ExecutionBackend) -> None:
        super().build(env, exp, spec, backend)
        submit_request = self.scheduler.submit_request
        self.submit = lambda req, now: submit_request(req)

    def submit(self, req: Request, now: float) -> None:
        self.scheduler.submit_request(req)


# ---------------------------------------------------------------------------
# Extensibility proof: a NEW stack added purely via the registry
# ---------------------------------------------------------------------------


class PullScheduler(CentralizedFIFO):
    """Worker-initiated (pull-based) scheduling à la Hiku [Akbari &
    Hauswirth 2025]: instead of the queue head picking a worker, each idle
    worker pulls work it can serve warm.

    The central dispatcher only holds ready invocations; whenever a worker
    has a free core it scans the first ``scan_limit`` queued invocations for
    one it holds a WARM sandbox for (late binding → accidental affinity
    becomes deliberate affinity) and falls back to the queue head.  This
    sidesteps CentralizedFIFO's strict head-of-line blocking while keeping
    its reactive sandbox + keep-alive model.
    """

    def __init__(self, workers: List[Worker], env, keepalive: float = 900.0,
                 scan_limit: int = 16):
        super().__init__(workers, env, keepalive=keepalive)
        self.scan_limit = scan_limit

    def _dispatch(self) -> None:
        now = self.env.now()
        q = self._queue
        progress = True
        while q and progress:
            progress = False
            for w in self.workers:
                if not q:
                    break
                if w.free_cores <= 0:
                    continue
                # the pulling worker prefers queued work it can serve warm
                pick = 0
                sbx: Optional[Sandbox] = None
                for j, inv in enumerate(
                        itertools.islice(q, self.scan_limit)):
                    s = w.warm_available(inv.fn.name, now)
                    if s is not None:
                        pick, sbx = j, s
                        break
                inv = q[pick]
                del q[pick]
                if sbx is None:
                    sbx = w.warm_available(inv.fn.name, now)
                self._start(inv, w, sbx, now)
                progress = True


@register_stack("pull")
class PullStack(FlatWorkerStack):
    """Pull-based worker-initiated scheduler (see ``PullScheduler``).

    ``params``: ``keepalive`` (default 900), ``scan_limit`` (default 16).
    """

    PARAMS = frozenset({"keepalive", "scan_limit"})

    def make_scheduler(self, workers, env, exp):
        return PullScheduler(
            workers, env,
            keepalive=float(exp.params.get("keepalive", 900.0)),
            scan_limit=int(exp.params.get("scan_limit", 16)))
