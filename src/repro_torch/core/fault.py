"""Fault tolerance (§6.1) and declarative chaos injection.

Fail-stop model with an immediate failure detector:

* **Worker failures** — the owning scheduler updates its cluster view (the
  worker leaves the pool, its sandboxes are gone); invocations that were
  executing there are re-enqueued (retry).  Recovery pressure is handled by
  the existing machinery: lost capacity raises queuing delay, the LBS
  observes it and scales the affected DAGs out; even placement means
  surviving workers still hold proactive sandboxes.
* **SGS / LB failures** — all state an SGS or the LB needs to resume
  (estimator state, sandbox demand targets, per-DAG SGS mappings) is kept
  in a reliable external ``StateStore``; a replacement instance restores
  from it and continues (``fail_sgs``).

Chaos injection is declarative: a :class:`FaultPlan` is a tuple of typed,
seeded :class:`FaultEvent`\\ s carried on ``Experiment.faults`` as a
sweepable axis.  ``simulate`` compiles the plan through a
:class:`FaultInjector` into plain ``env.call_at`` events — a run without a
plan never touches any of this (pay-for-what-you-use; the zero-fault
equivalence goldens stay decision-identical).  New fault shapes register
with :func:`register_fault`, mirroring the stack/backend registries
(docs/FAULTS.md).

Copy of ``src/repro/core/fault.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import copy
import heapq
import random
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

from .lbs import LoadBalancer
from .sgs import SemiGlobalScheduler
from .types import Invocation, SandboxState


class StateStore:
    """The paper's 'reliable external store' (a KV store; in the prototype a
    goroutine-served map, here an in-process dict with deep-copy semantics
    so restored state is decoupled from the writer's objects)."""

    def __init__(self):
        self._data: Dict[str, Any] = {}
        self.n_writes = 0

    def put(self, key: str, value: Any) -> None:
        self._data[key] = copy.deepcopy(value)
        self.n_writes += 1

    def get(self, key: str, default: Any = None) -> Any:
        v = self._data.get(key, default)
        return copy.deepcopy(v)


# ---------------------------------------------------------------------------
# SGS state checkpoint / restore
# ---------------------------------------------------------------------------


def checkpoint_sgs(sgs: SemiGlobalScheduler, store: StateStore) -> None:
    """Persist the soft state a replacement SGS needs (§6.1): demand targets
    + estimator rates.  (Queued invocations are re-submitted by the LBS on
    failover in a real deployment; sandboxes are soft state by design.)"""
    store.put(f"sgs/{sgs.sgs_id}/demand", dict(sgs.sandboxes.demand_map))
    store.put(f"sgs/{sgs.sgs_id}/fn_specs", dict(sgs.sandboxes.fn_specs))
    store.put(f"sgs/{sgs.sgs_id}/dags", dict(sgs._dags))


def restore_sgs(sgs: SemiGlobalScheduler, store: StateStore,
                now: float) -> None:
    """Bring a fresh SGS instance up from the store: re-learn served DAGs
    and proactively re-allocate to the recorded demand."""
    sgs._dags.update(store.get(f"sgs/{sgs.sgs_id}/dags", {}))
    sgs.sandboxes.fn_specs.update(store.get(f"sgs/{sgs.sgs_id}/fn_specs", {}))
    demand = store.get(f"sgs/{sgs.sgs_id}/demand", {})
    for fn_name, d in demand.items():
        spec = sgs.sandboxes.fn_specs.get(fn_name)
        if spec is not None and d > 0:
            # hold the restored demand as a floor for ramp_window (same
            # mechanism as LBS preallocation): the fresh estimator has seen
            # no arrivals yet, so without the floor the next estimation tick
            # would soft-evict the pool the checkpoint just rebuilt
            sgs._demand_floor[fn_name] = (d, now + sgs.cfg.ramp_window)
            sgs.sandboxes.set_demand(spec, d, now)
    sgs._ensure_ticking()


def checkpoint_lbs(lbs: LoadBalancer, store: StateStore) -> None:
    """Persist per-DAG SGS mappings (active/removed lists)."""
    for st in lbs._dag_state.values():
        lbs._fold(st)       # reading sandbox_count: apply buffered reports
    mapping = {dag_id: {"active": list(st.active),
                        "removed": list(st.removed),
                        "sandbox_count": dict(st.sandbox_count)}
               for dag_id, st in lbs._dag_state.items()}
    store.put("lbs/mapping", mapping)


def restore_lbs(lbs: LoadBalancer, store: StateStore, now: float) -> None:
    mapping = store.get("lbs/mapping", {})
    for dag_id, m in mapping.items():
        st = lbs._dag_state.get(dag_id)
        if st is None:
            continue    # DAG spec re-registers on its next request
        st.active = [s for s in m["active"] if s in lbs.sgss]
        st.removed = [s for s in m["removed"] if s in lbs.sgss]
        st.sandbox_count.update(m["sandbox_count"])


# ---------------------------------------------------------------------------
# Worker failure injection
# ---------------------------------------------------------------------------


def fail_worker(scheduler: Any, worker_id: int) -> int:
    """Fail-stop one worker: remove it from the scheduler's cluster view,
    drop its sandboxes, and re-enqueue invocations that were running on it.
    Works for SGS instances and the flat baselines (CentralizedFIFO /
    Sparrow / pull), which share the ``_inflight``/``_dead_workers``
    registration shape.  Returns the number of re-enqueued invocations."""
    if isinstance(scheduler, SemiGlobalScheduler):
        return _fail_worker_sgs(scheduler, worker_id)
    return _fail_worker_flat(scheduler, worker_id)


def _fail_worker_sgs(sgs: SemiGlobalScheduler, worker_id: int) -> int:
    w = next((w for w in sgs.workers if w.worker_id == worker_id), None)
    if w is None:
        return 0
    # keep the SGS's free-core accounting consistent before the view changes
    sgs._free_cores -= max(0, w.free_cores)
    if sgs.workers is not sgs.sandboxes.workers:
        sgs.workers.remove(w)
    # removes from the manager's pool view and every per-function index
    sgs.sandboxes.remove_worker(w)
    # retry in-flight invocations: the completion callbacks for this worker
    # become no-ops (the inflight registration is gone) and the request is
    # re-driven from the queue
    now = sgs.env.now()
    n_retry = 0
    dropped: List[int] = []
    for inv in list(sgs._inflight.get(worker_id, {}).values()):
        dropped.append(inv.inv_id)
        retry = Invocation(request=inv.request, fn=inv.fn, ready_time=now)
        k0, k1, k2 = retry.priority_key()
        heapq.heappush(sgs._queue, (k0, k1, k2, retry))
        n_retry += 1
    sgs._dead_workers.add(worker_id)
    sgs._inflight.pop(worker_id, None)
    sgs._slow.pop(worker_id, None)
    # a batching data plane may still hold the dead members in a pending
    # window or an active decode slot: release them before the retries land
    drop = getattr(sgs, "backend_drop", None)
    if drop is not None and dropped:
        drop(dropped)
    sgs._dispatch()
    return n_retry


def _fail_worker_flat(sched: Any, worker_id: int) -> int:
    """Fail-stop for the flat baselines.  Sparrow additionally loses the
    dead worker's local queue; those invocations are re-placed too."""
    w = next((w for w in sched.workers if w.worker_id == worker_id), None)
    if w is None:
        return 0
    sched.workers.remove(w)
    sched._dead_workers.add(worker_id)
    now = sched.env.now()
    retries: List[Invocation] = []
    dropped: List[int] = []
    for inv in list(sched._inflight.pop(worker_id, {}).values()):
        dropped.append(inv.inv_id)
        retries.append(Invocation(request=inv.request, fn=inv.fn,
                                  ready_time=now))
    wq = getattr(sched, "_wqueues", None)
    if wq is not None:                  # Sparrow: drain the lost local queue
        for inv in wq.pop(worker_id, ()):
            retries.append(Invocation(request=inv.request, fn=inv.fn,
                                      ready_time=now))
    slow = getattr(sched, "_slow", None)
    if slow is not None:
        slow.pop(worker_id, None)
    drop = getattr(sched, "backend_drop", None)
    if drop is not None and dropped:
        drop(dropped)
    place = getattr(sched, "_place", None)
    if place is not None:
        for retry in retries:
            place(retry)
    else:                               # FIFO-shaped: back of the queue
        sched._queue.extend(retries)
        sched._dispatch()
    return len(retries)


# ---------------------------------------------------------------------------
# SGS fail-stop + StateStore-backed failover
# ---------------------------------------------------------------------------


def fail_sgs(lbs: LoadBalancer, sgs_id: int, store: StateStore, env: Any,
             ) -> Tuple[Optional[SemiGlobalScheduler], int]:
    """Fail-stop one SGS and bring up a replacement restored from the
    reliable store (§6.1): "a replacement instance restores from it and
    continues".

    Only the scheduler *process* dies — the worker pool (a rack) survives:
    warm sandboxes stay resident and executions already running there keep
    running (their completions forward to the replacement through the
    victim's ``_successor`` pointer).  What dies with the process is the
    SRSF queue — re-enqueued into the replacement as retries, modeling the
    LBS re-submitting un-acked work — and the demand estimator, rebuilt
    from the checkpointed targets and held as a floor for ``ramp_window``.
    Returns ``(replacement, n_retry)``; ``(None, 0)`` if the id is unknown
    or already failed over."""
    victim = lbs.sgss.get(sgs_id)
    if victim is None or victim._successor is not None:
        return None, 0
    now = env.now()
    replacement = SemiGlobalScheduler(
        sgs_id, victim.workers, env, config=victim.cfg,
        execute=victim.execute, backend_submit=victim.backend_submit)
    # The replacement adopts a pool that is already warm: eagerly rebuild
    # the per-function indices so the fused hot-path transitions (which
    # assume the index exists) are safe for sandboxes created pre-failure.
    mgr = replacement.sandboxes
    for w in victim.workers:
        for fn_name in w._buckets:
            mgr._ensure_fn(fn_name)
    # Executions on surviving workers keep running: adopt the in-flight
    # registrations (by reference — the victim's bound callbacks forward
    # here via _successor and pop from this same dict).
    replacement._inflight = victim._inflight
    replacement._dead_workers = victim._dead_workers
    # Degraded-mode state rides the pool, not the scheduler process: slow
    # workers stay slow across failover, the data-plane drop hook and the
    # hedging config carry over (shared rng: the hedge stream continues).
    replacement._slow = victim._slow
    replacement.backend_drop = victim.backend_drop
    replacement._hedge_timeout = victim._hedge_timeout
    replacement._hedge_jitter = victim._hedge_jitter
    replacement._hedge_rng = victim._hedge_rng
    replacement.n_hedges = victim.n_hedges
    # Metric streams continue across the failover (same id, same pool).
    replacement.queuing_delays = victim.queuing_delays
    replacement.queuing_delay_times = victim.queuing_delay_times
    replacement.completed_requests = victim.completed_requests
    replacement.n_cold_starts = victim.n_cold_starts
    replacement.n_warm_hits = victim.n_warm_hits
    replacement.on_complete = victim.on_complete
    # Soft state from the store: served DAGs, fn specs, demand targets.
    restore_sgs(replacement, store, now)
    # The dead scheduler's queue: re-submitted by the LBS on failover.
    n_retry = 0
    for _, _, _, inv in victim._queue:
        retry = Invocation(request=inv.request, fn=inv.fn, ready_time=now)
        k0, k1, k2 = retry.priority_key()
        heapq.heappush(replacement._queue, (k0, k1, k2, retry))
        n_retry += 1
    victim._queue = []
    victim._successor = replacement
    lbs.replace_sgs(replacement)
    replacement._dispatch()
    return replacement, n_retry


def evacuate_sgs(lbs: LoadBalancer, sgs_id: int) -> int:
    """Re-home a worker-less SGS's load onto a surviving peer.

    A rack-power / AZ-outage event can take an SGS's *entire* pool down; a
    scheduler with zero workers would hold its queue (and everything the
    LBS keeps routing to it) forever.  Model the LBS health-check re-route
    with the same mechanism §6.1 failover uses: move the queued
    invocations to the survivor and leave a ``_successor`` pointer so
    in-flight submissions and completions forward there.  The survivor is
    the peer with the most free cores (ties: lowest id) — deterministic,
    so seeded plans replay exactly.  Returns the number of re-homed
    queued invocations; no-op unless the pool is actually empty."""
    victim = lbs.sgss.get(sgs_id)
    if victim is None or victim._successor is not None or victim.workers:
        return 0
    survivors = [s for sid, s in sorted(lbs.sgss.items())
                 if sid != sgs_id and s.workers and s._successor is None]
    if not survivors:
        return 0
    succ = max(survivors, key=lambda s: s._free_cores)
    n_moved = 0
    for item in victim._queue:
        heapq.heappush(succ._queue, item)
        n_moved += 1
    victim._queue = []
    victim._successor = succ
    succ._dispatch()
    return n_moved


# ---------------------------------------------------------------------------
# Declarative fault plans
# ---------------------------------------------------------------------------


def _freeze_kwargs(kw: Mapping[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted(kw.items()))


@dataclass(frozen=True)
class FaultEvent:
    """One declarative fault: a registered kind plus its schedule.

    Schedule is either ``at`` (fire once at that simulated time) or
    ``rate`` (a seeded Poisson process of occurrences per second over
    ``[start, end)``; ``end=None`` means the run horizon).  ``kwargs`` are
    the handler's arguments, stored as a sorted tuple of pairs so events
    hash, pickle (``run_sweep`` workers) and compare cleanly."""
    kind: str
    at: Optional[float] = None
    rate: Optional[float] = None
    start: float = 0.0
    end: Optional[float] = None
    kwargs: Tuple[Tuple[str, Any], ...] = ()

    def arg_dict(self) -> Dict[str, Any]:
        return dict(self.kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "at": self.at, "rate": self.rate,
                "start": self.start, "end": self.end,
                "kwargs": dict(self.kwargs)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultEvent":
        return cls(kind=d["kind"], at=d.get("at"), rate=d.get("rate"),
                   start=d.get("start", 0.0), end=d.get("end"),
                   kwargs=_freeze_kwargs(d.get("kwargs", {})))


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, declarative chaos schedule — the sweepable ``faults=``
    axis on ``Experiment``.  Frozen (hashable, picklable) so plans can sit
    in sweep axes and ship to ``run_sweep`` worker processes."""
    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0
    name: str = ""
    # §6.1 periodic StateStore checkpoint cadence, used when the plan
    # contains sgs_failstop events: a fail-stop victim cannot checkpoint at
    # the failure instant, so the replacement restores state up to this
    # many seconds stale.
    checkpoint_interval: float = 0.25

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    def label(self) -> str:
        if self.name:
            return self.name
        if not self.events:
            return "none"
        return "+".join(ev.kind for ev in self.events)

    def to_dict(self) -> Dict[str, Any]:
        return {"events": [ev.to_dict() for ev in self.events],
                "seed": self.seed, "name": self.name,
                "checkpoint_interval": self.checkpoint_interval}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultPlan":
        return cls(events=tuple(FaultEvent.from_dict(e)
                                for e in d.get("events", [])),
                   seed=d.get("seed", 0), name=d.get("name", ""),
                   checkpoint_interval=d.get("checkpoint_interval", 0.25))


# -- event constructors ------------------------------------------------------


def worker_crash(k: int = 1, at: Optional[float] = None,
                 rate: Optional[float] = None, start: float = 0.0,
                 end: Optional[float] = None, sgs: Optional[int] = None,
                 spare: int = 1) -> FaultEvent:
    """Fail-stop ``k`` workers per occurrence, uniformly over pools that
    would keep at least ``spare`` workers.  Exactly one of ``at``
    (one-shot) / ``rate`` (Poisson occurrences per second) is required;
    ``sgs`` narrows the blast radius to one scheduler's pool."""
    if (at is None) == (rate is None):
        raise ValueError("worker_crash needs exactly one of at= / rate=")
    return FaultEvent("worker_crash", at=at, rate=rate, start=start, end=end,
                      kwargs=_freeze_kwargs(
                          {"k": k, "sgs": sgs, "spare": spare}))


def sgs_failstop(at: float, sgs: Optional[int] = None) -> FaultEvent:
    """Kill one SGS at ``at``; a replacement restores from the StateStore
    and the LBS re-routes (no-op on stacks without an SGS tier).  ``sgs``
    None picks a victim with the plan's seeded RNG."""
    return FaultEvent("sgs_failstop", at=at,
                      kwargs=_freeze_kwargs({"sgs": sgs}))


def mass_eviction(at: float, frac: float = 1.0,
                  sgs: Optional[int] = None) -> FaultEvent:
    """Cold-boot storm: evict a fraction of all idle sandboxes at ``at``.
    Demand targets survive, so proactive allocation immediately rebuilds
    the pool — a setup-work avalanche (Dirigent's lifecycle-churn regime)."""
    return FaultEvent("mass_eviction", at=at,
                      kwargs=_freeze_kwargs({"frac": frac, "sgs": sgs}))


def control_plane_delay(at: Optional[float] = None,
                        rate: Optional[float] = None, stall: float = 0.05,
                        target: str = "both", start: float = 0.0,
                        end: Optional[float] = None) -> FaultEvent:
    """Control-plane latency spike: LBS/SGS decision servers stall for
    ``stall`` seconds (GC pause, leader re-election).  ``target`` is
    ``"lbs"``, ``"sgs"`` or ``"both"``."""
    if (at is None) == (rate is None):
        raise ValueError(
            "control_plane_delay needs exactly one of at= / rate=")
    return FaultEvent("control_plane_delay", at=at, rate=rate, start=start,
                      end=end,
                      kwargs=_freeze_kwargs(
                          {"stall": stall, "target": target}))


# -- correlated / gray-failure event constructors ----------------------------


def rack_power(at: float, rack: Optional[int] = None,
               spare_racks: int = 1) -> FaultEvent:
    """Power loss for one rack (== one SGS worker pool, §4.1): every
    worker in it fail-stops at once.  ``rack=None`` picks a live rack with
    the plan's seeded RNG; at least ``spare_racks`` other live racks are
    always kept.  On archipelago the orphaned SGS is evacuated onto a
    surviving peer (:func:`evacuate_sgs`)."""
    return FaultEvent("rack_power", at=at,
                      kwargs=_freeze_kwargs(
                          {"rack": rack, "spare_racks": spare_racks}))


def az_outage(at: float, az: Optional[int] = None,
              spare_azs: int = 1) -> FaultEvent:
    """Availability-zone outage: every rack in the zone loses power
    simultaneously (``ClusterConfig.racks_per_az`` racks per AZ).
    ``az=None`` picks a live zone with the plan's seeded RNG; at least
    ``spare_azs`` other live zones always survive."""
    return FaultEvent("az_outage", at=at,
                      kwargs=_freeze_kwargs(
                          {"az": az, "spare_azs": spare_azs}))


def cascading_crash(at: Optional[float] = None,
                    rate: Optional[float] = None, p: float = 0.5,
                    k0: int = 1, max_kills: Optional[int] = None,
                    start: float = 0.0, end: Optional[float] = None,
                    sgs: Optional[int] = None,
                    spare: int = 1) -> FaultEvent:
    """Correlated cascade: ``k0`` seed crashes, each of which propagates
    another crash with probability ``p`` (a seeded branching process — the
    retry/overload storm one failure puts on its neighbours).  ``p`` is
    part of the frozen event, so identical plans replay identical
    cascades.  Bounded by ``max_kills`` and the ``spare``-per-pool floor."""
    if (at is None) == (rate is None):
        raise ValueError("cascading_crash needs exactly one of at= / rate=")
    if not 0.0 <= float(p) <= 1.0:
        raise ValueError(f"cascading_crash propagation p={p} must be in "
                         f"[0, 1]")
    return FaultEvent("cascading_crash", at=at, rate=rate, start=start,
                      end=end,
                      kwargs=_freeze_kwargs(
                          {"p": p, "k0": k0, "max_kills": max_kills,
                           "sgs": sgs, "spare": spare}))


def slow_worker(k: int = 1, factor: float = 4.0, at: Optional[float] = None,
                rate: Optional[float] = None, start: float = 0.0,
                end: Optional[float] = None,
                duration: Optional[float] = None,
                sgs: Optional[int] = None) -> FaultEvent:
    """Gray failure: ``k`` seeded workers keep accepting work but execute
    it ``factor``× slower (thermal throttling, a noisy neighbour, a dying
    disk).  Nothing is killed and no detector fires — mitigation is the
    hedged-retry layer, not failover.  ``duration=None`` degrades for the
    rest of the run."""
    if (at is None) == (rate is None):
        raise ValueError("slow_worker needs exactly one of at= / rate=")
    if float(factor) <= 0.0:
        raise ValueError(f"slow_worker factor={factor} must be > 0")
    return FaultEvent("slow_worker", at=at, rate=rate, start=start, end=end,
                      kwargs=_freeze_kwargs(
                          {"k": k, "factor": factor, "duration": duration,
                           "sgs": sgs}))


def flaky_network(at: Optional[float] = None, rate: Optional[float] = None,
                  jitter: float = 0.02, target: str = "both",
                  start: float = 0.0, end: Optional[float] = None
                  ) -> FaultEvent:
    """Gray failure: seeded jitter on the LBS↔SGS control-plane service
    clocks — each occurrence stalls every targeted decision server for an
    independent uniform draw in ``[0, jitter)`` seconds (packet loss /
    retransmit storms, not a clean partition).  Pair with ``rate=`` for a
    sustained flaky link."""
    if (at is None) == (rate is None):
        raise ValueError("flaky_network needs exactly one of at= / rate=")
    if float(jitter) <= 0.0:
        raise ValueError(f"flaky_network jitter={jitter} must be > 0")
    return FaultEvent("flaky_network", at=at, rate=rate, start=start,
                      end=end,
                      kwargs=_freeze_kwargs(
                          {"jitter": jitter, "target": target}))


def memory_pressure(at: float, frac: float = 0.5, duration: float = 1.0,
                    sgs: Optional[int] = None) -> FaultEvent:
    """Gray failure: the proactive pool temporarily loses ``frac`` of its
    memory on every targeted worker (co-located batch job, page-cache
    bloat).  Resident sandboxes over the shrunk budget are evicted
    (oldest-first, never BUSY) — a real eviction storm, since demand
    targets survive and proactive allocation immediately rebuilds the
    pool.  Capacity restores after ``duration`` seconds."""
    if not 0.0 < float(frac) <= 1.0:
        raise ValueError(f"memory_pressure frac={frac} must be in (0, 1]")
    if float(duration) <= 0.0:
        raise ValueError(f"memory_pressure duration={duration} must be > 0")
    return FaultEvent("memory_pressure", at=at,
                      kwargs=_freeze_kwargs(
                          {"frac": frac, "duration": duration, "sgs": sgs}))


# -- fault registry (mirrors stacks/backends) --------------------------------

FaultHandler = Callable[..., None]      # handler(ctx, **kwargs)

_FAULTS: Dict[str, FaultHandler] = {}


def register_fault(name: str) -> Callable[[FaultHandler], FaultHandler]:
    """Decorator registering a fault handler under ``name``.  Handlers take
    a :class:`FaultContext` plus the event's kwargs; new fault shapes are
    one decorated function (docs/FAULTS.md)."""
    def deco(fn: FaultHandler) -> FaultHandler:
        if name in _FAULTS:
            raise ValueError(f"fault {name!r} is already registered")
        _FAULTS[name] = fn
        return fn
    return deco


def get_fault(name: str) -> FaultHandler:
    try:
        return _FAULTS[name]
    except KeyError:
        raise ValueError(
            f"unknown fault {name!r}; registered faults: "
            f"{', '.join(sorted(_FAULTS))}") from None


def available_faults() -> List[str]:
    return sorted(_FAULTS)


# -- injection ---------------------------------------------------------------


@dataclass
class FaultContext:
    """What a fault handler gets to work with at fire time."""
    env: Any
    stack: Any
    rng: random.Random
    injector: "FaultInjector"

    def schedulers(self, sgs: Optional[int] = None) -> List[Any]:
        """Live scheduler instances: the SGS tier (optionally one id) for
        archipelago-shaped stacks, else the single flat scheduler."""
        lbs = getattr(self.stack, "lbs", None)
        if lbs is not None:
            if sgs is not None:
                s = lbs.sgss.get(sgs)
                return [s] if s is not None else []
            return [lbs.sgss[sid] for sid in sorted(lbs.sgss)]
        sched = getattr(self.stack, "scheduler", None)
        return [sched] if sched is not None else []

    def record(self, kind: str, **info: Any) -> None:
        self.injector.record(kind, self.env.now(), **info)


class FaultInjector:
    """Compiles a :class:`FaultPlan` into plain event-loop callbacks.

    ``simulate`` constructs one when ``Experiment.faults`` is set and calls
    :meth:`install` after the stack is built — occurrence times are
    expanded (seeded, deterministic) and scheduled with ``env.call_at``; if
    the plan kills SGSs, a periodic §6.1 checkpoint hook persists the
    doomed instances' soft state to the injector's StateStore so failover
    has something to restore from."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self.store = StateStore()
        self.fault_events: List[Dict[str, Any]] = []
        self.n_retries = 0

    def record(self, kind: str, t: float, **info: Any) -> None:
        self.fault_events.append(
            {"kind": kind, "t": round(float(t), 6), **info})

    def occurrences(self, ev: FaultEvent, horizon: float) -> List[float]:
        """Fire times for one event: ``at`` verbatim, ``rate`` as a seeded
        Poisson process over [start, min(end, horizon))."""
        if ev.at is not None:
            return [float(ev.at)]
        if not ev.rate or ev.rate <= 0.0:
            return []
        end = horizon if ev.end is None else min(ev.end, horizon)
        out: List[float] = []
        t = ev.start
        while True:
            t += self.rng.expovariate(ev.rate)
            if t >= end:
                return out
            out.append(t)

    def install(self, env: Any, stack: Any, horizon: float) -> None:
        ctx = FaultContext(env=env, stack=stack, rng=self.rng, injector=self)
        lbs = getattr(stack, "lbs", None)
        doomed: set = set()
        for ev in self.plan.events:
            handler = get_fault(ev.kind)       # fail fast on unknown kinds
            kwargs = ev.arg_dict()
            for t in self.occurrences(ev, horizon):
                kw = dict(kwargs)
                if ev.kind == "sgs_failstop" and lbs is not None and lbs.sgss:
                    if kw.get("sgs") is None:  # seeded victim choice, fixed
                        ids = sorted(lbs.sgss)  # at install so checkpoints
                        kw["sgs"] = ids[self.rng.randrange(len(ids))]  # cover it
                    doomed.add(kw["sgs"])
                env.call_at(t, self._fire, ctx, handler, kw)
        if doomed and lbs is not None:
            # Periodic checkpoints, scoped to the instances this plan will
            # kill: checkpointing all 80 xl-tier SGSs every 250 ms would
            # deep-copy DAG specs the run never restores.
            interval = max(1e-3, self.plan.checkpoint_interval)
            self._checkpoint(lbs, doomed)               # t=0 baseline
            env.every(interval, lambda: self._checkpoint(lbs, doomed),
                      until=horizon)

    @staticmethod
    def _fire(ctx: "FaultContext", handler: FaultHandler,
              kw: Dict[str, Any]) -> None:
        handler(ctx, **kw)

    def _checkpoint(self, lbs: LoadBalancer, doomed: set) -> None:
        for sid in sorted(doomed):
            s = lbs.sgss.get(sid)
            if s is not None and s._successor is None:
                checkpoint_sgs(s, self.store)
        checkpoint_lbs(lbs, self.store)


# -- built-in handlers -------------------------------------------------------


@register_fault("worker_crash")
def _worker_crash(ctx: FaultContext, k: int = 1, sgs: Optional[int] = None,
                  spare: int = 1, **_: Any) -> None:
    scheds = ctx.schedulers(sgs)
    killed: List[int] = []
    n_retry = 0
    keep = max(1, spare)        # never take a pool to zero workers
    for _i in range(int(k)):
        eligible = [(s, w) for s in scheds if len(s.workers) > keep
                    for w in s.workers]
        if not eligible:
            break
        s, w = eligible[ctx.rng.randrange(len(eligible))]
        n_retry += fail_worker(s, w.worker_id)
        killed.append(w.worker_id)
    ctx.injector.n_retries += n_retry
    ctx.record("worker_crash", killed=killed, n_retry=n_retry)


@register_fault("sgs_failstop")
def _sgs_failstop(ctx: FaultContext, sgs: Optional[int] = None,
                  **_: Any) -> None:
    lbs = getattr(ctx.stack, "lbs", None)
    if lbs is None or sgs is None or sgs not in lbs.sgss:
        ctx.record("sgs_failstop", sgs=sgs, skipped=True)
        return
    replacement, n_retry = fail_sgs(lbs, sgs, ctx.injector.store, ctx.env)
    ctx.injector.n_retries += n_retry
    ctx.record("sgs_failstop", sgs=sgs, n_retry=n_retry,
               restored=replacement is not None)


@register_fault("mass_eviction")
def _mass_eviction(ctx: FaultContext, frac: float = 1.0,
                   sgs: Optional[int] = None, **_: Any) -> None:
    n_evicted = 0
    for sched in ctx.schedulers(sgs):
        for w in sched.workers:
            for s in w.sandboxes:       # fresh list: safe to remove during
                if s.state is SandboxState.BUSY:
                    continue            # executing: kill the worker instead
                if frac >= 1.0 or ctx.rng.random() < frac:
                    w.remove_sandbox(s)
                    n_evicted += 1
    ctx.record("mass_eviction", frac=frac, n_evicted=n_evicted)


def _collect_clocks(stack: Any, target: str) -> List[Any]:
    """The M/D/1 decision-service clocks a control-plane fault targets:
    LBS replica clocks and/or the per-SGS (or flat single) clocks."""
    clocks: List[Any] = []
    if target in ("lbs", "both"):
        clocks.extend(getattr(stack, "_lb_clocks", ()) or ())
    if target in ("sgs", "both"):
        sgs_clocks = getattr(stack, "_sgs_clocks", None)
        if sgs_clocks:
            clocks.extend(sgs_clocks.values())
        c = getattr(stack, "_clock", None)     # flat stacks: one clock
        if c is not None:
            clocks.append(c)
    return clocks


@register_fault("control_plane_delay")
def _control_plane_delay(ctx: FaultContext, stall: float = 0.05,
                         target: str = "both", **_: Any) -> None:
    # Modeled by advancing the M/D/1 decision-service clocks' busy_until:
    # decisions arriving behind the spike queue exactly as they would
    # behind a blocked single-threaded decision loop.  Data plane untouched.
    now = ctx.env.now()
    n_clocks = 0
    for c in _collect_clocks(ctx.stack, target):
        c.busy_until = max(c.busy_until, now) + stall
        n_clocks += 1
    ctx.record("control_plane_delay", stall=stall, target=target,
               n_clocks=n_clocks)


# -- correlated fault handlers (worker → rack → AZ topology) -----------------


def _topology(ctx: FaultContext) -> Any:
    """The cluster's placement topology.  Rack/AZ membership is arithmetic
    on globally consistent worker ids, so one ``ClusterConfig`` describes
    archipelago pools and the flat baseline pools alike."""
    from .cluster import ClusterConfig
    exp = getattr(ctx.stack, "exp", None)
    cc = getattr(exp, "cluster", None) if exp is not None else None
    return cc if cc is not None else ClusterConfig()


def _live_racks(scheds: List[Any], cc: Any) -> Dict[int, List[Tuple[Any, int]]]:
    """rack id → [(owning scheduler, worker_id)] over the live cluster."""
    live: Dict[int, List[Tuple[Any, int]]] = {}
    for s in scheds:
        for w in s.workers:
            live.setdefault(cc.rack_of(w.worker_id), []).append(
                (s, w.worker_id))
    return live


def _kill_rack(ctx: FaultContext, rack: int,
               members: List[Tuple[Any, int]]) -> int:
    """Fail-stop every worker in ``rack``; on archipelago the rack IS an
    SGS pool, so the orphaned scheduler is evacuated onto a survivor."""
    n_retry = 0
    for s, wid in sorted(members, key=lambda m: m[1]):
        n_retry += fail_worker(s, wid)
    lbs = getattr(ctx.stack, "lbs", None)
    if lbs is not None:
        n_retry += evacuate_sgs(lbs, rack)
    return n_retry


@register_fault("rack_power")
def _rack_power(ctx: FaultContext, rack: Optional[int] = None,
                spare_racks: int = 1, **_: Any) -> None:
    cc = _topology(ctx)
    live = _live_racks(ctx.schedulers(), cc)
    keep = max(0, int(spare_racks))
    if len(live) <= keep or (rack is not None and rack not in live):
        ctx.record("rack_power", rack=rack, skipped=True)
        return
    if rack is None:
        racks = sorted(live)
        rack = racks[ctx.rng.randrange(len(racks))]
    n_killed = len(live[rack])
    n_retry = _kill_rack(ctx, rack, live[rack])
    ctx.injector.n_retries += n_retry
    ctx.record("rack_power", rack=rack, n_killed=n_killed, n_retry=n_retry)


@register_fault("az_outage")
def _az_outage(ctx: FaultContext, az: Optional[int] = None,
               spare_azs: int = 1, **_: Any) -> None:
    cc = _topology(ctx)
    live = _live_racks(ctx.schedulers(), cc)
    per = max(1, cc.racks_per_az)
    zones: Dict[int, List[int]] = {}
    for r in sorted(live):
        zones.setdefault(r // per, []).append(r)
    keep = max(0, int(spare_azs))
    if len(zones) <= keep or (az is not None and az not in zones):
        ctx.record("az_outage", az=az, skipped=True)
        return
    if az is None:
        ids = sorted(zones)
        az = ids[ctx.rng.randrange(len(ids))]
    racks = zones[az]
    n_killed = sum(len(live[r]) for r in racks)
    n_retry = 0
    for r in racks:
        n_retry += _kill_rack(ctx, r, live[r])
    ctx.injector.n_retries += n_retry
    ctx.record("az_outage", az=az, racks=racks, n_killed=n_killed,
               n_retry=n_retry)


@register_fault("cascading_crash")
def _cascading_crash(ctx: FaultContext, p: float = 0.5, k0: int = 1,
                     max_kills: Optional[int] = None,
                     sgs: Optional[int] = None, spare: int = 1,
                     **_: Any) -> None:
    scheds = ctx.schedulers(sgs)
    keep = max(1, int(spare))   # same floor as worker_crash: pools survive
    limit = (int(max_kills) if max_kills is not None
             else sum(len(s.workers) for s in scheds))
    p = float(p)
    killed: List[int] = []
    n_retry = 0
    pending = int(k0)
    while pending > 0 and len(killed) < limit:
        eligible = [(s, w) for s in scheds if len(s.workers) > keep
                    for w in s.workers]
        if not eligible:
            break
        s, w = eligible[ctx.rng.randrange(len(eligible))]
        n_retry += fail_worker(s, w.worker_id)
        killed.append(w.worker_id)
        pending -= 1
        if ctx.rng.random() < p:    # the failure propagates
            pending += 1
    ctx.injector.n_retries += n_retry
    ctx.record("cascading_crash", p=p, killed=killed, n_retry=n_retry)


# -- degraded-mode (gray failure) handlers -----------------------------------


def _restore_speed(sched: Any, worker_id: int, factor: float) -> None:
    if sched._slow.get(worker_id) == factor:
        del sched._slow[worker_id]


@register_fault("slow_worker")
def _slow_worker(ctx: FaultContext, k: int = 1, factor: float = 4.0,
                 duration: Optional[float] = None,
                 sgs: Optional[int] = None, **_: Any) -> None:
    factor = float(factor)
    slowed: List[int] = []
    eligible = [(s, w.worker_id) for s in ctx.schedulers(sgs)
                if getattr(s, "_slow", None) is not None
                for w in s.workers if w.worker_id not in s._slow]
    for _i in range(int(k)):
        if not eligible:
            break
        s, wid = eligible.pop(ctx.rng.randrange(len(eligible)))
        s._slow[wid] = factor
        slowed.append(wid)
        if duration is not None:
            ctx.env.call_after(float(duration), _restore_speed, s, wid,
                               factor)
    ctx.record("slow_worker", factor=factor, slowed=slowed)


@register_fault("flaky_network")
def _flaky_network(ctx: FaultContext, jitter: float = 0.02,
                   target: str = "both", **_: Any) -> None:
    # Same seam as control_plane_delay, but each clock draws its own
    # seeded stall in [0, jitter) — jitter, not a synchronized pause.
    now = ctx.env.now()
    jitter = float(jitter)
    n_clocks = 0
    total = 0.0
    for c in _collect_clocks(ctx.stack, target):
        stall = ctx.rng.random() * jitter
        c.busy_until = max(c.busy_until, now) + stall
        n_clocks += 1
        total += stall
    ctx.record("flaky_network", jitter=jitter, n_clocks=n_clocks,
               total_stall=round(total, 6))


def _restore_pool_mem(w: Any, cut: float) -> None:
    w.pool_mem_mb += cut


@register_fault("memory_pressure")
def _memory_pressure(ctx: FaultContext, frac: float = 0.5,
                     duration: float = 1.0, sgs: Optional[int] = None,
                     **_: Any) -> None:
    frac = float(frac)
    n_workers = 0
    n_evicted = 0
    for sched in ctx.schedulers(sgs):
        for w in sched.workers:
            cut = w.pool_mem_mb * frac
            if cut <= 0.0:
                continue
            w.pool_mem_mb -= cut
            n_evicted += w.shed_to_capacity()
            n_workers += 1
            ctx.env.call_after(float(duration), _restore_pool_mem, w, cut)
    ctx.record("memory_pressure", frac=frac, duration=duration,
               n_workers=n_workers, n_evicted=n_evicted)


# ---------------------------------------------------------------------------
# Recovery metrics
# ---------------------------------------------------------------------------


def time_to_recovery(metrics: Any, t_fault: float, horizon: float,
                     window: float = 0.5, tolerance: float = 0.05,
                     baseline_windows: int = 4) -> Optional[Dict[str, Any]]:
    """Windowed time-to-deadline-recovery after a fault at ``t_fault``.

    baseline = deadline-met over the ``baseline_windows * window`` seconds
    before the fault; recovery = end of the first post-fault window whose
    deadline-met is back within ``tolerance`` of baseline.  Windows use the
    zero-copy ``Metrics.window`` views.  Returns ``{"baseline_met",
    "dip_met", "recovery_s"}`` (``recovery_s`` None if the run ends
    unrecovered; ``dip_met`` is the worst post-fault window) or None when
    there is no pre-fault signal to compare against."""
    t0 = max(0.0, t_fault - baseline_windows * window)
    base = metrics.window(t0, t_fault).deadline_met_frac()
    if base != base:        # NaN: nothing completed pre-fault
        return None
    target = base - tolerance
    dip: Optional[float] = None
    recovery_s: Optional[float] = None
    t = t_fault
    while t < horizon:
        m = metrics.window(t, min(t + window, horizon)).deadline_met_frac()
        if m == m:          # skip empty windows
            dip = m if dip is None else min(dip, m)
            if m >= target:
                recovery_s = (t + window) - t_fault
                break
        t += window
    out = {"baseline_met": round(base, 6),
           "recovery_s": None if recovery_s is None else round(recovery_s, 6)}
    out["dip_met"] = None if dip is None else round(dip, 6)
    return out


def recovery_summary(metrics: Any, injector: FaultInjector, horizon: float,
                     window: float = 0.5,
                     tolerance: float = 0.05) -> Dict[str, Any]:
    """Per-fired-fault recovery report for ``ExperimentResult.recovery``."""
    events: List[Dict[str, Any]] = []
    for rec in injector.fault_events:
        t = rec.get("t")
        if t is None:
            continue
        entry: Dict[str, Any] = {"kind": rec["kind"], "t": t}
        r = time_to_recovery(metrics, t, horizon, window, tolerance)
        if r is not None:
            entry.update(r)
        events.append(entry)
    # roll-up for the bench scoreboards: worst time-to-recovery across the
    # plan's fired faults, and how many measurable dips never recovered
    recovered = [e["recovery_s"] for e in events
                 if e.get("recovery_s") is not None]
    n_unrecovered = sum(1 for e in events
                        if "recovery_s" in e and e["recovery_s"] is None)
    return {"window_s": window, "tolerance": tolerance,
            "max_recovery_s": max(recovered) if recovered else None,
            "n_unrecovered": n_unrecovered, "events": events}
