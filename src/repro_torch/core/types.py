"""Core datatypes shared by the scheduler, load balancer and executors.

Copy of ``src/repro/core/types.py`` (the port imports nothing of ``repro``).

Time is measured in float seconds.  All components are *time-agnostic*: they
never read a wall clock; ``now`` is always passed in explicitly so that the
same code runs under the discrete-event simulator (``sim``) and the
real-execution serving engine (``serving``).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Function / DAG specifications (what the user uploads, §2.1 / §3)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FunctionSpec:
    """A single serverless function: one node of an application DAG."""

    name: str
    exec_time: float            # seconds of pure execution (paper's "execution time")
    mem_mb: float = 128.0       # provisioned memory (T4: 128MB is the common case)
    setup_time: float = 0.250   # sandbox setup overhead (125-400ms modeled, §7.1)

    def __post_init__(self):
        if self.exec_time <= 0:
            raise ValueError(f"exec_time must be positive, got {self.exec_time}")
        if self.mem_mb <= 0:
            raise ValueError(f"mem_mb must be positive, got {self.mem_mb}")


@dataclass(frozen=True)
class DagSpec:
    """An application: a DAG of functions plus a latency deadline.

    ``deadline`` is the user-specified maximum end-to-end execution time for
    one request of this DAG (critical-path exec time + slack), per §3
    "Initial DAG Upload".
    """

    dag_id: str
    functions: Tuple[FunctionSpec, ...]
    # edges are (upstream_name, downstream_name) I/O dependencies
    edges: Tuple[Tuple[str, str], ...] = ()
    deadline: float = 1.0

    def __post_init__(self):
        names = [f.name for f in self.functions]
        if len(set(names)) != len(names):
            raise ValueError("duplicate function names in DAG")
        known = set(names)
        for u, v in self.edges:
            if u not in known or v not in known:
                raise ValueError(f"edge ({u},{v}) references unknown function")
        # Precompute the adjacency/critical-path views once: fn/parents/
        # children/remaining_critical_path sit on the per-invocation hot path
        # (SRSF priority keys, DAG-progress release), and a frozen spec never
        # changes.  ``object.__setattr__`` because the dataclass is frozen.
        fn_map = {f.name: f for f in self.functions}
        parents: Dict[str, List[str]] = {n: [] for n in fn_map}
        children: Dict[str, List[str]] = {n: [] for n in fn_map}
        for u, v in self.edges:
            parents[v].append(u)
            children[u].append(v)
        object.__setattr__(self, "_fn_map", fn_map)
        object.__setattr__(self, "_n_fns", len(self.functions))
        object.__setattr__(self, "_parents", parents)
        object.__setattr__(self, "_children", children)
        object.__setattr__(self, "_roots",
                           [n for n in fn_map if not parents[n]])
        # topological order; raises on cycles
        indeg = {n: len(parents[n]) for n in fn_map}
        frontier = [n for n, d in indeg.items() if d == 0]
        order: List[str] = []
        while frontier:
            n = frontier.pop()
            order.append(n)
            for c in children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    frontier.append(c)
        if len(order) != len(self.functions):
            raise ValueError("DAG contains a cycle")
        object.__setattr__(self, "_topo", order)
        # remaining critical path per node (Kelley [32,33]), leaves-first
        rcp: Dict[str, float] = {}
        for n in reversed(order):
            tail = max((rcp[k] for k in children[n]), default=0.0)
            rcp[n] = fn_map[n].exec_time + tail
        object.__setattr__(self, "_rcp", rcp)
        object.__setattr__(self, "_cp_time",
                           max((rcp[r] for r in self._roots), default=0.0))

    # -- graph helpers (all O(1) dict lookups on the cached views) ----------
    def fn(self, name: str) -> FunctionSpec:
        try:
            return self._fn_map[name]
        except KeyError:
            raise KeyError(name) from None

    def parents(self, name: str) -> List[str]:
        return self._parents[name]

    def children(self, name: str) -> List[str]:
        return self._children[name]

    def roots(self) -> List[str]:
        return self._roots

    def topo_order(self) -> List[str]:
        return list(self._topo)

    def critical_path_time(self) -> float:
        """Critical-path execution time of the whole DAG (Kelley [32,33])."""
        return self._cp_time

    def remaining_critical_path(self, name: str) -> float:
        """Critical-path exec time of the DAG suffix rooted at ``name``
        (inclusive).  Used for remaining-slack computation (§4.2)."""
        return self._rcp[name]

    @property
    def slack(self) -> float:
        """Total slack the user granted on top of the critical path."""
        return self.deadline - self._cp_time

    def with_deadline(self, deadline: Optional[float] = None, *,
                      slack: Optional[float] = None) -> "DagSpec":
        """Copy with a new deadline — absolute (``deadline=``) or derived
        from the cached critical path (``slack=`` sets it to
        ``critical_path_time() + slack``).  This is how calibrated serving
        DAGs get their measured deadlines without hand-rolling a second
        construction pass."""
        if (deadline is None) == (slack is None):
            raise ValueError("pass exactly one of deadline= or slack=")
        if slack is not None:
            deadline = self._cp_time + slack
        return dataclasses.replace(self, deadline=deadline)


# ---------------------------------------------------------------------------
# Requests and function invocations (runtime objects)
# ---------------------------------------------------------------------------

_req_counter = itertools.count()
_inv_counter = itertools.count()


@dataclass(slots=True, eq=False)
class Request:
    """One trigger event for a DAG.  Identity-compared (``eq=False``):
    requests are unique runtime objects, and membership tests sit on the
    completion hot path."""

    dag: DagSpec
    arrival_time: float
    req_id: int = field(default_factory=_req_counter.__next__)
    completion_time: Optional[float] = None
    # bookkeeping
    n_cold_starts: int = 0
    total_queuing_delay: float = 0.0
    sgs_id: Optional[int] = None   # which SGS served it (set by LBS routing)
    # row index in a run's flat metrics columns (the JAX package's
    # sim.metrics); -1 outside column-recording runs
    m_idx: int = -1
    # DAG-progress state owned by the serving scheduler (the set of
    # completed function names; a shared sentinel for single-function DAGs;
    # None once the request finished or before it was accepted) — carried on
    # the request so the completion hot path pays an attribute load instead
    # of a per-request dict entry
    fns_done: Optional[object] = None

    @property
    def abs_deadline(self) -> float:
        return self.arrival_time + self.dag.deadline

    @property
    def e2e_latency(self) -> Optional[float]:
        if self.completion_time is None:
            return None
        return self.completion_time - self.arrival_time

    @property
    def deadline_met(self) -> Optional[bool]:
        if self.completion_time is None:
            return None
        return self.completion_time <= self.abs_deadline + 1e-9


@dataclass(slots=True, eq=False)
class Invocation:
    """One function execution belonging to a request (a DAG node instance).
    Identity-compared, like ``Request``."""

    request: Request
    fn: FunctionSpec
    ready_time: float                       # when dependencies were met
    inv_id: int = field(default_factory=_inv_counter.__next__)
    start_time: Optional[float] = None
    cold_start: bool = False

    # -- deadline-aware priority (§4.2) --------------------------------------
    def remaining_critical_path(self) -> float:
        return self.request.dag.remaining_critical_path(self.fn.name)

    def remaining_slack(self, now: float) -> float:
        """Time this invocation can still be queued without pushing the DAG
        past its deadline, assuming the remaining suffix runs back-to-back."""
        return (self.request.abs_deadline - now) - self.remaining_critical_path()

    def priority_key(self) -> Tuple[float, float, int]:
        """Static SRSF key: at any common ``now``, ordering by
        ``abs_deadline - remaining_cp`` is identical to ordering by remaining
        slack; ties broken by least remaining work (paper §4.2), then FIFO."""
        rcp = self.remaining_critical_path()
        return (self.request.abs_deadline - rcp, rcp, self.inv_id)


class SandboxState(enum.Enum):
    ALLOCATING = "allocating"       # being set up (setup_time in flight)
    WARM = "warm"                   # ready for reuse, idle
    BUSY = "busy"                   # currently executing an invocation
    SOFT_EVICTED = "soft_evicted"   # resident but not schedulable (§4.3.3)


_sbx_counter = itertools.count()


class Sandbox:
    """A (possibly idle) execution environment resident on one worker.

    ``state`` is a property: assigning it keeps the owning worker's
    per-``(fn, state)`` indices in sync (see ``sandbox.Worker``), so all
    existing call sites — and tests — can keep mutating ``sbx.state``
    directly while queries stay O(1).
    """

    __slots__ = ("fn", "worker_id", "_state", "ready_at", "last_used",
                 "sbx_id", "_worker")

    def __init__(self, fn: FunctionSpec, worker_id: int, state: SandboxState,
                 ready_at: float = 0.0, last_used: float = 0.0):
        self.fn = fn
        self.worker_id = worker_id
        self._state = state
        self.ready_at = ready_at                # when ALLOCATING finishes
        self.last_used = last_used
        self.sbx_id = next(_sbx_counter)
        self._worker = None                     # set by Worker.add_sandbox

    @property
    def state(self) -> SandboxState:
        return self._state

    @state.setter
    def state(self, new: SandboxState) -> None:
        old = self._state
        if new is old:
            return
        self._state = new
        if self._worker is not None:
            self._worker._reindex(self, old, new)

    def __repr__(self) -> str:
        return (f"Sandbox(fn={self.fn.name!r}, worker_id={self.worker_id}, "
                f"state={self._state}, ready_at={self.ready_at}, "
                f"last_used={self.last_used}, sbx_id={self.sbx_id})")


# Callback the scheduler uses to run a function.  Returns actual runtime (s).
# Simulated executors return fn.exec_time (+ jitter); the real executor runs a
# model call and returns measured wall time.
#
# This is the *legacy synchronous* data-plane hook: the scheduler blocks on
# it inside its dispatch path, so a real backend can only run one invocation
# at a time.  New backends implement the asynchronous ``SubmitFn`` seam
# below; ``ExecuteFn`` hooks are adapted automatically
# (the JAX package's ``core.backends.ExecutionBackend.bind``).
ExecuteFn = Callable[[Invocation], float]

# Completion callback, provided by the scheduler per dispatched invocation.
# The backend invokes ``done(exec_seconds)`` *at the sim instant the
# invocation finishes* (i.e. via ``env.call_after``, never synchronously from
# inside ``submit``); ``exec_seconds`` is the execution time that was charged
# (measured wall seconds for real backends).
DoneFn = Callable[[float], None]

# Asynchronous execution seam: ``submit(inv, done, delay)`` hands an
# invocation to the data plane and returns immediately — the scheduler's
# control loop (queue pops, proactive allocation, scaling ticks) keeps
# running while the backend executes, possibly coalescing concurrently
# in-flight invocations into batches.  ``delay`` is scheduler-side time that
# must elapse before execution can begin (cold-start sandbox setup): the
# backend fires ``done(exec_s)`` at ``now + delay + exec_s``.
SubmitFn = Callable[[Invocation, DoneFn, float], None]
