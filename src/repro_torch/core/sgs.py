"""Semi-global scheduler (§4.1, §4.2): deadline-aware SRSF over a worker pool.

The SGS owns a partition of the cluster (its *worker pool*), a priority queue
of ready function invocations, an estimator module, and a sandbox manager
(Fig. 4a).  It is event-driven and time-agnostic: an ``Env`` provides ``now()``
and deferred callbacks, so the same class runs under simulated and real time.

Copy of ``src/repro/core/sgs.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from bisect import insort as _insort
from heapq import heappop as _heappop, heappush as _heappush
from typing import Callable, Dict, List, Optional, Protocol, Set, Tuple

from .estimator import DemandEstimator, RateEstimator
from .sandbox import SandboxManager, Worker, _sbx_sort_key
from .types import (DagSpec, ExecuteFn, FunctionSpec, Invocation, Request,
                    Sandbox, SandboxState, SubmitFn)


class Env(Protocol):
    """Minimal clock + timer interface implemented by repro_torch.sim and
    repro_torch.serving.  Extra ``*args`` are passed to ``fn`` at fire time, which
    lets hot paths avoid allocating a closure per deferred call."""

    def now(self) -> float: ...
    def call_after(self, delay: float, fn: Callable[..., None],
                   *args) -> None: ...


@dataclass
class SGSConfig:
    estimation_interval: float = 0.100   # estimator tick (§4.3.1)
    sla: float = 0.99
    ewma_alpha: float = 0.3
    qdelay_window: int = 20              # samples before a scaling decision
    proactive: bool = True               # proactive sandbox allocation on/off
    ramp_window: float = 2.0             # demand floor duration after an
                                         # LBS-triggered preallocation, so the
                                         # local estimator (which has seen no
                                         # arrivals yet) cannot immediately
                                         # soft-evict the warm-up pool

    even_placement: bool = True          # False -> packed placement (Fig. 9)
    fair_eviction: bool = True           # False -> LRU hard eviction (§7.3.1)
    # Beyond-paper enhancement (default on): reactive allocation at dispatch
    # revives a resident soft-evicted sandbox on the chosen worker at zero
    # cost (Pseudocode 1's preferential reuse applied to the reactive path).
    # Off reproduces the paper's behavior where only the background allocator
    # revives (used for the paper-faithful Fig. 9 ablation).
    revive_on_dispatch: bool = True


# report sent (piggybacked on responses, §5.2.1) to the LBS:
#   (dag_id, sgs_id, queuing_delay_sample, proactive_sandbox_count)
ReportFn = Callable[[str, int, float, int], None]

# shared sentinel marking a single-function request's DAG progress ("done on
# first completion") — avoids a set allocation per request for the dominant
# C1/C2 classes.  Immutable, so sharing is safe.
_SINGLE_FN: frozenset = frozenset()

_BUSY_ST = SandboxState.BUSY
_WARM_ST = SandboxState.WARM


def _slowed_done(env: Env, done: Callable[[float], None],
                 factor: float) -> Callable[[float], None]:
    """Degraded-worker wrapper for the async backend seam: the data plane
    computes the batch's completion instant normally, then the slow
    worker's copy surfaces ``(factor - 1) × exec_s`` later — the batch
    itself (and every healthy member) is unaffected."""
    def slowed(exec_s: float) -> None:
        extra = (factor - 1.0) * exec_s
        if extra > 0.0:
            env.call_after(extra, done, exec_s)
        else:
            done(exec_s)
    return slowed


class SemiGlobalScheduler:
    def __init__(self, sgs_id: int, workers: List[Worker], env: Env,
                 config: Optional[SGSConfig] = None,
                 execute: Optional[ExecuteFn] = None,
                 report: Optional[ReportFn] = None,
                 backend_submit: Optional[SubmitFn] = None):
        self.sgs_id = sgs_id
        self.workers = workers
        self.env = env
        self.cfg = config or SGSConfig()
        # asynchronous execution seam (core.backends): dispatch hands the
        # invocation to the data plane and returns; the backend fires the
        # completion callback later, so the control plane (queue pops,
        # proactive allocation, scaling ticks) never blocks on execution
        self.backend_submit = backend_submit
        self.execute = execute      # legacy synchronous hook (blocks dispatch
                                    # for the execution call); None = modeled
                                    # timing (fn.exec_time)
        self.report = report                # piggyback channel to the LBS

        self.estimator = DemandEstimator(sla=self.cfg.sla,
                                         interval=self.cfg.estimation_interval,
                                         alpha=self.cfg.ewma_alpha)
        self.sandboxes = SandboxManager(
            workers=workers,
            placement="even" if self.cfg.even_placement else "packed",
            eviction="fair" if self.cfg.fair_eviction else "lru")

        # SRSF priority queue of ready invocations (static key, §4.2),
        # flattened to (deadline-rcp, rcp, inv_id, inv) 4-tuples: identical
        # ordering to the old ((k0, k1, id), inv) nesting (inv_id uniquifies
        # before the Invocation could ever be compared) without a nested
        # tuple allocation per push
        self._queue: List[Tuple[float, float, int, Invocation]] = []
        self._dags: Dict[str, DagSpec] = {}       # DAGs this SGS serves
        # fn name -> (floor demand, expiry) set by LBS preallocation
        self._demand_floor: Dict[str, Tuple[int, float]] = {}
        self._ticking = False
        # fault tolerance (§6.1): in-flight tracking + failed-worker view
        # (worker_id -> {inv_id -> Invocation}, insertion-ordered like the
        # old per-worker list but with O(1) completion removal)
        self._inflight: Dict[int, Dict[int, Invocation]] = {}
        self._dead_workers: Set[int] = set()
        # SGS fail-stop (§6.1, core.fault.fail_sgs): when this instance is
        # killed and replaced, deferred callbacks already bound to it
        # (submit_request from routed-but-unfired arrivals, _complete from
        # executions still running on surviving workers) forward to the
        # replacement instead of mutating dead state
        self._successor: Optional["SemiGlobalScheduler"] = None
        # incremental pool-wide free-core count: _dispatch's work-conserving
        # loop gate is O(1) instead of an O(W) any() per queue pop
        self._free_cores = sum(w.cores - w.busy_cores for w in workers)
        # per-dag cached [_FnIndex, ...] for the piggyback sandbox count
        self._dag_fis: Dict[str, List[object]] = {}
        # gray-failure state (core.fault): per-worker execution-time
        # multipliers (slow_worker), the batching data plane's dead-member
        # release hook, and the hedged-retry config (threaded from validated
        # Experiment.params by ArchipelagoStack.build).  All default off —
        # the zero-fault hot path only pays an ``if {}:`` / ``is None`` test.
        self._slow: Dict[int, float] = {}
        self.backend_drop: Optional[Callable[[List[int]], None]] = None
        self._hedge_timeout: Optional[float] = None
        self._hedge_jitter: float = 0.0
        self._hedge_rng = None
        self.n_hedges = 0

        # metrics
        self.n_cold_starts = 0
        self.n_warm_hits = 0
        self.queuing_delays: List[float] = []
        self.queuing_delay_times: List[float] = []   # dispatch timestamps
        self.completed_requests: List[Request] = []
        # flat-metrics completion hook (``Metrics.record_completion``): when
        # set, completed requests are folded into the run's column buffers
        # and released instead of accumulating on ``completed_requests``
        self.on_complete: Optional[Callable[[Request, float], None]] = None

    # ---------------------------------------------------------------- intake
    def submit_request(self, req: Request) -> None:
        """Entry point from the LBS. Enqueues the DAG's root invocations."""
        succ = self._successor
        if succ is not None:        # failed over: the replacement serves it
            succ.submit_request(req)
            return
        now = self.env.now()
        req.sgs_id = self.sgs_id
        dag = req.dag
        self._dags[dag.dag_id] = dag
        # DAG progress rides on the request (attribute load on the
        # completion path instead of a per-request dict entry); single-
        # function DAGs (the common classes) need no progress set — the
        # shared immutable sentinel marks "completes on first invocation"
        req.fns_done = set() if dag._n_fns > 1 else _SINGLE_FN
        # arrival statistics feed the estimator for every constituent
        # function (DemandEstimator.record_arrival hand-inlined: this loop
        # runs once per invocation)
        est_ = self.estimator
        rates = est_._rates
        for f in dag.functions:
            est = rates.get(f.name)
            if est is None:
                est = rates[f.name] = RateEstimator(est_.interval,
                                                    est_.alpha)
            if now - est._window_start >= est.interval:
                est._roll(now)
            est._count += 1
        if not self._ticking:
            self._ensure_ticking()
        queue = self._queue
        roots = dag._roots
        if not queue and len(roots) == 1 and self._free_cores > 0:
            # bypass the heap: the queue is empty and this request's single
            # root would be popped right back by _dispatch — start it
            # directly (identical decision); a failed start queues the
            # invocation exactly like a skipped pop would
            root = roots[0]
            inv = Invocation(request=req, fn=dag._fn_map[root],
                             ready_time=now)
            worker, sbx = self._choose_worker(inv, now)
            if worker is not None and self._start(inv, worker, sbx, now):
                return
            rcp = dag._rcp[root]
            _heappush(queue,
                      (req.arrival_time + dag.deadline - rcp, rcp,
                       inv.inv_id, inv))
            return
        abs_deadline = req.arrival_time + dag.deadline
        rcp_map = dag._rcp
        fn_map = dag._fn_map
        for root in roots:
            inv = Invocation(request=req, fn=fn_map[root], ready_time=now)
            rcp = rcp_map[root]
            _heappush(queue, (abs_deadline - rcp, rcp, inv.inv_id, inv))
        if self._free_cores > 0:    # inlined _dispatch entry gate
            self._dispatch()

    def preallocate(self, dag: DagSpec, n_per_fn: int) -> None:
        """LBS-triggered warm-up during gradual scale-out (§5.2.3)."""
        now = self.env.now()
        self._dags[dag.dag_id] = dag
        self._ensure_ticking()
        for f in dag.functions:
            self._demand_floor[f.name] = (n_per_fn, now + self.cfg.ramp_window)
            cur = self.sandboxes.demand_map.get(f.name, 0)
            if n_per_fn > cur:
                self.sandboxes.set_demand(f, n_per_fn, now)

    # --------------------------------------------------------------- dispatch
    def _dispatch(self) -> None:
        """Work-conserving SRSF dispatch: repeatedly pick the queued
        invocation with the least remaining slack whose resource requirements
        can currently be met, and run it (§4.2)."""
        queue = self._queue
        if not queue or self._free_cores <= 0:
            return
        now = self.env.now()
        pop = heapq.heappop
        choose = self._choose_worker
        start = self._start
        skipped: Optional[List[Tuple[float, float, int, Invocation]]] = None
        while queue and self._free_cores > 0:
            item = pop(queue)
            worker, sbx = choose(item[3], now)
            if worker is None or not start(item[3], worker, sbx, now):
                if skipped is None:
                    skipped = [item]
                else:
                    skipped.append(item)
        if skipped:
            push = heapq.heappush
            for item in skipped:
                push(queue, item)

    def _choose_worker(self, inv: Invocation, now: float
                       ) -> Tuple[Optional[Worker], Optional[Sandbox]]:
        """Prefer a free-core worker holding a WARM sandbox for this function
        (the whole point of even placement); otherwise any free-core worker
        that can fit a reactive sandbox.

        Phase 1 consults the manager's per-function index of workers holding
        idle (WARM/ALLOCATING) sandboxes instead of scanning the whole pool;
        within it, ``warm_available`` performs the same lazy ALLOCATING->WARM
        promotion on every probed candidate as the legacy full scan, and ties
        on warm-copy count break toward the earliest worker in pool order —
        decision order is identical to the legacy code.  Phase 2 (no warm
        candidate anywhere, so phase 1 had no side effects) resolves the
        soft-revival / reactive-cold fallbacks with O(1) per-worker checks.
        """
        fn_name = inv.fn.name
        # deliberate private-index access throughout: this is the hottest
        # loop in the simulator and an accessor call per probe is measurable
        mgr = self.sandboxes
        fi = mgr._fns.get(fn_name)
        if fi is not None:
            if fi.n_alloc == 0:
                # Fast path: no ALLOCATING sandbox of this function anywhere
                # in the pool, so the legacy walk has no lazy-promotion side
                # effects and its answer reduces to "most warm copies,
                # earliest pool position, with a free core" — served from
                # the lazy warm-candidate max-heap in O(log W) amortized.
                # Entries are validated against the live warm count (and
                # worker ownership) at pop; valid entries whose worker has
                # no free core right now are re-pushed after the search.
                heap = fi.warm_heap
                stash = None
                pick_w: Optional[Worker] = None
                pick_s: Optional[Sandbox] = None
                while heap:
                    e = heap[0]
                    w = e[2]
                    warm = e[3].warm
                    if len(warm) != -e[0]:
                        _heappop(heap)              # stale count
                        continue
                    if w.busy_cores >= w.cores:
                        _heappop(heap)              # valid but ineligible
                        if stash is None:
                            stash = [e]
                        else:
                            stash.append(e)
                        continue
                    pick_w = w
                    pick_s = warm[0]
                    break
                if stash is not None:
                    for e in stash:
                        _heappush(heap, e)
                if pick_w is not None:
                    return pick_w, pick_s
            else:
                warm_best: Optional[Worker] = None
                warm_best_count = -1
                warm_sbx: Optional[Sandbox] = None
                for _, w, b in fi.idle_sorted:
                    if w.busy_cores >= w.cores:
                        continue
                    if b.alloc:
                        # lazy ALLOCATING->WARM promotion can fire: full
                        # legacy probe
                        s = w.warm_available(fn_name, now)
                        if s is None:
                            continue
                    else:
                        # no ALLOCATING sandbox -> no promotion possible,
                        # and a WARM sandbox is always past its ready_at
                        # (time is monotone), so the probe reduces to the
                        # bucket head
                        warm = b.warm
                        if not warm:
                            continue
                        s = warm[0]
                    # among warm candidates prefer the one with most warm
                    # copies
                    c = len(b.warm)
                    if c > warm_best_count:
                        warm_best, warm_best_count, warm_sbx = w, c, s
                if warm_best is not None:
                    return warm_best, warm_sbx
        revive = (self.cfg.revive_on_dispatch
                  and fi is not None and bool(fi.soft))
        mem_mb = inv.fn.mem_mb
        cold_best: Optional[Worker] = None
        for w in self.workers:
            if w.busy_cores >= w.cores:
                continue
            if revive and w.has_ready_soft(fn_name, now):
                return w, None      # _start revives it instantly
            if cold_best is None and (w.pool_mem_mb - w._used_pool_mem
                                      >= mem_mb
                                      or len(w._sandboxes) > w._n_busy):
                if not revive:
                    return w, None  # nothing revivable anywhere: first fit
                cold_best = w
        return cold_best, None

    def _start(self, inv: Invocation, w: Worker, sbx: Optional[Sandbox],
               now: float) -> bool:
        """Run ``inv`` on ``w`` (or, on a cold start the chosen worker cannot
        host, fall back to another free-core worker).  Returns False when no
        worker can host a reactive sandbox — the caller requeues the
        invocation instead of overcommitting a proactive memory pool.  On
        failure no scheduling bookkeeping is touched, but attempted hard
        evictions may already have removed unprotected sandboxes on probed
        workers (HARDEVICT evicts one victim at a time and only then
        discovers the remainder is protected — same partial-progress
        semantics as the paper's Pseudocode 1 / the legacy scan code)."""
        setup = 0.0
        if sbx is None:
            # reactive allocation: per Pseudocode 1, preferentially revive a
            # resident soft-evicted sandbox — unmarking incurs no overhead
            revived = (w.find(inv.fn.name, SandboxState.SOFT_EVICTED)
                       if self.cfg.revive_on_dispatch else None)
            if revived is not None and revived.ready_at <= now + 1e-12:
                self.sandboxes.n_revivals += 1
                self.n_warm_hits += 1
                sbx = revived
            else:
                # true cold start: set up a new sandbox on the critical path
                setup = inv.fn.setup_time
                sbx = self.sandboxes.reactive_allocate(w, inv.fn, now)
                if sbx is None:
                    # the chosen worker can't host without harming a
                    # protected function: fall back to any other free-core
                    # worker that can, else requeue — never overcommit, but
                    # never starve while the pool has capacity either
                    mem_mb = inv.fn.mem_mb
                    for cand in self.workers:
                        if cand is w or cand.free_cores <= 0:
                            continue
                        if (cand.free_pool_mem >= mem_mb
                                or cand.has_non_busy_sandbox()):
                            sbx = self.sandboxes.reactive_allocate(
                                cand, inv.fn, now)
                            if sbx is not None:
                                w = cand
                                break
                    if sbx is None:
                        return False    # nowhere to host: requeue
                inv.cold_start = True
                inv.request.n_cold_starts += 1
                self.n_cold_starts += 1
            sbx.state = SandboxState.BUSY
        else:
            self.n_warm_hits += 1
            # warm hit: fused WARM->BUSY transition (the dominant case).
            # Hand-inlined SandboxManager.mark_busy — that method is the
            # reference implementation; any change there must land here too
            # (tests/test_equivalence.py pins the shared behavior).
            mgr = self.sandboxes
            name = sbx.fn.name
            b = w._buckets[name]
            warm = b.warm
            warm.remove(sbx)
            b.busy_n += 1
            w._n_busy += 1
            sbx._state = _BUSY_ST
            fi = mgr._fns[name]
            if warm:
                heap = fi.warm_heap
                _heappush(heap, (-len(warm), w.pool_index, w, b))
                if len(heap) > mgr.heap_cap:
                    mgr._compact_warm(name, fi)
            elif not b.alloc:
                if w in fi.idle:
                    fi.idle.remove(w)
                    fi.idle_sorted.remove((w.pool_index, w, b))
        sbx.last_used = now
        inv.start_time = now
        qdelay = now - inv.ready_time
        self.queuing_delays.append(qdelay)
        self.queuing_delay_times.append(now)
        req = inv.request
        req.total_queuing_delay += qdelay
        w.busy_cores += 1
        self._free_cores -= 1

        # piggyback queuing delay + per-DAG sandbox count to the LBS (§5.2.1)
        if self.report is not None:
            dag_id = req.dag.dag_id
            self.report(dag_id, self.sgs_id, qdelay,
                        self.proactive_sandbox_count(dag_id))

        inflight = self._inflight.get(w.worker_id)
        if inflight is None:
            inflight = self._inflight[w.worker_id] = {}
        inflight[inv.inv_id] = inv
        slow = self._slow
        m = slow.get(w.worker_id) if slow else None
        if self.backend_submit is not None:
            # asynchronous seam: hand the invocation to the data plane and
            # keep scheduling — the backend (possibly batching it with other
            # in-flight invocations) fires `done` at the completion instant
            done = self._make_done(inv, w, sbx)
            if m is not None:
                done = _slowed_done(self.env, done, m)
            self.backend_submit(inv, done, setup)
        elif self.execute is not None:
            # legacy synchronous hook: runs the execution call inside the
            # dispatch path and blocks on it (kept for direct constructions)
            exec_s = self.execute(inv)
            if m is not None:
                exec_s *= m
            self.env.call_after(setup + exec_s, self._complete, inv, w, sbx)
        else:
            exec_s = inv.fn.exec_time
            if m is not None:
                exec_s *= m
            self.env.call_after(setup + exec_s,
                                self._complete, inv, w, sbx)
        ht = self._hedge_timeout
        if ht is not None:
            # per-invocation dispatch timeout: the hedge deadline scales
            # with the invocation's expected execution time (a straggler is
            # "ht× slower than expected"), plus seeded jitter so a stalled
            # batch doesn't hedge in lockstep
            t = ht * inv.fn.exec_time
            rng = self._hedge_rng
            if rng is not None and self._hedge_jitter > 0.0:
                t *= 1.0 + self._hedge_jitter * rng.random()
            self.env.call_after(setup + t, self._hedge_check, w.worker_id,
                                inv.inv_id, inv)
        return True

    def _make_done(self, inv: Invocation, w: Worker, sbx: Sandbox
                   ) -> Callable[[float], None]:
        """Completion callback for the async seam: fired by the backend at
        the invocation's completion instant with its actual runtime."""
        def done(exec_s: float) -> None:
            self._complete(inv, w, sbx)
        return done

    def _hedge_check(self, worker_id: int, inv_id: int,
                     inv: Invocation) -> None:
        """Straggler mitigation: if the dispatched copy has not completed
        by its hedge deadline, enqueue a speculative duplicate (a fresh
        ``Invocation``, so it dispatches like any retry — possibly onto a
        healthy worker).  Whichever copy completes first wins; the loser's
        completion is dropped by the inflight-generation guard and the
        ``fns_done`` duplicate guard in ``_complete``, so a request is
        never double-counted.  A duplicate that still straggles re-hedges
        after its own timeout."""
        succ = self._successor
        if succ is not None:        # failed over: the replacement judges it
            succ._hedge_check(worker_id, inv_id, inv)
            return
        inflight = self._inflight.get(worker_id)
        if inflight is None or inv_id not in inflight:
            return          # completed in time (or the worker died and the
                            # crash path already queued a retry)
        req = inv.request
        done = req.fns_done
        if done is None:
            return          # request finished through another invocation
        if done is not _SINGLE_FN and inv.fn.name in done:
            return          # an earlier hedge already won this function
        self.n_hedges += 1
        retry = Invocation(request=req, fn=inv.fn,
                           ready_time=self.env.now())
        k0, k1, k2 = retry.priority_key()
        _heappush(self._queue, (k0, k1, k2, retry))
        if self._free_cores > 0:
            self._dispatch()

    def _complete(self, inv: Invocation, w: Worker, sbx: Sandbox) -> None:
        succ = self._successor
        if succ is not None:        # failed over: completions continue there
            succ._complete(inv, w, sbx)
            return
        now = self.env.now()
        # Inflight-generation guard: a completion is only valid if *this*
        # invocation is still registered in flight on *this* worker.  Drops
        # stale ``done()`` callbacks from the async backend seam for (a)
        # workers that died after submission (fail_worker popped the whole
        # per-worker dict) and (b) invocations that were re-enqueued as
        # retries (the retry is a fresh Invocation with its own inv_id, so a
        # late original can never double-complete it).  On the healthy path
        # every completion pops its own registration — decision-identical.
        inflight = self._inflight.get(w.worker_id)
        if inflight is None or inflight.pop(inv.inv_id, None) is None:
            return      # fail-stop: this execution was lost and retried
        w.busy_cores -= 1
        self._free_cores += 1
        # fused BUSY->WARM transition (every completion takes it).
        # Hand-inlined SandboxManager.mark_warm — that method is the
        # reference implementation; any change there must land here too
        # (tests/test_equivalence.py pins the shared behavior).
        mgr = self.sandboxes
        name = inv.fn.name
        b = w._buckets[name]
        _insort(b.warm, sbx, key=_sbx_sort_key)
        b.busy_n -= 1
        w._n_busy -= 1
        sbx._state = _WARM_ST
        fi = mgr._fns[name]
        cap = mgr.heap_cap
        if w not in fi.idle:
            fi.idle.add(w)
            _insort(fi.idle_sorted, (w.pool_index, w, b))
        heap = fi.warm_heap
        _heappush(heap, (-len(b.warm), w.pool_index, w, b))
        if len(heap) > cap:
            mgr._compact_warm(name, fi)
        c = len(b.alloc) + len(b.warm) + b.busy_n
        if b.evict_pushed != c:
            b.evict_pushed = c
            heap = fi.evict_heap
            _heappush(heap, mgr._evict_key(c, w.worker_id))
            if len(heap) > cap:
                mgr._compact(name, heap, mgr._evict_key)
        if sbx.ready_at > now:
            sbx.ready_at = now
        sbx.last_used = now
        req = inv.request
        done = req.fns_done
        if done is None:        # request finished elsewhere (defensive)
            if self._queue and self._free_cores > 0:
                self._dispatch()
            return
        dag = req.dag
        if done is _SINGLE_FN:
            finished = True
        else:
            if inv.fn.name in done:
                # hedged duplicate of an already-counted completion: the
                # winner made the DAG progress and released the children —
                # this copy only returns its core/sandbox (done above)
                if self._queue and self._free_cores > 0:
                    self._dispatch()
                return
            done.add(inv.fn.name)
            finished = len(done) == dag._n_fns
        if finished:
            req.completion_time = now
            req.fns_done = None
            rec = self.on_complete
            if rec is not None:
                rec(req, now)
            else:
                self.completed_requests.append(req)
        else:
            # DAG awareness: release children whose parents all completed
            abs_deadline = req.arrival_time + dag.deadline
            for child in dag._children[inv.fn.name]:
                if all(p in done for p in dag._parents[child]):
                    cinv = Invocation(request=req, fn=dag._fn_map[child],
                                      ready_time=now)
                    rcp = dag._rcp[child]
                    _heappush(self._queue,
                              (abs_deadline - rcp, rcp, cinv.inv_id,
                               cinv))
        if self._queue and self._free_cores > 0:    # inlined dispatch gate
            self._dispatch()

    # ----------------------------------------------------------- estimation
    def _ensure_ticking(self) -> None:
        if self._ticking or not self.cfg.proactive:
            return
        self._ticking = True
        self.env.call_after(self.cfg.estimation_interval, self._tick)

    def _tick(self) -> None:
        """Estimator tick: refresh per-function demand and drive the sandbox
        manager (allocate / soft-evict) — runs off the critical path."""
        now = self.env.now()
        for dag in self._dags.values():
            for f in dag.functions:
                d = self.estimator.demand(f.name, f.exec_time, now)
                floor = self._demand_floor.get(f.name)
                if floor is not None:
                    if now < floor[1]:
                        d = max(d, floor[0])
                    else:
                        del self._demand_floor[f.name]
                self.sandboxes.set_demand(f, d, now)
        self.env.call_after(self.cfg.estimation_interval, self._tick)

    # -------------------------------------------------------------- queries
    def queue_length(self) -> int:
        return len(self._queue)

    def proactive_sandbox_count(self, dag_id: str) -> int:
        # per-dispatch piggyback path: read the per-function schedulable
        # totals straight off the manager indices (= total_sandboxes, O(1)).
        # The _FnIndex objects are stable once created, so the per-dag list
        # is resolved once and reused.
        fis = self._dag_fis.get(dag_id)
        if fis is None:
            dag = self._dags.get(dag_id)
            if dag is None:
                return 0
            mgr = self.sandboxes
            fis = self._dag_fis[dag_id] = [
                mgr._fns.get(f.name) or mgr._ensure_fn(f.name)
                for f in dag.functions]
        if len(fis) == 1:       # single-function DAGs: the dominant case
            return fis[0].total
        total = 0
        for fi in fis:
            total += fi.total
        return total
