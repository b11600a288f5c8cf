"""Baseline scheduling stacks the paper compares against (§2.4, §7.1).

* ``CentralizedFIFO`` — the paper's main baseline: one global scheduler,
  FIFO request order, *reactive* sandbox allocation, fixed keep-alive
  (15 min) eviction.  Mirrors OpenWhisk-style platforms [3].
* ``SparrowScheduler`` — parallel global scheduling with power-of-two random
  probing [41] (Fig. 2d): per-worker FIFO queues, no sandbox awareness.

Copy of ``src/repro/core/baselines.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import heapq
import random
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from .sandbox import Worker
from .sgs import Env, _slowed_done
from .types import (DagSpec, ExecuteFn, Invocation, Request, Sandbox,
                    SandboxState, SubmitFn)


class CentralizedFIFO:
    """One cluster-wide FIFO queue; reactive sandboxes with keep-alive."""

    def __init__(self, workers: List[Worker], env: Env,
                 keepalive: float = 900.0,
                 execute: Optional[ExecuteFn] = None,
                 backend_submit: Optional[SubmitFn] = None):
        self.workers = workers
        self.env = env
        self.keepalive = keepalive
        # async execution seam (core.backends); falls back to the legacy
        # synchronous `execute` hook, then to modeled timing
        self.backend_submit = backend_submit
        self.execute = execute
        self._queue: Deque[Invocation] = deque()
        self._completed_fns: Dict[int, set] = {}
        # fault tolerance (§6.1): in-flight registrations + failed-worker
        # view, same shape as SemiGlobalScheduler (worker_id -> {inv_id ->
        # Invocation}); completions validate against it so a worker crash
        # never fires stale state mutations (core.fault.fail_worker)
        self._inflight: Dict[int, Dict[int, Invocation]] = {}
        self._dead_workers: set = set()
        # gray-failure state (core.fault): per-worker slow-down multipliers
        # + the batching data plane's dead-member release hook
        self._slow: Dict[int, float] = {}
        self.backend_drop: Optional[Callable[[List[int]], None]] = None
        self.n_cold_starts = 0
        self.n_warm_hits = 0
        self.queuing_delays: List[float] = []
        self.queuing_delay_times: List[float] = []   # dispatch timestamps
        self.completed_requests: List[Request] = []
        # flat-metrics completion hook (see SemiGlobalScheduler.on_complete)
        self.on_complete: Optional[Callable[[Request, float], None]] = None

    # -- intake ---------------------------------------------------------------
    def submit_request(self, req: Request) -> None:
        now = self.env.now()
        self._completed_fns[req.req_id] = set()
        for root in req.dag.roots():
            self._queue.append(Invocation(request=req, fn=req.dag.fn(root),
                                          ready_time=now))
        self._dispatch()

    # -- dispatch ---------------------------------------------------------------
    def _dispatch(self) -> None:
        now = self.env.now()
        while self._queue:
            inv = self._queue[0]
            w, sbx = self._choose_worker(inv, now)
            if w is None:
                return          # head-of-line blocking: strict FIFO
            self._queue.popleft()
            self._start(inv, w, sbx, now)

    def _choose_worker(self, inv: Invocation, now: float
                       ) -> Tuple[Optional[Worker], Optional[Sandbox]]:
        cold: Optional[Worker] = None
        for w in self.workers:
            if w.free_cores <= 0:
                continue
            s = w.warm_available(inv.fn.name, now)
            if s is not None:
                return w, s
            if cold is None:
                cold = w
        return cold, None

    def _start(self, inv: Invocation, w: Worker, sbx: Optional[Sandbox],
               now: float) -> None:
        inv.start_time = now
        qd = now - inv.ready_time
        self.queuing_delays.append(qd)
        self.queuing_delay_times.append(now)
        inv.request.total_queuing_delay += qd
        w.busy_cores += 1
        setup = 0.0
        if sbx is None:
            inv.cold_start = True
            inv.request.n_cold_starts += 1
            self.n_cold_starts += 1
            setup = inv.fn.setup_time
            self._make_room(w, inv.fn.mem_mb, now)
            sbx = Sandbox(fn=inv.fn, worker_id=w.worker_id,
                          state=SandboxState.BUSY,
                          ready_at=now + setup, last_used=now)
            w.add_sandbox(sbx)
        else:
            self.n_warm_hits += 1
            sbx.state = SandboxState.BUSY
            sbx.last_used = now
        inflight = self._inflight.get(w.worker_id)
        if inflight is None:
            inflight = self._inflight[w.worker_id] = {}
        inflight[inv.inv_id] = inv
        slow = self._slow
        m = slow.get(w.worker_id) if slow else None
        if self.backend_submit is not None:
            # async seam: dispatch returns immediately; the backend fires
            # the completion callback (possibly after batching)
            def done(exec_s: float, inv=inv, w=w, sbx=sbx) -> None:
                self._complete(inv, w, sbx)
            self.backend_submit(inv, done if m is None
                                else _slowed_done(self.env, done, m), setup)
            return
        exec_s = inv.fn.exec_time if self.execute is None \
            else self.execute(inv)
        if m is not None:
            exec_s *= m
        self.env.call_after(setup + exec_s, self._complete, inv, w, sbx)

    def _make_room(self, w: Worker, mem_mb: float, now: float) -> None:
        """Keep-alive expiry first, then oldest-idle eviction if still full."""
        for s in w.sandboxes:
            if (s.state == SandboxState.WARM
                    and now - s.last_used > self.keepalive):
                w.remove_sandbox(s)
        while w.free_pool_mem < mem_mb:
            idle = [s for s in w.sandboxes if s.state == SandboxState.WARM]
            if not idle:
                return
            w.remove_sandbox(min(idle, key=lambda s: s.last_used))

    def _complete(self, inv: Invocation, w: Worker, sbx: Sandbox) -> None:
        # inflight-generation guard (see SemiGlobalScheduler._complete):
        # drops stale completions from dead workers / retried invocations
        inflight = self._inflight.get(w.worker_id)
        if inflight is None or inflight.pop(inv.inv_id, None) is None:
            return      # fail-stop: execution lost, the retry re-drives it
        now = self.env.now()
        w.busy_cores -= 1
        sbx.state = SandboxState.WARM
        sbx.ready_at = min(sbx.ready_at, now)
        sbx.last_used = now
        req = inv.request
        done = self._completed_fns[req.req_id]
        done.add(inv.fn.name)
        dag = req.dag
        if len(done) == len(dag.functions):
            req.completion_time = now
            rec = self.on_complete
            if rec is not None:
                rec(req, now)
            else:
                self.completed_requests.append(req)
            del self._completed_fns[req.req_id]
        else:
            for child in dag.children(inv.fn.name):
                if all(p in done for p in dag.parents(child)):
                    self._queue.append(Invocation(request=req,
                                                  fn=dag.fn(child),
                                                  ready_time=now))
        self._dispatch()


class SparrowScheduler:
    """Batch-sampling/power-of-two-choices decentralized scheduler [41].

    Each invocation probes ``probes`` random workers and joins the shortest
    per-worker FIFO queue.  Workers run their queues in order; sandbox reuse
    happens only by accident of placement (no sandbox awareness).
    """

    def __init__(self, workers: List[Worker], env: Env, probes: int = 2,
                 seed: int = 0, keepalive: float = 900.0,
                 execute: Optional[ExecuteFn] = None,
                 backend_submit: Optional[SubmitFn] = None):
        self.workers = workers
        self.env = env
        self.probes = probes
        self.keepalive = keepalive
        # async execution seam (core.backends); `execute` is the legacy
        # synchronous hook
        self.backend_submit = backend_submit
        self.execute = execute
        self._rng = random.Random(seed)
        self._wqueues: Dict[int, Deque[Invocation]] = {
            w.worker_id: deque() for w in workers}
        self._completed_fns: Dict[int, set] = {}
        # fault tolerance: see CentralizedFIFO (same registration shape)
        self._inflight: Dict[int, Dict[int, Invocation]] = {}
        self._dead_workers: set = set()
        self._slow: Dict[int, float] = {}
        self.backend_drop: Optional[Callable[[List[int]], None]] = None
        self.n_cold_starts = 0
        self.n_warm_hits = 0
        self.queuing_delays: List[float] = []
        self.queuing_delay_times: List[float] = []   # dispatch timestamps
        self.completed_requests: List[Request] = []
        # flat-metrics completion hook (see SemiGlobalScheduler.on_complete)
        self.on_complete: Optional[Callable[[Request, float], None]] = None

    def submit_request(self, req: Request) -> None:
        now = self.env.now()
        self._completed_fns[req.req_id] = set()
        for root in req.dag.roots():
            self._place(Invocation(request=req, fn=req.dag.fn(root),
                                   ready_time=now))

    def _place(self, inv: Invocation) -> None:
        cands = self._rng.sample(self.workers,
                                 min(self.probes, len(self.workers)))
        w = min(cands, key=lambda w: len(self._wqueues[w.worker_id])
                + w.busy_cores)
        self._wqueues[w.worker_id].append(inv)
        self._drain(w)

    def _drain(self, w: Worker) -> None:
        now = self.env.now()
        q = self._wqueues[w.worker_id]
        while q and w.free_cores > 0:
            inv = q.popleft()
            inv.start_time = now
            qd = now - inv.ready_time
            self.queuing_delays.append(qd)
            self.queuing_delay_times.append(now)
            inv.request.total_queuing_delay += qd
            w.busy_cores += 1
            sbx = w.warm_available(inv.fn.name, now)
            setup = 0.0
            if sbx is None:
                inv.cold_start = True
                inv.request.n_cold_starts += 1
                self.n_cold_starts += 1
                setup = inv.fn.setup_time
                sbx = Sandbox(fn=inv.fn, worker_id=w.worker_id,
                              state=SandboxState.BUSY,
                              ready_at=now + setup, last_used=now)
                w.add_sandbox(sbx)
            else:
                self.n_warm_hits += 1
                sbx.state = SandboxState.BUSY
            inflight = self._inflight.get(w.worker_id)
            if inflight is None:
                inflight = self._inflight[w.worker_id] = {}
            inflight[inv.inv_id] = inv
            slow = self._slow
            m = slow.get(w.worker_id) if slow else None
            if self.backend_submit is not None:
                def done(exec_s: float, inv=inv, w=w, sbx=sbx) -> None:
                    self._complete(inv, w, sbx)
                self.backend_submit(inv, done if m is None
                                    else _slowed_done(self.env, done, m),
                                    setup)
                continue
            exec_s = inv.fn.exec_time if self.execute is None \
                else self.execute(inv)
            if m is not None:
                exec_s *= m
            self.env.call_after(setup + exec_s, self._complete, inv, w, sbx)

    def _complete(self, inv: Invocation, w: Worker, sbx: Sandbox) -> None:
        # inflight-generation guard (see SemiGlobalScheduler._complete)
        inflight = self._inflight.get(w.worker_id)
        if inflight is None or inflight.pop(inv.inv_id, None) is None:
            return      # fail-stop: execution lost, the retry re-drives it
        now = self.env.now()
        w.busy_cores -= 1
        sbx.state = SandboxState.WARM
        sbx.ready_at = min(sbx.ready_at, now)
        sbx.last_used = now
        req = inv.request
        done = self._completed_fns[req.req_id]
        done.add(inv.fn.name)
        dag = req.dag
        if len(done) == len(dag.functions):
            req.completion_time = now
            rec = self.on_complete
            if rec is not None:
                rec(req, now)
            else:
                self.completed_requests.append(req)
            del self._completed_fns[req.req_id]
        else:
            for child in dag.children(inv.fn.name):
                if all(p in done for p in dag.parents(child)):
                    self._place(Invocation(request=req, fn=dag.fn(child),
                                           ready_time=now))
        self._drain(w)
