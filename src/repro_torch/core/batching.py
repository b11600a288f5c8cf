"""Continuous batching on top of the asynchronous execution seam.

Copy of ``CompletionQueue``, ``ContinuousBatcher`` and ``pow2_bucket`` from
``src/repro/core/backends.py:220-255, 377-560`` (the port imports nothing of
``repro``).  The batcher decides when requests join and leave a running
batch; the data plane (``serving.executor.ContinuousTorchExecutor``)
supplies the ``admit`` / ``step`` / ``steps_for`` hooks.
"""
from __future__ import annotations

import heapq
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

from .types import DoneFn, Invocation

if TYPE_CHECKING:   # pragma: no cover - typing only
    from ..sim.engine import SimEnv as Env


class CompletionQueue:
    """Deterministically ordered completion delivery for a data plane.

    ``schedule(inv, exec_s, done, delay)`` arranges for ``done(exec_s)`` to
    fire at ``env.now() + delay + exec_s``.  Completions due at the same sim
    instant fire in ``inv_id`` order regardless of scheduling order — the
    event heap alone would use insertion order, which for a batched backend
    depends on flush timing.  This is what keeps stub/batched runs exactly
    reproducible.
    """

    def __init__(self, env: "Env"):
        self.env = env
        # (fire_time, inv_id, exec_s, done)
        self._heap: List[Tuple[float, int, float, DoneFn]] = []

    def schedule(self, inv: Invocation, exec_s: float, done: DoneFn,
                 delay: float = 0.0) -> None:
        lag = delay + exec_s
        heapq.heappush(self._heap,
                       (self.env.now() + lag, inv.inv_id, exec_s, done))
        self.env.call_after(lag, self._fire)

    def _fire(self) -> None:
        # one flush event per schedule(); each drains everything due at its
        # fire instant in (time, inv_id) order, so later flushes at the same
        # timestamp find the heap already empty.  Entry times and event times
        # come from the identical float expression (now + lag), so exact
        # comparison is safe — no epsilon that could deliver a completion at
        # an infinitesimally earlier instant.
        now = self.env.now()
        h = self._heap
        while h and h[0][0] <= now:
            _, _, exec_s, done = heapq.heappop(h)
            done(exec_s)



class ContinuousBatcher:
    """Step-granular *continuous* batching on top of the async seam.

    Where :class:`BatchCoalescer` gathers whole requests into one padded
    execution (every member runs prefill AND all decode steps together),
    this batcher decomposes a decode-style request into *token steps*:
    in-flight invocations of the same function join and leave a running
    batch at step boundaries.  A new arrival never waits for the current
    generation to finish — it is admitted at the next tick (one batched
    prefill), decodes alongside the residents, and completes as soon as its
    own ``steps_for(fn)`` decode steps have elapsed.  This is the vLLM-style
    iteration-level scheduling discipline, driving the GPU/TPU at decode
    batch occupancy instead of request-window occupancy.

    The data plane supplies three hooks (see
    ``serving.executor.ContinuousTorchExecutor`` for the real twin; the JAX
    package's ``StubBatchedBackend(batching="continuous")`` is the scripted one):

    * ``admit(fn_name, invs, slots) -> seconds`` — batched prefill of the
      joiners into cache slots ``slots``; returns measured wall seconds.
    * ``step(fn_name, slots) -> seconds`` — ONE decode step for every
      active slot; returns measured wall seconds.
    * ``steps_for(fn_name) -> int`` — decode steps a request owes after its
      admitting prefill (the prefill itself yields the first token).

    Determinism: pending joiners are admitted in ``inv_id`` order into the
    lowest free slots; same-instant submissions all join the same first
    tick (the tick is deferred to the end of the current instant); members
    finishing on the same tick complete in ``inv_id`` order via
    :class:`CompletionQueue`.  A cold invocation (``delay`` = sandbox
    setup) enrolls only once its setup has elapsed.
    """

    def __init__(self, env: "Env",
                 admit: Callable[[str, List[Invocation], List[int]], float],
                 step: Callable[[str, List[int]], float],
                 steps_for: Callable[[str], int],
                 max_batch: int = 8,
                 release: Optional[Callable[[str, List[int]], None]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.env = env
        self.admit = admit
        self.step = step
        self.steps_for = steps_for
        self.max_batch = max_batch
        # optional slot-release hook: called with the cache slots of dropped
        # members so the real executor can scrub its slab (serving.executor
        # ContinuousTorchExecutor.release_slots)
        self.release = release
        self._cq = CompletionQueue(env)
        self._pending: Dict[str, List[Tuple[Invocation, DoneFn]]] = {}
        # slot -> [inv, done, steps_left, join_time]
        self._active: Dict[str, Dict[int, list]] = {}
        self._free: Dict[str, List[int]] = {}       # min-heap of free slots
        self._running: Dict[str, bool] = {}
        # dead-member tombstones (core.fault worker crash): inv_ids dropped
        # while still in their setup-delay deferral; consumed by _enroll
        self._dropped: set = set()
        # occupancy counters (surfaced through backend.counters())
        self.n_prefill_batches = 0
        self.n_joins = 0
        self.n_ticks = 0
        self.n_step_slots = 0           # sum of active sizes over all ticks
        self.max_occupancy = 0
        self.n_dropped = 0

    def submit(self, inv: Invocation, done: DoneFn, delay: float = 0.0
               ) -> None:
        if delay > 0.0:
            self.env.call_after(delay, self._enroll, inv, done)
        else:
            self._enroll(inv, done)

    def drop(self, inv_ids: List[int]) -> None:
        """Purge dead members (their worker crashed) from the data plane.

        Pending joiners are removed before their admitting prefill; active
        residents leave the running batch at the next step boundary — their
        slot is freed immediately (and scrubbed via the ``release`` hook),
        so the tick that follows steps only live members and new joiners are
        admitted into the vacated slots.  Members in their setup deferral
        are tombstoned and skipped at enrollment.  Counters stay coherent:
        a dropped resident was already counted as a join, never as a
        completion, and subsequent ticks no longer count its slot.
        """
        ids = set(inv_ids)
        if not ids:
            return
        for fn, q in self._pending.items():
            if any(inv.inv_id in ids for inv, _ in q):
                kept = [(inv, d) for inv, d in q if inv.inv_id not in ids]
                self.n_dropped += len(q) - len(kept)
                ids -= {inv.inv_id for inv, _ in q}
                self._pending[fn] = kept
        for fn, active in self._active.items():
            hit = sorted(s for s, e in active.items() if e[0].inv_id in ids)
            if not hit:
                continue
            free = self._free[fn]
            for s in hit:
                entry = active.pop(s)
                ids.discard(entry[0].inv_id)
                heapq.heappush(free, s)
            self.n_dropped += len(hit)
            if self.release is not None:
                self.release(fn, hit)
        # remainder: in setup deferral (tombstone; consumed by _enroll) or
        # already completed (stale id, at most one int leaked per crash)
        self._dropped |= ids

    def _enroll(self, inv: Invocation, done: DoneFn) -> None:
        if inv.inv_id in self._dropped:
            self._dropped.discard(inv.inv_id)
            self.n_dropped += 1
            return
        fn = inv.fn.name
        self._pending.setdefault(fn, []).append((inv, done))
        if not self._running.get(fn, False):
            self._running[fn] = True
            # defer the first tick to the end of the current instant so
            # every same-instant submission joins the same prefill batch
            self.env.call_after(0.0, self._tick, fn)

    def _tick(self, fn: str) -> None:
        now = self.env.now()
        pending = self._pending.setdefault(fn, [])
        active = self._active.setdefault(fn, {})
        free = self._free.setdefault(fn, list(range(self.max_batch)))
        dur = 0.0
        if pending and free:
            pending.sort(key=lambda p: p[0].inv_id)
            k = min(len(pending), len(free))
            joiners, self._pending[fn] = pending[:k], pending[k:]
            slots = sorted(heapq.heappop(free) for _ in range(k))
            dur += self.admit(fn, [inv for inv, _ in joiners], slots)
            self.n_prefill_batches += 1
            self.n_joins += k
            steps = self.steps_for(fn)
            for (inv, done), s in zip(joiners, slots):
                active[s] = [inv, done, steps, now]
            if steps <= 0:
                # degenerate prefill-only functions: done at admission,
                # before (and without) any decode step
                self._finish(fn, now, dur)
        if active:
            slots = sorted(active)
            dur += self.step(fn, slots)
            self.n_ticks += 1
            self.n_step_slots += len(slots)
            if len(slots) > self.max_occupancy:
                self.max_occupancy = len(slots)
            for s in slots:
                active[s][2] -= 1
        self._finish(fn, now, dur)
        if self._active[fn] or self._pending.get(fn):
            self.env.call_after(dur, self._tick, fn)
        else:
            self._running[fn] = False

    def _finish(self, fn: str, now: float, dur: float) -> None:
        """Complete every active member that owes no further steps, at
        ``now + dur``; ``exec_s`` reports the member's total residency
        (its own prefill through its last decode step)."""
        active, free = self._active[fn], self._free[fn]
        for s in [s for s, e in active.items() if e[2] <= 0]:
            inv, done, _, join_t = active.pop(s)
            heapq.heappush(free, s)
            total = now + dur - join_t
            self._cq.schedule(inv, total, done, delay=dur - total)

    def counters(self) -> Dict[str, int]:
        return {"n_prefill_batches": self.n_prefill_batches,
                "n_joins": self.n_joins,
                "n_decode_ticks": self.n_ticks,
                "n_step_slots": self.n_step_slots,
                "max_batch_occupancy": self.max_occupancy,
                "n_dropped_invocations": self.n_dropped}



def pow2_bucket(k: int) -> int:
    """Smallest power of two >= k (the padded batch size a batch of ``k``
    executes at)."""
    return 1 << (k - 1).bit_length() if k > 1 else 1

