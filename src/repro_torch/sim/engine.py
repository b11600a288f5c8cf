"""Minimal deterministic discrete-event engine implementing ``core.sgs.Env``.

Copy of ``src/repro/sim/engine.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Tuple


class SimEnv:
    """Heap-based event loop.  Deterministic: ties broken by insertion order."""

    def __init__(self):
        self._now = 0.0
        self._seq = itertools.count()
        self._seq_next = self._seq.__next__
        self._events: List[Tuple[float, int, Callable[[], None]]] = []
        self.n_events = 0

    # -- core.sgs.Env interface ------------------------------------------------
    def now(self) -> float:
        return self._now

    def call_after(self, delay: float, fn: Callable[..., None],
                   *args) -> None:
        """Defer ``fn(*args)``; passing args directly (rather than closing
        over them) avoids a closure allocation per scheduled event on the
        simulation hot path.  The push is hand-inlined (this is the single
        most-called scheduling entry point): ``t >= now`` holds by
        construction, so ``call_at``'s past-check is unnecessary."""
        now = self._now
        t = now + delay
        if t < now:                 # negative delay clamps to "immediately"
            t = now
        heapq.heappush(self._events, (t, self._seq_next(), fn, args))

    def call_at(self, t: float, fn: Callable[..., None], *args) -> None:
        if t < self._now - 1e-12:
            raise ValueError(f"cannot schedule in the past: {t} < {self._now}")
        heapq.heappush(self._events, (t, self._seq_next(), fn, args))

    # -- driving -----------------------------------------------------------------
    def run_until(self, t_end: float) -> None:
        events = self._events
        pop = heapq.heappop
        n = 0
        try:
            while events and events[0][0] <= t_end:
                t, _, fn, args = pop(events)
                self._now = t
                n += 1
                fn(*args)
        finally:
            self.n_events += n
        self._now = max(self._now, t_end)

    def run_until_before(self, t_end: float) -> None:
        """Like :meth:`run_until` but with an *exclusive* bound: processes
        every event with ``t < t_end`` (strictly), then advances the clock to
        ``t_end``.  The sharded core (``repro_torch.sim.shard``) uses this for
        lookahead barriers placed exactly on a potential event time — the
        event at ``t_end`` must run in the *next* epoch, after cross-shard
        state for ``t_end`` has been exchanged."""
        events = self._events
        pop = heapq.heappop
        n = 0
        try:
            while events and events[0][0] < t_end:
                t, _, fn, args = pop(events)
                self._now = t
                n += 1
                fn(*args)
        finally:
            self.n_events += n
        self._now = max(self._now, t_end)

    def run(self) -> None:
        events = self._events
        pop = heapq.heappop
        n = 0
        try:
            while events:
                t, _, fn, args = pop(events)
                self._now = t
                n += 1
                fn(*args)
        finally:
            self.n_events += n

    def every(self, interval: float, fn: Callable[[], None],
              until: float = float("inf")) -> None:
        """Recurring callback helper (estimation ticks, scaling passes)."""

        def tick():
            if self._now > until:
                return
            fn()
            self.call_after(interval, tick)

        self.call_after(interval, tick)
