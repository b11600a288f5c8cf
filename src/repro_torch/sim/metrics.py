"""Evaluation metrics (§7.1): E2E latency, % deadlines met, queuing delay,
cold starts.

Two recording modes share one ``Metrics`` interface:

* **Object mode** (the legacy layout, used by tests and ad-hoc analysis):
  ``Metrics(requests=[...])`` holds live ``Request`` objects and every
  statistic is computed by scanning them.  Constructing a ``Metrics``
  directly — or appending to ``.requests`` — keeps exactly the historical
  semantics, including visibility of post-append mutations.

* **Flat column mode** (what ``simulate`` uses): the arrival columns
  (times + per-arrival tenant index) are attached wholesale from the
  vectorized workload generator *before* the run, and schedulers record
  completions through ``record_completion`` into append-only parallel
  buffers (completion time, cold starts, SGS id, total queuing delay).
  No per-``Request`` object is retained after its completion — at
  million-request scale this is the difference between O(n) Python object
  churn per report and a handful of numpy passes.  ``after_warmup`` is a
  zero-copy view (an index cutoff into the time-sorted arrival column plus
  a timestamp threshold for queuing samples); ``summarize``/``latency_pct``/
  ``deadline_met_frac``/``cold_start_frac``/``by_class`` are vectorized.
  The ``requests`` property stays available as a *compatibility view* that
  materializes equivalent ``Request`` objects on demand (bit-identical
  float fields), so existing figures and tests keep working unchanged.

  Flat-mode views describe the whole attached arrival trace: they are
  meant to be read after the run (that is when ``simulate`` reads them).
  A mid-run hook that must observe partial state should consult the
  scheduler objects (queue lengths, counters) rather than the metrics
  plane — in legacy object mode the request list grows with the pump, in
  flat mode future arrivals already occupy (incomplete) rows.

Copy of ``src/repro/sim/metrics.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.types import DagSpec, Request


def percentile(xs: Sequence[float], p: float) -> float:
    """Nearest-rank percentile; p in [0,100]."""
    if len(xs) == 0:
        return float("nan")
    return _pct_sorted(sorted(xs), p)


def _pct_sorted(s: Sequence[float], p: float) -> float:
    """Nearest-rank percentile over an already-sorted sequence."""
    n = len(s)
    if n == 0:
        return float("nan")
    k = max(0, min(n - 1, int(round(p / 100.0 * (n - 1)))))
    return s[k]


def _dag_class(dag_id: str) -> str:
    return dag_id.split("-")[0]


class _FlatColumns:
    """One run's append-only column store (shared by every view of it).

    Arrival-side columns are attached once, in arrival-time order, straight
    from ``WorkloadSpec.generate_arrays`` — the pump never touches them.
    Completion-side records are one appended tuple per completed request
    (cheaper than per-scalar numpy stores on the hot path) and are
    transposed to numpy lazily, cached per completion count.
    ``pending`` maps row index -> live ``Request`` for the (few) requests
    in flight, so views over incomplete requests stay exact.
    """

    __slots__ = ("n", "arrival", "dag_idx", "dags", "dag_deadline",
                 "dag_n_fns", "dag_class_id", "class_names", "pending",
                 "comp", "_fin", "_mat")

    def __init__(self, arrival: np.ndarray, dag_idx: np.ndarray,
                 dags: List[DagSpec]):
        self.n = len(arrival)
        self.arrival = np.ascontiguousarray(arrival, dtype=np.float64)
        self.dag_idx = np.ascontiguousarray(dag_idx, dtype=np.int64)
        self.dags = list(dags)
        self.dag_deadline = np.array([d.deadline for d in self.dags],
                                     dtype=np.float64)
        self.dag_n_fns = np.array([len(d.functions) for d in self.dags],
                                  dtype=np.int64)
        names: List[str] = []
        ids: List[int] = []
        seen: Dict[str, int] = {}
        for d in self.dags:
            cls = _dag_class(d.dag_id)
            cid = seen.setdefault(cls, len(seen))
            if cid == len(names):
                names.append(cls)
            ids.append(cid)
        self.class_names = names
        self.dag_class_id = np.array(ids, dtype=np.int64) \
            if ids else np.empty(0, dtype=np.int64)
        self.pending: Dict[int, Request] = {}
        # (row idx, completion time, cold starts, sgs id, total queuing
        # delay) per completed request, in completion order
        self.comp: List[Tuple[int, float, int, int, float]] = []
        self._fin: Optional[Tuple[int, Tuple[np.ndarray, ...]]] = None
        self._mat: Optional[Tuple[int, List[Request]]] = None

    # -- recording (hot path) ------------------------------------------------
    def record_completion(self, req: Request, now: float) -> None:
        i = req.m_idx
        sid = req.sgs_id
        self.comp.append((i, now, req.n_cold_starts,
                          -1 if sid is None else sid,
                          req.total_queuing_delay))
        self.pending.pop(i, None)

    # -- lazily finalized numpy views ---------------------------------------
    def finalized(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
        """(comp_idx, comp_time, comp_cold, comp_sgs, comp_qd) as arrays,
        rebuilt only when more completions were recorded since last use."""
        n_comp = len(self.comp)
        if self._fin is None or self._fin[0] != n_comp:
            if n_comp:
                ci, ct, cc, cs, cq = zip(*self.comp)
            else:
                ci = ct = cc = cs = cq = ()
            self._fin = (n_comp, (
                np.asarray(ci, dtype=np.int64),
                np.asarray(ct, dtype=np.float64),
                np.asarray(cc, dtype=np.int64),
                np.asarray(cs, dtype=np.int64),
                np.asarray(cq, dtype=np.float64)))
        return self._fin[1]

    def materialize(self) -> List[Request]:
        """Compatibility view: equivalent ``Request`` objects in arrival
        order — live objects for in-flight requests, reconstructed ones
        (bit-identical float fields) for completed rows.

        The view covers the whole attached arrival trace: read it after the
        run (or a drain point), not from mid-run hooks — rows whose arrival
        has not fired yet materialize as not-yet-completed requests.  The
        cache key includes the pending count so a post-run view is rebuilt
        whenever arrivals or completions advanced."""
        key = (len(self.comp), len(self.pending))
        if self._mat is not None and self._mat[0] == key:
            return self._mat[1]
        comp_t = np.full(self.n, np.nan)
        comp_cold = np.zeros(self.n, dtype=np.int64)
        comp_sgs = np.full(self.n, -2, dtype=np.int64)
        comp_qd = np.zeros(self.n, dtype=np.float64)
        ci, ct, cc, cs, cq = self.finalized()
        comp_t[ci] = ct
        comp_cold[ci] = cc
        comp_sgs[ci] = cs
        comp_qd[ci] = cq
        arrival = self.arrival.tolist()
        dag_of = self.dag_idx.tolist()
        ct_l = comp_t.tolist()
        cc_l = comp_cold.tolist()
        cs_l = comp_sgs.tolist()
        cq_l = comp_qd.tolist()
        pending = self.pending
        dags = self.dags
        out: List[Request] = []
        for i in range(self.n):
            r = pending.get(i)
            if r is None:
                r = Request(dag=dags[dag_of[i]], arrival_time=arrival[i])
                r.m_idx = i
                t = ct_l[i]
                if t == t:                      # not NaN -> completed
                    r.completion_time = t
                    r.n_cold_starts = cc_l[i]
                    sid = cs_l[i]
                    r.sgs_id = None if sid < 0 else sid
                    r.total_queuing_delay = cq_l[i]
            out.append(r)
        self._mat = (key, out)
        return out


class _CompLen:
    """Stands in for ``_FlatColumns.comp`` after a sharded merge: every
    consumer keys on ``len(comp)`` (cache invalidation) and reads rows only
    through ``finalized()``, so a merged run carries just the count — the
    actual columns are installed directly as the finalized arrays, skipping
    a pointless n-tuple Python list at 10M-request scale."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def append(self, row) -> None:  # pragma: no cover - guards misuse
        raise RuntimeError(
            "cannot record into a sharded-merged Metrics (completions were "
            "absorbed as finalized columns)")


class Metrics:
    """Unified metrics container — see the module docstring for the two
    recording modes.  The constructor signature (``requests``,
    ``queuing_delays``, ``queuing_delay_times``) is the historical object
    mode; ``Metrics.flat(...)`` builds the column-recording mode."""

    __slots__ = ("_requests", "_qd", "_qt", "_lat_cache", "_cols", "_lo",
                 "_hi", "_warm_t", "_qt_hi", "_cls", "_qchunks", "_qcache",
                 "_comp_cache")

    def __init__(self, requests: Optional[List[Request]] = None,
                 queuing_delays: Optional[List[float]] = None,
                 queuing_delay_times: Optional[List[float]] = None):
        self._requests = requests if requests is not None else []
        self._qd = queuing_delays if queuing_delays is not None else []
        self._qt = (queuing_delay_times if queuing_delay_times is not None
                    else [])
        # sorted-latency cache (object mode): keyed on
        # (n_requests, n_completed) — requests are append-only and a
        # completion_time is written exactly once, so any change to the
        # latency set moves one of the two counts.
        self._lat_cache: Optional[Tuple[Tuple[int, int], List[float]]] = None
        self._cols: Optional[_FlatColumns] = None
        self._lo = 0                    # arrival-row cutoff (warmup views)
        self._hi: Optional[int] = None  # arrival-row upper cutoff (windows)
        self._warm_t = 0.0              # queuing-sample timestamp cutoff
        self._qt_hi = float("inf")      # queuing-sample upper timestamp
        self._cls: Optional[int] = None  # class-id restriction (by_class)
        self._qchunks: List[Tuple[Sequence[float], Sequence[float]]] = []
        self._qcache = None             # (n_chunks, delays, times)
        self._comp_cache = None         # (n_comp, completion-window arrays)

    # ------------------------------------------------------------------ flat
    @classmethod
    def flat(cls, arrival: np.ndarray, dag_idx: np.ndarray,
             dags: List[DagSpec]) -> "Metrics":
        """Column-recording mode for one run: arrival columns attached
        wholesale; completions recorded via :meth:`record_completion`."""
        m = cls()
        m._cols = _FlatColumns(arrival, dag_idx, dags)
        return m

    def _view(self, lo: int, warm_t: float, cls_id: Optional[int],
              hi: Optional[int] = None,
              qt_hi: float = float("inf")) -> "Metrics":
        v = Metrics()
        v._cols = self._cols
        v._lo = lo
        v._hi = hi
        v._warm_t = warm_t
        v._qt_hi = qt_hi
        v._cls = cls_id
        v._qchunks = self._qchunks
        return v

    @property
    def is_flat(self) -> bool:
        return self._cols is not None

    def record_completion(self, req: Request, now: float) -> None:
        """Hot-path completion hook (flat mode): fold the request's final
        accounting into the column buffers and release the object."""
        self._cols.record_completion(req, now)

    def completion_recorder(self) -> Callable[[Request, float], None]:
        """The fastest bound completion hook for schedulers to call — the
        column store's own method in flat mode (one call frame fewer than
        going through :meth:`record_completion`)."""
        if self._cols is not None:
            return self._cols.record_completion
        return self.record_completion

    def absorb_sharded(self, comp_idx: np.ndarray, comp_time: np.ndarray,
                       comp_cold: np.ndarray, comp_sgs: np.ndarray,
                       comp_qd: np.ndarray,
                       pending: Dict[int, Request]) -> None:
        """Install a sharded run's merged completion columns (flat mode
        only — the JAX package's ``sim/shard.py`` coordinator).  The five arrays are the
        exact shape ``_FlatColumns.finalized()`` would build from per-tuple
        recording (row idx, completion time, cold starts, SGS id, total
        queuing delay); order across rows is irrelevant to every statistic
        (percentiles sort, the rest are sums/masks/scatters by row index).
        ``pending`` holds reconstructed stand-ins for requests still in
        flight at the horizon, exactly like the live objects the sequential
        pump would have left behind."""
        c = self._cols
        if c is None:
            raise RuntimeError("absorb_sharded requires flat-column mode")
        n = len(comp_idx)
        c._fin = (n, (comp_idx, comp_time, comp_cold, comp_sgs, comp_qd))
        c.comp = _CompLen(n)
        c.pending = pending

    def add_queuing_samples(self, delays: Sequence[float],
                            times: Sequence[float]) -> None:
        """Fold one scheduler's queuing-delay samples into this run's
        metrics (called by ``Stack.collect``).  Chunks are kept by
        reference and concatenated lazily in flat mode."""
        if self._cols is not None:
            self._qchunks.append((delays, times))
            self._qcache = None
        else:
            self._qd.extend(delays)
            self._qt.extend(times)

    # -- flat internals ------------------------------------------------------
    def _q_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(delays, times) filtered to this view's warmup window."""
        key = len(self._qchunks)
        if self._qcache is None or self._qcache[0] != key:
            if self._qchunks:
                d = np.concatenate([np.asarray(c[0], dtype=np.float64)
                                    for c in self._qchunks])
                t = np.concatenate([np.asarray(c[1], dtype=np.float64)
                                    for c in self._qchunks])
            else:
                d = np.empty(0)
                t = np.empty(0)
            if self._warm_t > 0.0 or self._qt_hi != float("inf"):
                keep = (t >= self._warm_t) & (t < self._qt_hi)
                d = d[keep]
                t = t[keep]
            self._qcache = (key, d, t)
        return self._qcache[1], self._qcache[2]

    def _comp_window(self) -> Tuple[np.ndarray, ...]:
        """Completion columns restricted to this view (warmup cutoff and
        optional class restriction), cached per completion count."""
        c = self._cols
        key = len(c.comp)
        if self._comp_cache is None or self._comp_cache[0] != key:
            ci, ct, cc, cs, cq = c.finalized()
            if self._lo > 0 or self._hi is not None:
                keep = ci >= self._lo
                if self._hi is not None:
                    keep &= ci < self._hi
                ci, ct, cc, cs, cq = (ci[keep], ct[keep], cc[keep],
                                      cs[keep], cq[keep])
            if self._cls is not None:
                keep = c.dag_class_id[c.dag_idx[ci]] == self._cls
                ci, ct, cc, cs, cq = (ci[keep], ct[keep], cc[keep],
                                      cs[keep], cq[keep])
            self._comp_cache = (key, ci, ct, cc, cs, cq)
        return self._comp_cache[1:]

    def _n_rows(self) -> int:
        """Requests in this view's window (flat mode)."""
        c = self._cols
        hi = c.n if self._hi is None else min(self._hi, c.n)
        if self._cls is None:
            return max(0, hi - self._lo)
        if hi <= self._lo:
            return 0
        return int((c.dag_class_id[c.dag_idx[self._lo:hi]]
                    == self._cls).sum())

    def _pending_in_window(self) -> List[Request]:
        c = self._cols
        lo, cid = self._lo, self._cls
        hi = c.n if self._hi is None else self._hi
        out = []
        for i, r in c.pending.items():
            if lo <= i < hi and (cid is None
                                 or c.dag_class_id[c.dag_idx[i]] == cid):
                out.append(r)
        return out

    # ------------------------------------------------------------ properties
    @property
    def requests(self) -> List[Request]:
        """The per-request view.  Object mode: the live backing list
        (mutable, appendable).  Flat mode: a materialized compatibility
        list in arrival order — read-only by construction (appending to it
        does not record)."""
        if self._cols is None:
            return self._requests
        reqs = self._cols.materialize()
        if self._lo > 0 or self._hi is not None:
            reqs = reqs[self._lo:self._hi]
        if self._cls is not None:
            c = self._cols
            cid_of = c.dag_class_id[c.dag_idx[self._lo:self._hi]].tolist()
            reqs = [r for r, k in zip(reqs, cid_of) if k == self._cls]
        return reqs

    @property
    def queuing_delays(self) -> Sequence[float]:
        if self._cols is None:
            return self._qd
        return self._q_arrays()[0]

    @property
    def queuing_delay_times(self) -> Sequence[float]:
        if self._cols is None:
            return self._qt
        return self._q_arrays()[1]

    @property
    def completed(self) -> List[Request]:
        if self._cols is None:
            return [r for r in self._requests
                    if r.completion_time is not None]
        return [r for r in self.requests if r.completion_time is not None]

    @property
    def n_requests(self) -> int:
        """Request count in this view — O(1)-ish in flat mode (no object
        materialization)."""
        if self._cols is None:
            return len(self._requests)
        return self._n_rows()

    @property
    def n_completed(self) -> int:
        """Completed-request count, maintained incrementally in flat mode
        (the historical ``len(m.completed)`` rebuilt a list per access)."""
        if self._cols is None:
            return sum(1 for r in self._requests
                       if r.completion_time is not None)
        return len(self._comp_window()[0])

    # ------------------------------------------------------------- statistics
    def sorted_latencies(self) -> Sequence[float]:
        """E2E latencies of completed requests, ascending — one sort per
        (requests, completions) state, cached across percentile calls."""
        if self._cols is not None:
            ci, ct = self._comp_window()[:2]
            lat = ct - self._cols.arrival[ci]
            lat.sort()
            return lat
        done = self.completed
        key = (len(self._requests), len(done))
        if self._lat_cache is None or self._lat_cache[0] != key:
            self._lat_cache = (key, sorted(r.e2e_latency for r in done))
        return self._lat_cache[1]

    def after_warmup(self, warmup: float) -> "Metrics":
        """Steady-state view: only requests arriving after ``warmup`` count
        (excludes the cold-cluster transient, as any fixed-duration testbed
        run longer than the transient effectively does).  Queuing-delay
        samples are filtered by their dispatch timestamp the same way; a
        legacy Metrics built without timestamps keeps all samples.

        Flat mode returns a zero-copy view (an index cutoff into the
        time-sorted arrival column); object mode copies the filtered lists
        as before."""
        if self._cols is not None:
            lo = int(np.searchsorted(self._cols.arrival, warmup, "left"))
            return self._view(max(self._lo, lo),
                              max(self._warm_t, warmup), self._cls,
                              self._hi, self._qt_hi)
        reqs = [r for r in self._requests if r.arrival_time >= warmup]
        if len(self._qt) == len(self._qd):
            kept = [(t, d) for t, d in zip(self._qt, self._qd)
                    if t >= warmup]
            times = [t for t, _ in kept]
            delays = [d for _, d in kept]
        else:           # timestamps unavailable: keep the old behavior
            times = []
            delays = list(self._qd)
        return Metrics(requests=reqs, queuing_delays=delays,
                       queuing_delay_times=times)

    def window(self, t0: float, t1: float) -> "Metrics":
        """Time-window view over arrivals in ``[t0, t1)`` (recovery metrics:
        deadline-met/latency before vs. after a fault).  Queuing-delay
        samples are filtered by dispatch timestamp the same way.

        Flat mode is a zero-copy view: two ``searchsorted`` cuts into the
        time-sorted arrival column, composed with any prior
        ``after_warmup``/``window`` restriction.  Object mode copies the
        filtered lists (legacy semantics)."""
        if self._cols is not None:
            arr = self._cols.arrival
            lo = int(np.searchsorted(arr, t0, "left"))
            hi = int(np.searchsorted(arr, t1, "left"))
            prev_hi = self._cols.n if self._hi is None else self._hi
            return self._view(max(self._lo, lo),
                              max(self._warm_t, t0), self._cls,
                              min(prev_hi, hi), min(self._qt_hi, t1))
        reqs = [r for r in self._requests if t0 <= r.arrival_time < t1]
        if len(self._qt) == len(self._qd):
            kept = [(t, d) for t, d in zip(self._qt, self._qd)
                    if t0 <= t < t1]
            times = [t for t, _ in kept]
            delays = [d for _, d in kept]
        else:           # timestamps unavailable: keep every sample
            times = []
            delays = list(self._qd)
        return Metrics(requests=reqs, queuing_delays=delays,
                       queuing_delay_times=times)

    def latencies(self) -> Sequence[float]:
        if self._cols is not None:
            ci, ct = self._comp_window()[:2]
            return ct - self._cols.arrival[ci]
        return [r.e2e_latency for r in self.completed]

    def latency_pct(self, p: float) -> float:
        return float(_pct_sorted(self.sorted_latencies(), p))

    def deadline_met_frac(self) -> float:
        if self._cols is not None:
            ci, ct = self._comp_window()[:2]
            if len(ci) == 0:
                return float("nan")
            c = self._cols
            abs_dl = c.arrival[ci] + c.dag_deadline[c.dag_idx[ci]]
            met = int((ct <= abs_dl + 1e-9).sum())
            return met / self._n_rows()
        done = self.completed
        if not done:
            return float("nan")
        # incomplete requests count as missed (conservative, like the paper's
        # fixed-duration runs)
        met = sum(1 for r in done if r.deadline_met)
        return met / len(self._requests)

    def cold_start_count(self) -> int:
        if self._cols is not None:
            cc = self._comp_window()[2]
            pending_cold = sum(r.n_cold_starts
                               for r in self._pending_in_window())
            return int(cc.sum()) + pending_cold
        return sum(r.n_cold_starts for r in self._requests)

    def cold_start_frac(self) -> float:
        """Cold starts per invocation, numerator and denominator both over
        COMPLETED requests (an in-flight request's invocation count is not
        yet knowable, and mixing sets let the fraction exceed 1 under
        load)."""
        if self._cols is not None:
            ci, _, cc = self._comp_window()[:3]
            if len(ci) == 0:
                return float("nan")
            c = self._cols
            n_inv = int(c.dag_n_fns[c.dag_idx[ci]].sum())
            return int(cc.sum()) / max(1, n_inv)
        done = self.completed
        if not done:
            return float("nan")
        n_cold = sum(r.n_cold_starts for r in done)
        n_inv = sum(len(r.dag.functions) for r in done)
        return n_cold / max(1, n_inv)

    def accounting(self) -> Dict[str, int]:
        """Full-run request accounting for the fault-tolerance invariant
        ``completed + lost + pending == arrivals`` (docs/FAULTS.md).

        Always describes the WHOLE attached trace, ignoring any
        ``after_warmup``/``window``/class restriction — loss is a global
        property of a run, not of a view.  ``lost`` counts arrivals that
        neither completed nor remain in flight (a scheduler leak: a fault
        path dropped a request without retrying it); ``duplicate_completions``
        counts completion records beyond the first per request (a
        suppression bug: hedged retries or stale batch completions recorded
        twice).  A fault-tolerant run has both at zero — under any fault
        plan, since every in-flight request is retried and the drain phase
        runs the queues dry.  Object mode cannot distinguish lost from
        in-flight (incomplete requests are simply incomplete objects), so
        it reports them all as ``pending``.
        """
        c = self._cols
        if c is None:
            arrivals = len(self._requests)
            completed = sum(1 for r in self._requests
                            if r.completion_time is not None)
            return {"arrivals": arrivals, "completed": completed,
                    "unique_completed": completed,
                    "pending": arrivals - completed, "lost": 0,
                    "duplicate_completions": 0}
        completed = len(c.comp)
        unique = int(len(np.unique(c.finalized()[0]))) if completed else 0
        pending = len(c.pending)
        return {"arrivals": c.n, "completed": completed,
                "unique_completed": unique, "pending": pending,
                "lost": c.n - unique - pending,
                "duplicate_completions": completed - unique}

    def by_class(self) -> Dict[str, "Metrics"]:
        """Per-DAG-class views (C1..C4 style).  Flat mode: shared-column
        views keyed by class id; object mode: filtered copies, exactly the
        historical behavior (queuing samples are not class-attributed)."""
        if self._cols is not None:
            c = self._cols
            out: Dict[str, Metrics] = {}
            hi = c.n if self._hi is None else min(self._hi, c.n)
            if hi <= self._lo:
                present = []
            else:
                present = np.unique(
                    c.dag_class_id[c.dag_idx[self._lo:hi]]).tolist()
            for cid in present:
                if self._cls is not None and cid != self._cls:
                    continue
                v = self._view(self._lo, self._warm_t, cid,
                               self._hi, self._qt_hi)
                v._qchunks = []     # class views carry no queuing samples
                out[c.class_names[cid]] = v
            return out
        out2: Dict[str, Metrics] = {}
        for r in self._requests:
            cls = _dag_class(r.dag.dag_id)
            out2.setdefault(cls, Metrics())._requests.append(r)
        return out2


def summarize(name: str, m: Metrics) -> str:
    lat = m.sorted_latencies()          # one sort feeds all three ranks
    if len(lat) == 0:
        return f"{name}: no completed requests"
    return (f"{name}: n={m.n_requests} done={len(lat)} "
            f"p50={_pct_sorted(lat,50)*1e3:.1f}ms "
            f"p99={_pct_sorted(lat,99)*1e3:.1f}ms "
            f"p99.9={_pct_sorted(lat,99.9)*1e3:.1f}ms "
            f"deadlines_met={m.deadline_met_frac()*100:.2f}% "
            f"cold_starts={m.cold_start_count()}")
