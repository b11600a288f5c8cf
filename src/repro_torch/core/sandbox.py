"""Workers and proactive sandbox management (§4.3.2, §4.3.3, Pseudocode 1).

A worker owns a fixed number of execution slots ("cores" in the paper; HBM
instance slots for the TPU adaptation) and a *proactive memory pool* — the
admin-configured amount of memory usable for proactively allocated sandboxes.
Sandboxes are soft state: they can always be evicted without correctness
impact.

Hot-path data structures
------------------------
The paper's own argument (§2.4, §7.4) is that per-decision scheduling cost
bounds platform scale, so the simulator's decision loop must not be
asymptotically worse than the system it models.  Every query the scheduler
makes on the hot path is served from incrementally maintained indices:

* ``Worker`` keeps per-``(fn, state)`` buckets (sorted by ``sbx_id``, i.e.
  creation order, matching the legacy list-scan semantics exactly), an
  incremental ``used_pool_mem`` and per-state counts — ``find``, ``count``,
  ``warm_available`` and the memory properties are O(1) in the number of
  resident sandboxes.
* ``SandboxManager`` keeps per-function schedulable totals, per-function
  sets of workers holding idle (WARM/ALLOCATING) and soft-evicted sandboxes,
  and lazy min-heaps over ``(count, worker)`` keys so even/packed placement
  and soft-eviction victim selection are O(log W) amortized per decision
  instead of a full re-sort of the pool per allocated sandbox.

All index maintenance is driven by ``Sandbox.state`` assignment (a property
that notifies the owning worker) plus ``Worker.add_sandbox`` /
``Worker.remove_sandbox``, so scheduler code and tests keep their original
mutation style.  Decision order is bit-identical to the legacy scan code
(certified by ``tests/test_equivalence.py`` against goldens from the
scan-based reference; see ``benchmarks/equivalence_fingerprint.py``).

Copy of ``src/repro/core/sandbox.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import heapq
from bisect import insort
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from .types import FunctionSpec, Sandbox, SandboxState

_ALLOC = SandboxState.ALLOCATING
_WARM = SandboxState.WARM
_BUSY = SandboxState.BUSY
_SOFT = SandboxState.SOFT_EVICTED


def _sbx_sort_key(s: "Sandbox") -> int:
    return s.sbx_id


class _FnBucket:
    """Per-(worker, function) sandbox lists by state, each sorted by sbx_id
    (creation order).  Plain attributes instead of an enum-keyed dict: state
    bucketing is the single hottest lookup in the simulator and enum hashing
    dominates it.  BUSY sandboxes are only ever *counted* on hot paths (the
    scheduler never picks one), so they are tracked as a bare counter and
    transitions in/out of BUSY skip all list maintenance."""

    __slots__ = ("alloc", "warm", "soft", "busy_n", "alloc_flag",
                 "evict_pushed")

    def __init__(self):
        self.alloc: List[Sandbox] = []
        self.warm: List[Sandbox] = []
        self.soft: List[Sandbox] = []
        self.busy_n = 0
        # manager-index bookkeeping (see _FnIndex): whether this bucket is
        # counted in the per-function "has ALLOCATING sandboxes" total, and
        # the schedulable count of the live eviction-heap entry (-1: none) —
        # dedupes the one-entry-per-completion heap churn
        self.alloc_flag = False
        self.evict_pushed = -1

    def list_for(self, state: SandboxState) -> Optional[List[Sandbox]]:
        """The sorted list for a state; None for BUSY (counter-only)."""
        if state is _WARM:
            return self.warm
        if state is _ALLOC:
            return self.alloc
        if state is _SOFT:
            return self.soft
        return None


class Worker:
    """One machine of an SGS's worker pool, with O(1) sandbox queries."""

    __slots__ = ("worker_id", "cores", "pool_mem_mb", "busy_cores",
                 "_sandboxes", "_buckets", "_used_pool_mem", "_n_busy",
                 "owner", "pool_index")

    def __init__(self, worker_id: int, cores: int = 4,
                 pool_mem_mb: float = 4096.0, busy_cores: int = 0):
        self.worker_id = worker_id
        self.cores = cores
        self.pool_mem_mb = pool_mem_mb          # proactive pool capacity
        self.busy_cores = busy_cores
        # sbx_id -> Sandbox; insertion order == sbx_id order (creation order)
        self._sandboxes: Dict[int, Sandbox] = {}
        # fn name -> per-state sandbox lists
        self._buckets: Dict[str, _FnBucket] = {}
        self._used_pool_mem = 0.0
        self._n_busy = 0                        # BUSY *sandboxes* (not cores)
        self.owner = None                       # set by SandboxManager
        self.pool_index = worker_id             # position in the owner's pool

    def __repr__(self) -> str:
        return (f"Worker(worker_id={self.worker_id}, cores={self.cores}, "
                f"pool_mem_mb={self.pool_mem_mb}, "
                f"busy_cores={self.busy_cores}, "
                f"n_sandboxes={len(self._sandboxes)})")

    # -- membership -----------------------------------------------------------
    @property
    def sandboxes(self) -> List[Sandbox]:
        """Resident sandboxes in creation order (a fresh list; mutate the
        worker via ``add_sandbox``/``remove_sandbox``, never this list)."""
        return list(self._sandboxes.values())

    def add_sandbox(self, sbx: Sandbox) -> None:
        self._sandboxes[sbx.sbx_id] = sbx
        sbx._worker = self
        name = sbx.fn.name
        state = sbx.state
        bucket = self._buckets.get(name)
        if bucket is None:
            bucket = self._buckets[name] = _FnBucket()
        if state is _BUSY:
            bucket.busy_n += 1
            self._n_busy += 1
        else:
            # a brand-new sandbox always has the largest sbx_id: append keeps
            # the bucket sorted
            bucket.list_for(state).append(sbx)
        self._used_pool_mem += sbx.fn.mem_mb
        if self.owner is not None:
            self.owner._note(self, name, 0 if state is _SOFT else 1, False,
                             state is not _BUSY, state is _SOFT)

    def remove_sandbox(self, sbx: Sandbox) -> None:
        del self._sandboxes[sbx.sbx_id]
        name = sbx.fn.name
        state = sbx.state
        bucket = self._buckets[name]
        if state is _BUSY:
            bucket.busy_n -= 1
            self._n_busy -= 1
        else:
            bucket.list_for(state).remove(sbx)
        self._used_pool_mem -= sbx.fn.mem_mb
        sbx._worker = None
        if self.owner is not None:
            self.owner._note(self, name, 0 if state is _SOFT else -1, False,
                             state is not _BUSY, state is _SOFT)

    def _reindex(self, sbx: Sandbox, old: SandboxState,
                 new: SandboxState) -> None:
        """Called by the ``Sandbox.state`` setter: move between buckets."""
        bucket = self._buckets[sbx.fn.name]
        lst = bucket.list_for(old)
        if lst is None:
            bucket.busy_n -= 1
            self._n_busy -= 1
        else:
            lst.remove(sbx)
        lst = bucket.list_for(new)
        if lst is None:
            bucket.busy_n += 1
            self._n_busy += 1
        else:
            insort(lst, sbx, key=_sbx_sort_key)
        if self.owner is not None:
            delta = ((0 if new is _SOFT else 1)
                     - (0 if old is _SOFT else 1))
            soft_touched = old is _SOFT or new is _SOFT
            self.owner._note(
                self, sbx.fn.name, delta, old is _BUSY,
                old is _BUSY or new is _BUSY or soft_touched, soft_touched)

    # -- memory ---------------------------------------------------------------
    @property
    def used_pool_mem(self) -> float:
        return self._used_pool_mem

    @property
    def free_pool_mem(self) -> float:
        return self.pool_mem_mb - self._used_pool_mem

    def shed_to_capacity(self) -> int:
        """Evict resident non-BUSY sandboxes (creation order — oldest
        first) until used pool memory fits ``pool_mem_mb`` again.  The
        eviction path for a ``memory_pressure`` gray failure after the
        fault handler shrinks ``pool_mem_mb``: BUSY sandboxes are never
        touched, so a worker can stay over budget until executions finish.
        Returns the number of evicted sandboxes."""
        n = 0
        if self._used_pool_mem <= self.pool_mem_mb:
            return n
        for s in self.sandboxes:        # fresh list: safe to remove during
            if self._used_pool_mem <= self.pool_mem_mb:
                break
            if s.state is _BUSY:
                continue
            self.remove_sandbox(s)
            n += 1
        return n

    @property
    def free_cores(self) -> int:
        return self.cores - self.busy_cores

    # -- sandbox queries ------------------------------------------------------
    def bucket_len(self, fn_name: str, state: SandboxState) -> int:
        b = self._buckets.get(fn_name)
        if b is None:
            return 0
        lst = b.list_for(state)
        return b.busy_n if lst is None else len(lst)

    def count(self, fn_name: str, *states: SandboxState) -> int:
        states = states or tuple(SandboxState)
        return sum(self.bucket_len(fn_name, st) for st in states)

    def schedulable_count(self, fn_name: str) -> int:
        """Sandboxes counted for placement decisions: everything except
        soft-evicted (those are invisible to the scheduler, §4.3.3)."""
        b = self._buckets.get(fn_name)
        if b is None:
            return 0
        return len(b.alloc) + len(b.warm) + b.busy_n

    def idle_count(self, fn_name: str) -> int:
        """WARM + ALLOCATING (schedulable and not executing)."""
        b = self._buckets.get(fn_name)
        if b is None:
            return 0
        return len(b.alloc) + len(b.warm)

    def has_non_busy_sandbox(self) -> bool:
        return len(self._sandboxes) > self._n_busy

    def find(self, fn_name: str, state: SandboxState) -> Optional[Sandbox]:
        """Earliest-created resident sandbox of ``fn_name`` in ``state``.
        (BUSY sandboxes are tracked as a counter; finding one falls back to
        the ordered residency map — a cold path the scheduler never takes.)"""
        b = self._buckets.get(fn_name)
        if b is None:
            return None
        lst = b.list_for(state)
        if lst is None:
            for s in self._sandboxes.values():
                if s.fn.name == fn_name and s.state is _BUSY:
                    return s
            return None
        return lst[0] if lst else None

    def has_ready_soft(self, fn_name: str, now: float) -> bool:
        b = self._buckets.get(fn_name)
        if b is None:
            return False
        for s in b.soft:
            if s.ready_at <= now:
                return True
        return False

    def warm_available(self, fn_name: str, now: float) -> Optional[Sandbox]:
        """A sandbox ready for immediate reuse: the earliest-created WARM or
        ALLOCATING sandbox whose setup has finished.  An ALLOCATING sandbox
        transitions to WARM lazily here (legacy scan semantics: only the
        returned sandbox is promoted)."""
        b = self._buckets.get(fn_name)
        if b is None:
            return None
        cutoff = now + 1e-12
        best: Optional[Sandbox] = None
        for s in b.alloc:
            if s.ready_at <= cutoff:
                best = s
                break
        for s in b.warm:
            if s.ready_at <= cutoff:
                if best is None or s.sbx_id < best.sbx_id:
                    best = s
                break
        if best is not None and best.state is _ALLOC:
            best.state = _WARM
        return best


AllocHook = Callable[[Sandbox, Worker], None]


def _pool_key(w: Worker) -> int:
    return w.pool_index


_EMPTY: List[Worker] = []


class _FnIndex:
    """Per-function manager-level indices: schedulable total, worker sets by
    residency kind, and the lazy placement/eviction/warm-candidate heaps."""

    __slots__ = ("total", "idle", "soft", "place_heap", "evict_heap",
                 "idle_sorted", "warm_heap", "n_alloc")

    def __init__(self):
        self.total = 0                      # schedulable sandboxes, all workers
        self.idle: Set[Worker] = set()      # workers with WARM/ALLOCATING
        self.soft: Set[Worker] = set()      # workers with SOFT_EVICTED
        self.place_heap: List[Tuple[int, int]] = []
        self.evict_heap: List[Tuple[int, int]] = []
        # ``idle`` in pool order as (pool_index, worker, bucket) triples,
        # maintained incrementally on membership change (insort/remove,
        # small lists) — the dispatcher walks this on every decision, and
        # both the re-sort per walk and the per-probe bucket lookup it
        # replaces dominated the hot path
        self.idle_sorted: List[Tuple[int, "Worker", _FnBucket]] = []
        # lazy max-heap of (-warm_count, pool_index, worker, bucket): the
        # dispatcher's most-warm-copies pick in O(log W) amortized instead
        # of a full walk.  Only consulted when ``n_alloc`` is 0 — with an
        # ALLOCATING sandbox anywhere, the walk's lazy ALLOC->WARM
        # promotions are observable side effects and the legacy full probe
        # order must run.  Entries are pushed on every warm-count change
        # and validated (count + ownership) at pop.
        self.warm_heap: List[Tuple[int, int, "Worker", _FnBucket]] = []
        self.n_alloc = 0        # workers with a non-empty ALLOCATING bucket


@dataclass
class SandboxManager:
    """Implements Pseudocode 1: even placement, soft eviction, fair hard
    eviction — over one SGS's worker pool.

    ``set_demand`` *reconciles* the actual schedulable allocation against the
    estimator's target each tick (rather than diffing successive estimates):
    this self-heals after hard evictions and reactive cold-start allocations
    change the real count behind the estimator's back.

    Placement and soft-eviction consult lazily invalidated heaps of
    ``(schedulable_count, worker_id)`` keys: every count change pushes a
    fresh entry; stale entries are discarded at pop.  The pop order equals
    the legacy per-sandbox full re-sort of the pool, at O(log W) amortized.
    """

    workers: List[Worker]
    # "even" spreads each function's sandboxes across workers (§4.3.2);
    # "packed" fills one worker before the next (the Fig. 9 ablation).
    placement: str = "even"
    # "fair" = workload-aware victim choice (§4.3.3); "lru" = plain LRU
    # (the §7.3.1 eviction ablation).
    eviction: str = "fair"
    # called when a brand-new sandbox begins allocation (lets the executor
    # model / perform the actual setup work in the background)
    on_allocate: Optional[AllocHook] = None
    # demand targets last pushed by the SGS: fn name -> sandbox count
    demand_map: Dict[str, int] = field(default_factory=dict)
    fn_specs: Dict[str, FunctionSpec] = field(default_factory=dict)
    # counters
    n_hard_evictions: int = 0
    n_soft_evictions: int = 0
    n_allocations: int = 0
    n_revivals: int = 0

    # -- indices (all incremental; see class docstring) ----------------------
    _by_id: Dict[int, Worker] = field(
        default_factory=dict, init=False, repr=False)
    _fns: Dict[str, "_FnIndex"] = field(
        default_factory=dict, init=False, repr=False)

    def __post_init__(self) -> None:
        for i, w in enumerate(self.workers):
            w.owner = self
            w.pool_index = i
            self._by_id[w.worker_id] = w
        # lazy-heap growth bound, computed once (decision-neutral: it only
        # gates when compaction rebuilds a heap; worker removal leaves it
        # conservatively large)
        self.heap_cap = 64 + 8 * len(self.workers)

    # ---------------------------------------------------------- heap keying
    def _place_key(self, count: int, wid: int) -> Tuple[int, int]:
        # even: min count first; packed: max count first — ties by worker_id,
        # exactly the legacy ``sorted`` keys
        return (-count, wid) if self.placement == "packed" else (count, wid)

    def _evict_key(self, count: int, wid: int) -> Tuple[int, int]:
        # mirror image of placement (Pseudocode 1 lines 11-15)
        return (count, wid) if self.placement == "packed" else (-count, wid)

    def _ensure_fn(self, fn_name: str) -> "_FnIndex":
        fi = self._fns.get(fn_name)
        if fi is not None:
            return fi
        fi = _FnIndex()
        for w in self.workers:
            c = w.schedulable_count(fn_name)
            fi.total += c
            fi.place_heap.append(self._place_key(c, w.worker_id))
            fi.evict_heap.append(self._evict_key(c, w.worker_id))
            b = w._buckets.get(fn_name)
            if b is not None:
                b.evict_pushed = c
                b.alloc_flag = bool(b.alloc)
                if b.alloc_flag:
                    fi.n_alloc += 1
                if b.warm:
                    fi.warm_heap.append((-len(b.warm), w.pool_index, w, b))
            if w.idle_count(fn_name):
                fi.idle.add(w)
            if w.bucket_len(fn_name, _SOFT):
                fi.soft.add(w)
        fi.idle_sorted = sorted(
            (w.pool_index, w, w._buckets[fn_name]) for w in fi.idle)
        heapq.heapify(fi.place_heap)
        heapq.heapify(fi.evict_heap)
        heapq.heapify(fi.warm_heap)
        self._fns[fn_name] = fi
        return fi

    def _note(self, w: Worker, fn_name: str, sched_delta: int,
              gained_idle: bool = False, touched_idle: bool = True,
              touched_soft: bool = True) -> None:
        """Worker-event hook: a sandbox of ``fn_name`` on ``w`` was added,
        removed, or changed state.  Keeps totals, sets and heaps in sync.
        ``touched_idle``/``touched_soft`` let callers skip set maintenance
        for transitions that provably cannot change membership."""
        fi = self._fns.get(fn_name)
        if fi is None:
            # first event for this function: build everything from current
            # state (which already includes this event)
            self._ensure_fn(fn_name)
            return
        fi.total += sched_delta
        b = w._buckets[fn_name]         # exists: this event touched it
        if touched_idle:
            if b.alloc or b.warm:
                if w not in fi.idle:
                    fi.idle.add(w)
                    insort(fi.idle_sorted, (w.pool_index, w, b))
            elif w in fi.idle:
                fi.idle.remove(w)
                fi.idle_sorted.remove((w.pool_index, w, b))
        if touched_soft:
            if b.soft:
                fi.soft.add(w)
            else:
                fi.soft.discard(w)
        has_alloc = bool(b.alloc)
        if has_alloc != b.alloc_flag:
            b.alloc_flag = has_alloc
            fi.n_alloc += 1 if has_alloc else -1
        cap = self.heap_cap
        if b.warm:
            # keep a current-count warm-candidate entry live (lazy heap)
            heap = fi.warm_heap
            heapq.heappush(heap, (-len(b.warm), w.pool_index, w, b))
            if len(heap) > cap:
                self._compact_warm(fn_name, fi)
        if sched_delta or gained_idle:
            c = len(b.alloc) + len(b.warm) + b.busy_n
            wid = w.worker_id
            if sched_delta:
                # placement validity depends only on the count, so the place
                # heap needs no entry for pure BUSY->WARM candidacy changes
                heap = fi.place_heap
                heapq.heappush(heap, self._place_key(c, wid))
                if len(heap) > cap:     # bound lazy-entry growth
                    self._compact(fn_name, heap, self._place_key)
            if b.evict_pushed != c:     # dedupe: a live entry already covers c
                b.evict_pushed = c
                heap = fi.evict_heap
                heapq.heappush(heap, self._evict_key(c, wid))
                if len(heap) > cap:
                    self._compact(fn_name, heap, self._evict_key)

    def _compact(self, fn_name: str, heap: List[Tuple[int, int]],
                 keyer: Callable[[int, int], Tuple[int, int]]) -> None:
        """Rebuild a lazy heap from current counts (drops stale entries)."""
        heap[:] = [keyer(w.schedulable_count(fn_name), w.worker_id)
                   for w in self.workers]
        heapq.heapify(heap)

    def _compact_warm(self, fn_name: str, fi: "_FnIndex") -> None:
        """Rebuild the warm-candidate heap from current warm counts."""
        entries = []
        for w in self.workers:
            b = w._buckets.get(fn_name)
            if b is not None and b.warm:
                entries.append((-len(b.warm), w.pool_index, w, b))
        fi.warm_heap[:] = entries
        heapq.heapify(fi.warm_heap)

    # ------------------------------------------------- fused hot transitions
    def mark_busy(self, w: Worker, sbx: Sandbox) -> None:
        """WARM -> BUSY (warm dispatch hit), fused: equivalent to
        ``sbx.state = BUSY`` but with the generic reindex/note cascade
        hand-inlined — this transition changes no schedulable count, so no
        place/evict entries are needed; the warm-candidate heap gets the
        worker's refreshed warm count (if any warm copies remain)."""
        name = sbx.fn.name
        b = w._buckets[name]
        warm = b.warm
        warm.remove(sbx)
        b.busy_n += 1
        w._n_busy += 1
        sbx._state = _BUSY
        fi = self._fns[name]
        if warm:
            heap = fi.warm_heap
            heapq.heappush(heap, (-len(warm), w.pool_index, w, b))
            if len(heap) > 64 + 8 * len(self.workers):
                self._compact_warm(name, fi)
        elif not b.alloc:
            if w in fi.idle:
                fi.idle.remove(w)
                fi.idle_sorted.remove((w.pool_index, w, b))

    def mark_warm(self, w: Worker, sbx: Sandbox) -> None:
        """BUSY -> WARM (completion), fused mirror of ``mark_busy``; pushes
        the refreshed warm-candidate entry and — only when no live entry
        already covers the (unchanged) schedulable count — the one
        eviction-heap entry the worker gains candidacy with."""
        name = sbx.fn.name
        b = w._buckets[name]
        insort(b.warm, sbx, key=_sbx_sort_key)
        b.busy_n -= 1
        w._n_busy -= 1
        sbx._state = _WARM
        fi = self._fns[name]
        cap = self.heap_cap
        if w not in fi.idle:
            fi.idle.add(w)
            insort(fi.idle_sorted, (w.pool_index, w, b))
        heap = fi.warm_heap
        heapq.heappush(heap, (-len(b.warm), w.pool_index, w, b))
        if len(heap) > cap:
            self._compact_warm(name, fi)
        c = len(b.alloc) + len(b.warm) + b.busy_n
        if b.evict_pushed != c:
            b.evict_pushed = c
            heap = fi.evict_heap
            heapq.heappush(heap, self._evict_key(c, w.worker_id))
            if len(heap) > cap:
                self._compact(name, heap, self._evict_key)

    # -------------------------------------------------------- SGS-side views
    def idle_workers(self, fn_name: str) -> List[Worker]:
        """Workers holding a WARM/ALLOCATING sandbox of ``fn_name``, in pool
        order (the dispatcher's warm-candidate index), maintained
        incrementally on membership change."""
        fi = self._fns.get(fn_name)
        if fi is None:
            return _EMPTY
        return [e[1] for e in fi.idle_sorted]

    def has_soft_workers(self, fn_name: str) -> bool:
        fi = self._fns.get(fn_name)
        return fi is not None and bool(fi.soft)

    def remove_worker(self, w: Worker) -> None:
        """Fail-stop removal (§6.1): drop the worker and its sandboxes from
        every index."""
        if w.worker_id not in self._by_id:
            return
        del self._by_id[w.worker_id]
        if w in self.workers:
            self.workers.remove(w)
        for fn_name, b in w._buckets.items():
            fi = self._fns.get(fn_name)
            if fi is None:
                continue
            fi.total -= w.schedulable_count(fn_name)
            if w in fi.idle:
                fi.idle.remove(w)
                fi.idle_sorted.remove((w.pool_index, w, b))
            fi.soft.discard(w)
            if b.alloc_flag:
                b.alloc_flag = False
                fi.n_alloc -= 1
            # purge the failed worker's warm-candidate entries outright so
            # the dispatcher's fast path never has to consider ownership
            if b.warm:
                self._compact_warm(fn_name, fi)
        w.owner = None

    # ------------------------------------------------------------------ API
    def set_demand(self, fn: FunctionSpec, new_demand: int, now: float) -> None:
        """SANDBOXMANAGEMENT(D): allocate when demand rises above the actual
        allocation, soft-evict when it falls below (Pseudocode 1, lines 2-17)."""
        self.fn_specs[fn.name] = fn
        self.demand_map[fn.name] = new_demand
        actual = self.total_sandboxes(fn.name)
        if new_demand > actual:
            self.allocate_sandboxes(fn, new_demand - actual, now)
        elif new_demand < actual:
            self.soft_evict_sandboxes(fn, actual - new_demand)

    # ------------------------------------------------------- even placement
    def allocate_sandboxes(self, fn: FunctionSpec, n: int, now: float) -> None:
        """ALLOCATESANDBOXES (lines 19-38): for each needed sandbox, pick the
        worker with the minimum count of this function's sandboxes (even) or
        the maximum (packed ablation); prefer reviving a soft-evicted sandbox
        there (free), else allocate from the pool, hard-evicting *surplus*
        sandboxes if the pool is saturated."""
        heap = self._ensure_fn(fn.name).place_heap
        packed = self.placement == "packed"
        for _ in range(n):
            placed = False
            stash: List[Tuple[int, int]] = []
            while heap:
                entry = heapq.heappop(heap)
                cnt, wid = entry
                if packed:
                    cnt = -cnt
                w = self._by_id.get(wid)
                if w is None or w.schedulable_count(fn.name) != cnt:
                    continue            # dead worker or stale count
                revived = w.find(fn.name, _SOFT)
                if revived is not None:
                    # Preferentially unmark a soft-evicted sandbox: free.
                    revived.state = (_WARM if revived.ready_at <= now
                                     else _ALLOC)
                    self.n_revivals += 1
                    placed = True
                elif (w.free_pool_mem >= fn.mem_mb
                      or self._hard_evict(w, fn)):
                    sbx = Sandbox(fn=fn, worker_id=w.worker_id,
                                  state=_ALLOC,
                                  ready_at=now + fn.setup_time, last_used=now)
                    w.add_sandbox(sbx)
                    self.n_allocations += 1
                    if self.on_allocate is not None:
                        self.on_allocate(sbx, w)
                    placed = True
                else:
                    stash.append(entry)  # this worker cannot host; try next
                    continue
                break
            for entry in stash:
                heapq.heappush(heap, entry)
            if not placed:
                return              # pool saturated with protected sandboxes

    # ----------------------------------------------------------- soft evict
    def soft_evict_sandboxes(self, fn: FunctionSpec, n: int) -> None:
        """Lines 11-15: mirror-image of placement — repeatedly pick the worker
        holding the *max* sandboxes of this function and soft-evict one there,
        keeping the residue balanced for statistical multiplexing.  (In the
        packed ablation the mirror image is the *min* non-empty worker, so
        packing is preserved.)  Victim selection is O(log W) amortized via the
        eviction heap + the per-worker state buckets."""
        fname = fn.name
        heap = self._ensure_fn(fname).evict_heap
        packed = self.placement == "packed"
        for _ in range(n):
            victim: Optional[_FnBucket] = None
            while heap:
                cnt, wid = heapq.heappop(heap)
                if not packed:
                    cnt = -cnt
                w = self._by_id.get(wid)
                if w is None:
                    continue            # dead worker
                b = w._buckets.get(fname)
                if b is None:
                    continue
                if b.evict_pushed == cnt:
                    b.evict_pushed = -1  # the tracked live entry is consumed
                if (len(b.alloc) + len(b.warm) + b.busy_n != cnt
                        or not (b.alloc or b.warm)):
                    continue            # stale count or no evictable sandbox
                victim = b
                break
            if victim is None:
                return
            # earliest-created WARM, else earliest-created ALLOCATING (the
            # bucket lists are sbx_id-sorted, so this is Worker.find)
            sbx = victim.warm[0] if victim.warm else victim.alloc[0]
            sbx.state = _SOFT           # hooks push refreshed heap entries
            self.n_soft_evictions += 1

    # ------------------------------------------------------ reactive allocation
    def reactive_allocate(self, w: Worker, fn: FunctionSpec,
                          now: float) -> Optional[Sandbox]:
        """Cold-start allocation on the dispatch critical path: make room via
        hard eviction if the pool is full.  Returns ``None`` when the worker
        cannot host the sandbox without harming a protected function — the
        caller must fall back (another worker / requeue), never overcommit
        the worker's proactive memory pool."""
        if w.free_pool_mem < fn.mem_mb and not self._hard_evict(w, fn):
            return None
        sbx = Sandbox(fn=fn, worker_id=w.worker_id,
                      state=_BUSY,
                      ready_at=now + fn.setup_time, last_used=now)
        w.add_sandbox(sbx)
        return sbx

    # ----------------------------------------------------------- hard evict
    def _hard_evict(self, w: Worker, incoming: FunctionSpec) -> bool:
        """HARDEVICT (lines 39-46): evict until ``incoming`` fits.

        Victim choice is workload-aware ("fair", §4.3.3): soft-evicted
        sandboxes go first; among live ones, only functions at-or-above their
        estimated demand are eligible (protects functions whose allocation is
        far below their estimate), preferring the one closest to its estimate.
        Never evicts BUSY sandboxes.  Returns False if ``incoming`` cannot fit
        without harming a protected function.
        """
        while w.free_pool_mem < incoming.mem_mb:
            cands = [s for s in w._sandboxes.values()
                     if s.state is not _BUSY and s.fn.name != incoming.name]
            if not cands:
                return False
            if self.eviction == "lru":
                victim = min(cands, key=lambda s: s.last_used)
            else:
                soft = [s for s in cands if s.state is _SOFT]
                if soft:
                    victim = min(soft, key=self._fairness_key)
                else:
                    surplus = [s for s in cands
                               if self._surplus(s.fn.name) >= 0]
                    if not surplus:
                        return False   # all under-provisioned: back off
                    victim = min(surplus, key=self._fairness_key)
            w.remove_sandbox(victim)
            self.n_hard_evictions += 1
        return True

    def _surplus(self, fn_name: str) -> int:
        return self.total_sandboxes(fn_name) - self.demand_map.get(fn_name, 0)

    def _fairness_key(self, s: Sandbox) -> float:
        """abs(total allocation - estimated demand) for the sandbox's
        function; smaller = closer to its estimate = preferred victim."""
        return abs(self._surplus(s.fn.name))

    # -------------------------------------------------------------- queries
    def total_sandboxes(self, fn_name: str) -> int:
        fi = self._fns.get(fn_name)
        if fi is None:
            # function never indexed: count once and start tracking
            fi = self._ensure_fn(fn_name)
        return fi.total

    def counts_per_worker(self, fn_name: str) -> List[int]:
        return [w.schedulable_count(fn_name) for w in self.workers]
