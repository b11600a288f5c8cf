"""Load balancing service (§5): sandbox-aware routing + per-DAG SGS scaling.

Responsibilities (§5.1): spread load across SGSs, and route requests to
maximize the number that land on a proactively allocated sandbox.  Scaling
follows Pseudocode 2: the universal indicator is per-DAG queuing delay
piggybacked on responses; the metric is the sandbox-count-weighted mean
queuing delay normalized by the DAG's slack.

Copy of ``src/repro/core/lbs.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import bisect
import hashlib
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .autoscale import ScalingEvent
from .sgs import SemiGlobalScheduler
from .types import DagSpec, Request


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class ConsistentHashRing:
    """Classic Karger ring [31] with virtual nodes.

    Membership is dynamic: :meth:`add_node`/:meth:`remove_node` re-shard
    incrementally, so when the SGS set changes (control-plane elasticity,
    failover replacement pools) only the key range owned by the affected
    node's vnodes moves — roughly ``1/n`` of lookups for one of ``n``
    nodes — and every other key keeps its owner."""

    def __init__(self, ids: List[int], vnodes: int = 50):
        if not ids:
            # lookup() would otherwise die later with a bare
            # ZeroDivisionError from `% len(self._points)`
            raise ValueError(
                "ConsistentHashRing needs at least one SGS id")
        self._vnodes = vnodes
        self._points: List[int] = []
        self._owner: Dict[int, int] = {}
        for sid in ids:
            for v in range(vnodes):
                h = _hash(f"sgs-{sid}-vn{v}")
                self._points.append(h)
                self._owner[h] = sid
        self._points.sort()
        self._ids = sorted(set(ids))

    def ids(self) -> List[int]:
        return list(self._ids)

    def lookup(self, key: str) -> int:
        h = _hash(key)
        i = bisect.bisect_right(self._points, h) % len(self._points)
        return self._owner[self._points[i]]

    def successors(self, key: str) -> List[int]:
        """All SGS ids in ring order starting at the key's owner — the scale
        out order ("the next one in the ring", §5.2.2)."""
        first = self.lookup(key)
        ids = self._ids
        start = ids.index(first)
        return [ids[(start + k) % len(ids)] for k in range(len(ids))]

    # ------------------------------------------------------------ re-sharding
    def add_node(self, sid: int) -> None:
        """Insert one SGS id's vnodes (no-op if already present): only keys
        that hash between a new vnode and its predecessor move to ``sid``."""
        if sid in self._ids:
            return
        for v in range(self._vnodes):
            h = _hash(f"sgs-{sid}-vn{v}")
            if h in self._owner:        # 64-bit collision: keep the incumbent
                continue
            bisect.insort(self._points, h)
            self._owner[h] = sid
        bisect.insort(self._ids, sid)

    def remove_node(self, sid: int) -> None:
        """Drop one SGS id's vnodes: its key range redistributes to the ring
        successors; all other keys keep their owner.  Removing the last id
        raises (an empty ring cannot route)."""
        if sid not in self._ids:
            raise ValueError(f"unknown SGS id {sid}")
        if len(self._ids) == 1:
            raise ValueError(
                "ConsistentHashRing needs at least one SGS id")
        owner = self._owner
        self._points = [p for p in self._points if owner[p] != sid]
        for h in [h for h, o in owner.items() if o == sid]:
            del owner[h]
        self._ids.remove(sid)


@dataclass
class LBSConfig:
    scale_out_threshold: float = 0.3    # SOT (§7.5 knee)
    scale_in_threshold: float = 0.05    # well below SOT to avoid oscillation
    qdelay_window: int = 10             # samples per active SGS per decision
    decision_interval: float = 0.25     # fallback cadence for low-RPS DAGs
    scale_in_patience: int = 3          # consecutive below-SIT decisions
    discount_factor: float = 0.25       # removed-list ticket scaling (§5.2.3)
    ewma_alpha: float = 0.3
    gradual: bool = True                # False -> instant scale-out ablation
    sandbox_aware: bool = False         # handled via lottery tickets
    seed: int = 0
    # churn damping for the per-DAG SGS set (defaults are decision-neutral:
    # 0.0 / None reproduce the historical behavior exactly)
    scale_out_cooldown: float = 0.0     # min seconds between per-DAG adds
    max_sgs_per_dag: Optional[int] = None   # hard cap on a DAG's active set


@dataclass
class _DagState:
    dag: DagSpec
    active: List[int] = field(default_factory=list)     # in scale-out order
    removed: List[int] = field(default_factory=list)
    # piggybacked state per SGS
    qdelay_ewma: Dict[int, float] = field(default_factory=dict)
    qdelay_samples: Dict[int, int] = field(default_factory=dict)
    sandbox_count: Dict[int, int] = field(default_factory=dict)
    # unfolded piggyback reports [(sgs_id, qdelay, sandbox_count), ...]:
    # ``report`` is on the per-dispatch hot path, so samples are buffered
    # and folded into the EWMA/window dicts lazily at every read point
    # (_fold) — the fold preserves per-SGS sample order, so every value
    # ever *read* is bit-identical to eager per-sample updates
    pending: List[tuple] = field(default_factory=list)
    # max(dag.slack, 1e-6), computed once (the lottery divides by it on
    # every multi-SGS draw)
    slack_floor: float = 1.0
    last_decision: float = 0.0
    last_scale_out: float = -1e18       # for LBSConfig.scale_out_cooldown
    below_sit_streak: int = 0
    n_scale_outs: int = 0
    n_scale_ins: int = 0

    def __post_init__(self):
        self.slack_floor = max(self.dag.slack, 1e-6)


class LoadBalancer:
    def __init__(self, sgss: List[SemiGlobalScheduler],
                 config: Optional[LBSConfig] = None):
        self.cfg = config or LBSConfig()
        self._alpha = self.cfg.ewma_alpha
        self.sgss: Dict[int, SemiGlobalScheduler] = {s.sgs_id: s for s in sgss}
        self.ring = ConsistentHashRing(list(self.sgss))
        self._dag_state: Dict[str, _DagState] = {}
        self._rng = random.Random(self.cfg.seed)
        # wire the piggyback channel
        for s in sgss:
            s.report = self.report
        # history for benchmarks: (time, dag_id, n_active)
        self.scale_events: List[tuple] = []
        # typed mirror of the same decisions (core.autoscale.ScalingEvent):
        # merged with the LBS replica autoscaler's events into
        # ExperimentResult.scaling_events
        self.scaling_log: List[ScalingEvent] = []

    # ----------------------------------------------------------------- route
    def select(self, req: Request, now: float) -> SemiGlobalScheduler:
        """Routing decision only (lets callers model control-plane latency
        between the decision and the submission)."""
        st = self._dag_state.get(req.dag.dag_id)   # inlined _state fast path
        if st is None:
            st = self._state(req.dag, now)
        return self.sgss[self._lottery(st)]

    def route(self, req: Request, now: float) -> SemiGlobalScheduler:
        sgs = self.select(req, now)
        sgs.submit_request(req)
        return sgs

    def _state(self, dag: DagSpec, now: float) -> _DagState:
        st = self._dag_state.get(dag.dag_id)
        if st is None:
            # Initial SGS selection by consistent hashing (§5.2.2)
            first = self.ring.lookup(dag.dag_id)
            st = _DagState(dag=dag, active=[first], last_decision=now)
            st.sandbox_count[first] = 1
            self._dag_state[dag.dag_id] = st
        return st

    def _lottery(self, st: _DagState) -> int:
        """Lottery scheduling (§5.2.3): tickets proportional to each SGS's
        proactive sandbox count for this DAG; removed-list SGSs keep
        discounted tickets so scale-in drains gradually.

        Hotspot damping (§5.1 responsibility (1)): tickets are divided by
        (1 + qdelay/slack) using the piggybacked per-SGS queuing delay.
        Without this, sandbox-proportional routing is a positive feedback
        loop — a hot SGS receives more requests, estimates more demand,
        allocates more sandboxes, and earns even more tickets while its
        queue grows.
        """
        active = st.active
        if not self.cfg.gradual:
            # instant-scaling ablation: plain round-robin over active SGSs
            return active[self._rng.randrange(len(active))]
        if len(active) == 1 and not st.removed:
            # single-SGS fast path (the common case): the draw is a foregone
            # conclusion, but still consume one uniform so the RNG stream —
            # and therefore every later multi-SGS lottery — is unchanged
            self._rng.random()
            return active[0]
        if st.pending:
            self._fold(st)      # multi-SGS draw reads EWMAs/counts
        # damping divisor: 1 + qdelay/slack (hotspot damping, see docstring);
        # hand-inlined — this runs once per routed request under scale-out.
        # Stored sandbox counts are already clamped >= 1 (``_fold``,
        # ``_state``, ``_scale_out``), so the historical
        # ``max(1.0, float(count))`` reduces to a default of 1.
        slack = st.slack_floor
        ewma_get = st.qdelay_ewma.get
        count_get = st.sandbox_count.get
        tickets: List[Tuple[int, float]] = []
        append = tickets.append
        total = 0.0
        for sid in active:
            t = count_get(sid, 1) / (1.0 + ewma_get(sid, 0.0) / slack)
            append((sid, t))
            total += t
        if st.removed:
            discount = self.cfg.discount_factor
            for sid in st.removed:
                t = (discount * count_get(sid, 1)
                     / (1.0 + ewma_get(sid, 0.0) / slack))
                append((sid, t))
                total += t
        pick = self._rng.random() * total
        acc = 0.0
        for sid, t in tickets:
            acc += t
            if pick <= acc:
                return sid
        return tickets[-1][0]

    # ------------------------------------------------------------- piggyback
    def report(self, dag_id: str, sgs_id: int, qdelay: float,
               sandbox_count: int) -> None:
        st = self._dag_state.get(dag_id)
        if st is None:
            return
        st.pending.append((sgs_id, qdelay, sandbox_count))

    def _fold(self, st: _DagState) -> None:
        """Apply buffered piggyback reports in arrival order (see
        ``_DagState.pending``).  Called before any read of the EWMA/window/
        count dicts; produces exactly the values eager per-report updates
        would have."""
        pending = st.pending
        if not pending:
            return
        a = self._alpha
        ewma = st.qdelay_ewma
        samples = st.qdelay_samples
        counts = st.sandbox_count
        for sgs_id, qdelay, sandbox_count in pending:
            prev = ewma.get(sgs_id)
            ewma[sgs_id] = qdelay if prev is None \
                else a * qdelay + (1 - a) * prev
            samples[sgs_id] = samples.get(sgs_id, 0) + 1
            counts[sgs_id] = sandbox_count if sandbox_count > 1 else 1
        pending.clear()

    # --------------------------------------------------------------- scaling
    def scaling_metric(self, st: _DagState) -> float:
        """Pseudocode 2, lines 3-6: sandbox-count weighted queuing delay,
        normalized by the DAG's available slack (deadline-awareness)."""
        num = 0.0
        den = 0.0
        for sid in st.active:
            n = st.sandbox_count.get(sid, 1)
            qd = st.qdelay_ewma.get(sid, 0.0)
            num += n * qd
            den += n
        if den == 0:
            return 0.0
        weighted = num / den
        slack = max(st.dag.slack, 1e-6)
        return weighted / slack

    def check_scaling(self, now: float) -> None:
        """Periodic scaling pass over every DAG (engine calls this each
        decision interval; decisions also gate on filled windows, §5.2.2)."""
        for st in self._dag_state.values():
            if st.pending:
                self._fold(st)
            window_full = all(
                st.qdelay_samples.get(sid, 0) >= self.cfg.qdelay_window
                for sid in st.active)
            timed_out = now - st.last_decision >= self.cfg.decision_interval
            if not (window_full or (timed_out and any(st.qdelay_samples.values()))):
                continue
            metric = self.scaling_metric(st)
            if metric > self.cfg.scale_out_threshold:
                st.below_sit_streak = 0
                if (self.cfg.scale_out_cooldown > 0.0
                        and now - st.last_scale_out
                        < self.cfg.scale_out_cooldown):
                    continue    # cooling down: keep observing
                if not self._scale_out(st, now):
                    continue    # already at max SGSs: keep observing
                st.last_scale_out = now
                action = "scale_out"
            elif metric < self.cfg.scale_in_threshold and len(st.active) > 1:
                # oscillation damping: require several consecutive quiet
                # decisions before dissociating an SGS (§5.2.2 "well below")
                st.below_sit_streak += 1
                if st.below_sit_streak < self.cfg.scale_in_patience:
                    st.last_decision = now
                    continue
                st.below_sit_streak = 0
                self._scale_in(st, now)
                action = "scale_in"
            else:
                st.below_sit_streak = 0
                continue
            # reinitialize windows (and the EWMAs themselves) so the next
            # decision observes only post-decision data (§5.2.2)
            st.qdelay_samples = {sid: 0 for sid in st.active}
            st.qdelay_ewma = {}
            st.last_decision = now
            n_active = len(st.active)
            self.scale_events.append((now, st.dag.dag_id, n_active))
            delta = 1 if action == "scale_out" else -1
            self.scaling_log.append(ScalingEvent(
                t=round(now, 6), component="sgs", action=action,
                n_before=n_active - delta, n_after=n_active,
                metric=round(metric, 6), detail={"dag_id": st.dag.dag_id}))

    def _scale_out(self, st: _DagState, now: float) -> bool:
        cap = self.cfg.max_sgs_per_dag
        if cap is not None and len(st.active) >= cap:
            return False
        for sid in self.ring.successors(st.dag.dag_id):
            if sid not in st.active:
                if sid in st.removed:
                    st.removed.remove(sid)
                st.active.append(sid)
                st.n_scale_outs += 1
                # gradual ramp-up: the new SGS pre-allocates the mean sandbox
                # count across active SGSs (including itself), and starts with
                # 1 lottery ticket (§5.2.3)
                if self.cfg.gradual:
                    counts = [st.sandbox_count.get(s, 0) for s in st.active]
                    avg = max(1, int(round(sum(counts) / len(st.active))))
                    per_fn = max(1, avg // max(1, len(st.dag.functions)))
                    self.sgss[sid].preallocate(st.dag, per_fn)
                st.sandbox_count[sid] = 1
                return True
        return False

    def _scale_in(self, st: _DagState, now: float) -> None:
        # remove the SGS that was added last (§5.2.2)
        sid = st.active.pop()
        st.removed.append(sid)
        st.n_scale_ins += 1

    # ----------------------------------------------------- SGS-set elasticity
    def add_sgs(self, sgs: SemiGlobalScheduler) -> None:
        """Join a new SGS into the live control plane: wire its piggyback
        channel and re-shard the consistent-hash ring incrementally (only
        the new node's key range moves, so existing per-DAG active sets are
        untouched — new DAGs and future scale-outs see the larger set)."""
        if sgs.sgs_id in self.sgss:
            raise ValueError(f"SGS id {sgs.sgs_id} already present")
        self.sgss[sgs.sgs_id] = sgs
        sgs.report = self.report
        self.ring.add_node(sgs.sgs_id)

    def remove_sgs(self, sgs_id: int) -> None:
        """Retire one SGS from the control plane: drop its ring vnodes (its
        key range redistributes minimally) and scrub it from every DAG's
        active/removed sets and piggyback state.  A DAG whose entire active
        set was the retiree is re-homed through the post-removal ring, like
        a fresh DAG.  Removing the last SGS raises."""
        if sgs_id not in self.sgss:
            raise ValueError(f"unknown SGS id {sgs_id}")
        if len(self.sgss) == 1:
            raise ValueError("cannot remove the last SGS")
        self.ring.remove_node(sgs_id)
        del self.sgss[sgs_id]
        for dag_id, st in self._dag_state.items():
            if st.pending:
                st.pending = [p for p in st.pending if p[0] != sgs_id]
            if sgs_id in st.removed:
                st.removed.remove(sgs_id)
            if sgs_id in st.active:
                st.active.remove(sgs_id)
                if not st.active:
                    home = self.ring.lookup(dag_id)
                    st.active.append(home)
                    st.sandbox_count.setdefault(home, 1)
            st.qdelay_ewma.pop(sgs_id, None)
            st.qdelay_samples.pop(sgs_id, None)
            st.sandbox_count.pop(sgs_id, None)

    # -------------------------------------------------------------- failover
    def replace_sgs(self, new_sgs: SemiGlobalScheduler) -> None:
        """SGS failover rewiring (§6.1, ``core.fault.fail_sgs``): swap the
        live instance behind an existing ``sgs_id``.  The consistent-hash
        ring and the per-DAG active/removed lists key on the id, so routing
        re-routes to the replacement with no ring churn — the paper's
        "a replacement instance restores from the store and continues".
        Per-SGS queuing-delay state from the dead instance is dropped (its
        queue died with it); sandbox counts are kept — they describe the
        surviving worker pool, not the dead scheduler process."""
        sid = new_sgs.sgs_id
        self.sgss[sid] = new_sgs
        new_sgs.report = self.report
        for st in self._dag_state.values():
            if st.pending:
                st.pending = [p for p in st.pending if p[0] != sid]
            st.qdelay_ewma.pop(sid, None)
            st.qdelay_samples.pop(sid, None)

    # --------------------------------------------------------------- queries
    def n_active(self, dag_id: str) -> int:
        st = self._dag_state.get(dag_id)
        return len(st.active) if st else 0
