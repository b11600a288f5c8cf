"""Elastic control plane: LBS replica autoscaling from observed load.

The paper argues the LBS is "a scalable service" (§5) but leaves *how many*
replicas to the operator; our xl tier exposed the consequence — at ~26k rps
the default 4 replicas (190us per routing decision ≈ 21k rps of capacity)
saturate, and the benchmark hand-tuned ``n_lbs=16``.  This module replaces
the hand tuning with a feedback controller over the M/D/1 decision clocks:

* **Signal.** Per ``interval``, utilization is measured as
  ``decisions x lb_cost / (replicas x interval)`` (offered decision work
  over pool capacity) plus the worst clock backlog (``busy_until - now`` —
  queueing that has already formed).
* **Scale-out.** When utilization exceeds ``target_utilization`` — or any
  backlog exceeds ``backlog_threshold`` — the pool grows multiplicatively
  to the size that would put the *observed* load at the target
  (``ceil(n x util / target)``), reacting within one interval; flash
  crowds are a doubling or two, not a +1 crawl.
* **Scale-in.** Hysteresis: utilization must sit below
  ``scale_in_utilization`` with zero backlog for ``scale_in_patience``
  consecutive intervals, and actions respect a ``cooldown`` — replicas
  retire one per decision (the most idle clock), so diurnal troughs shed
  capacity without oscillating.

Every decision is recorded as a typed :class:`ScalingEvent`; together with
the per-DAG SGS scaling log (``LoadBalancer.scaling_log``) these flow into
``ExperimentResult.scaling_events`` (lossless JSON round-trip), and
``Metrics.window`` views give during-event latency (docs/SCENARIOS.md).

Copy of ``src/repro/core/autoscale.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional

__all__ = ["AutoscaleConfig", "ScalingEvent", "LBSReplicaAutoscaler",
           "scaling_summary"]


@dataclass(frozen=True)
class AutoscaleConfig:
    """Knobs for the LBS replica autoscaler — carried on
    ``Experiment.autoscale`` (frozen: hashable, picklable, sweepable via
    ``run_sweep`` dotted paths like ``"autoscale.target_utilization"``)."""

    min_replicas: int = 2
    max_replicas: int = 256
    interval: float = 0.1           # observation/decision cadence (s)
    target_utilization: float = 0.6
    scale_in_utilization: float = 0.25
    backlog_threshold: float = 0.01  # seconds of formed queue forcing growth
    cooldown: float = 0.5           # min seconds between scale-ins
    scale_in_patience: int = 5      # consecutive quiet intervals to shrink

    def to_dict(self) -> Dict[str, Any]:
        return {"min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "interval": self.interval,
                "target_utilization": self.target_utilization,
                "scale_in_utilization": self.scale_in_utilization,
                "backlog_threshold": self.backlog_threshold,
                "cooldown": self.cooldown,
                "scale_in_patience": self.scale_in_patience}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "AutoscaleConfig":
        return cls(**dict(d))


@dataclass
class ScalingEvent:
    """One control-plane scaling decision (LBS replica pool or per-DAG SGS
    set), JSON round-trippable through ``to_dict``/``from_dict``."""

    t: float
    component: str                  # "lbs" | "sgs"
    action: str                     # "scale_out" | "scale_in"
    n_before: int
    n_after: int
    metric: float                   # utilization (lbs) / slack-normalized
    #                                 queuing delay (sgs) that triggered it
    detail: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"t": self.t, "component": self.component,
                "action": self.action, "n_before": self.n_before,
                "n_after": self.n_after, "metric": self.metric,
                "detail": dict(self.detail)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ScalingEvent":
        return cls(t=d["t"], component=d["component"], action=d["action"],
                   n_before=d["n_before"], n_after=d["n_after"],
                   metric=d["metric"], detail=dict(d.get("detail", {})))


class LBSReplicaAutoscaler:
    """Grows/shrinks a live list of LBS decision clocks (see module
    docstring for the control law).

    The stack's submit closure round-robins over the *same list object* and
    bumps :attr:`n_routed` per routed request, so the controller observes
    exactly the work the clocks absorbed; ``tick`` mutates the list in
    place.  ``make_clock`` injects the clock type (``_ServiceClock`` — a
    factory argument keeps ``core.autoscale`` import-free of
    ``core.stacks``)."""

    def __init__(self, clocks: List[Any], lb_cost: float,
                 cfg: Optional[AutoscaleConfig] = None, *,
                 make_clock: Callable[[], Any]):
        self.clocks = clocks
        self.lb_cost = lb_cost
        self.cfg = cfg or AutoscaleConfig()
        self.make_clock = make_clock
        self.n_routed = 0               # bumped by the submit hot path
        self.events: List[ScalingEvent] = []
        self._last_action = -math.inf
        self._quiet = 0

    @property
    def n_replicas(self) -> int:
        return len(self.clocks)

    def tick(self, now: float) -> None:
        """One control decision: read the window's routed count, measure
        utilization + backlog, and resize the pool."""
        cfg = self.cfg
        n, self.n_routed = self.n_routed, 0
        clocks = self.clocks
        k = len(clocks)
        util = (n * self.lb_cost) / (k * cfg.interval)
        backlog = max(0.0, max(c.busy_until for c in clocks) - now)
        if ((util > cfg.target_utilization
             or backlog > cfg.backlog_threshold)
                and k < cfg.max_replicas):
            want = max(k + 1, math.ceil(k * util / cfg.target_utilization))
            want = min(cfg.max_replicas, want)
            for _ in range(want - k):
                c = self.make_clock()
                c.busy_until = now      # fresh replica: idle from now
                clocks.append(c)
            self.events.append(ScalingEvent(
                t=round(now, 6), component="lbs", action="scale_out",
                n_before=k, n_after=want, metric=round(util, 6),
                detail={"backlog_s": round(backlog, 6)}))
            self._last_action = now
            self._quiet = 0
        elif (util < cfg.scale_in_utilization and backlog <= 1e-9
                and k > cfg.min_replicas):
            self._quiet += 1
            if (self._quiet >= cfg.scale_in_patience
                    and now - self._last_action >= cfg.cooldown):
                # retire the most idle replica (smallest busy_until)
                idx = min(range(k), key=lambda i: clocks[i].busy_until)
                clocks.pop(idx)
                self.events.append(ScalingEvent(
                    t=round(now, 6), component="lbs", action="scale_in",
                    n_before=k, n_after=k - 1, metric=round(util, 6),
                    detail={}))
                self._last_action = now
                self._quiet = 0
        else:
            self._quiet = 0


def scaling_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Compact per-run digest of an ``ExperimentResult.scaling_events``
    list, for benchmark rows: action counts per component plus the LBS
    replica trajectory's peak/final sizes."""
    out: Dict[str, Any] = {"n_events": len(events)}
    lbs = [e for e in events if e["component"] == "lbs"]
    sgs = [e for e in events if e["component"] == "sgs"]
    out["lbs_scale_outs"] = sum(e["action"] == "scale_out" for e in lbs)
    out["lbs_scale_ins"] = sum(e["action"] == "scale_in" for e in lbs)
    out["sgs_scale_outs"] = sum(e["action"] == "scale_out" for e in sgs)
    out["sgs_scale_ins"] = sum(e["action"] == "scale_in" for e in sgs)
    if lbs:
        out["lbs_peak_replicas"] = max(e["n_after"] for e in lbs)
        out["lbs_final_replicas"] = lbs[-1]["n_after"]
    return out
