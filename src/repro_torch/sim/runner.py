"""Legacy end-to-end simulation drivers — thin shims over the experiment API.

``run_archipelago`` / ``run_baseline`` / ``run_sparrow`` predate the
declarative :mod:`repro_torch.sim.experiment` layer.  They are kept so existing
call sites (and the decision-identity goldens in
``tests/test_equivalence.py``) keep working unchanged, but new code should
build an :class:`~repro_torch.sim.experiment.Experiment` and call
:func:`~repro_torch.sim.experiment.simulate` — same pump loop, richer results,
any registered stack (``repro_torch.core.stacks``) instead of these three, and
access to the sharded parallel core (``Experiment.shards``,
the JAX package's ``sim/shard.py``), which these legacy shims deliberately do not
expose.

Copy of ``src/repro/sim/runner.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

from typing import Optional

from ..core.cluster import ClusterConfig
from ..core.lbs import LBSConfig
from ..core.sgs import SGSConfig
# Re-exported for backward compatibility (these used to live here).
from ..core.stacks import (LB_DECISION_COST, SGS_DECISION_COST,  # noqa: F401
                           _ServiceClock)
from .experiment import (Experiment, SimResult, _arrival_stream,  # noqa: F401
                         _run_experiment, simulate)
from .workload import WorkloadSpec

__all__ = ["SimResult", "run_archipelago", "run_baseline", "run_sparrow",
           "LB_DECISION_COST", "SGS_DECISION_COST"]


def run_archipelago(spec: WorkloadSpec,
                    cluster: Optional[ClusterConfig] = None,
                    sgs_cfg: Optional[SGSConfig] = None,
                    lbs_cfg: Optional[LBSConfig] = None,
                    seed: int = 0,
                    drain: float = 5.0,
                    lb_cost: float = LB_DECISION_COST,
                    sgs_cost: float = SGS_DECISION_COST,
                    n_lbs: int = 4,
                    workload_method: str = "numpy") -> SimResult:
    """Deprecated shim: ``simulate(Experiment(stack="archipelago", ...))``
    minus the result summary (callers here only want the raw SimResult)."""
    _, sim, _, _ = _run_experiment(Experiment(
        stack="archipelago", workload=spec, cluster=cluster, sgs=sgs_cfg,
        lbs=lbs_cfg, params={"n_lbs": n_lbs}, lb_cost=lb_cost,
        sgs_cost=sgs_cost, seed=seed, drain=drain,
        workload_method=workload_method))
    return sim


def run_baseline(spec: WorkloadSpec,
                 cluster: Optional[ClusterConfig] = None,
                 keepalive: float = 900.0,
                 seed: int = 0,
                 drain: float = 5.0,
                 sched_cost: float = SGS_DECISION_COST,
                 workload_method: str = "numpy") -> SimResult:
    """Deprecated shim: ``simulate(Experiment(stack="fifo", ...))``.

    Centralized FIFO + reactive sandboxes + fixed keep-alive (§7.1): the
    single scheduler's per-decision cost is serialized, so at cluster-scale
    RPS it becomes the bottleneck (§2.4), exactly as in the testbed."""
    _, sim, _, _ = _run_experiment(Experiment(
        stack="fifo", workload=spec, cluster=cluster,
        params={"keepalive": keepalive}, sgs_cost=sched_cost, seed=seed,
        drain=drain, workload_method=workload_method))
    return sim


def run_sparrow(spec: WorkloadSpec,
                cluster: Optional[ClusterConfig] = None,
                probes: int = 2,
                seed: int = 0,
                drain: float = 5.0,
                workload_method: str = "numpy") -> SimResult:
    """Deprecated shim: ``simulate(Experiment(stack="sparrow", ...))``."""
    _, sim, _, _ = _run_experiment(Experiment(
        stack="sparrow", workload=spec, cluster=cluster,
        params={"probes": probes}, seed=seed, drain=drain,
        workload_method=workload_method))
    return sim
