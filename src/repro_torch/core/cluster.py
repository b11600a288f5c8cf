"""Cluster partitioning (§4.1): carve a machine set into (SGS, worker pool)
pairs.  "A simple approach we espouse is to organize each rack as a worker
pool with one of the machines running the SGS."

Copy of ``src/repro/core/cluster.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .lbs import LBSConfig, LoadBalancer
from .sandbox import Worker
from .sgs import Env, SGSConfig, SemiGlobalScheduler
from .types import ExecuteFn, SubmitFn


@dataclass
class ClusterConfig:
    n_sgs: int = 8                 # paper testbed: 8 SGSs x 8 workers (§7.1)
    workers_per_sgs: int = 8
    cores_per_worker: int = 20
    # paper machines have 256GB (§7.1); a quarter reserved as proactive pool
    pool_mem_mb: float = 65536.0
    # Placement topology: one rack per SGS pool (§4.1), racks grouped into
    # availability zones.  Worker ids are globally consistent
    # (``wid = sid * workers_per_sgs + j``), so rack/AZ membership is pure
    # arithmetic on the id — the same topology holds for the flat baseline
    # pools, which share the id scheme.
    racks_per_az: int = 4

    @property
    def n_workers(self) -> int:
        return self.n_sgs * self.workers_per_sgs

    @property
    def n_racks(self) -> int:
        return self.n_sgs

    @property
    def n_azs(self) -> int:
        per = max(1, self.racks_per_az)
        return (self.n_sgs + per - 1) // per

    def rack_of(self, worker_id: int) -> int:
        """Rack (== SGS pool id) that hosts ``worker_id``."""
        return worker_id // self.workers_per_sgs

    def az_of(self, worker_id: int) -> int:
        """Availability zone that hosts ``worker_id``."""
        return self.rack_of(worker_id) // max(1, self.racks_per_az)

    def rack_workers(self, rack: int) -> range:
        """Worker ids placed in ``rack``."""
        return range(rack * self.workers_per_sgs,
                     (rack + 1) * self.workers_per_sgs)

    def az_racks(self, az: int) -> range:
        """Rack ids grouped into availability zone ``az``."""
        per = max(1, self.racks_per_az)
        return range(az * per, min((az + 1) * per, self.n_sgs))


def build_sgs_pool(env: Env, cc: ClusterConfig,
                   sgs_cfg: Optional[SGSConfig],
                   sgs_ids: List[int],
                   execute: Optional[ExecuteFn] = None,
                   backend_submit: Optional[SubmitFn] = None
                   ) -> List[SemiGlobalScheduler]:
    """Construct the SGSs named by ``sgs_ids`` (a subset of
    ``range(cc.n_sgs)``), each over its rack-sized worker pool.  Worker ids
    are globally consistent — SGS ``sid`` always owns workers
    ``[sid * workers_per_sgs, (sid+1) * workers_per_sgs)`` — so a sharded
    run (the JAX package's ``sim/shard.py``) building disjoint subsets in separate
    processes assigns exactly the ids a full ``build_cluster`` would."""
    sgss: List[SemiGlobalScheduler] = []
    for sid in sgs_ids:
        wid = sid * cc.workers_per_sgs
        pool = [Worker(worker_id=wid + j, cores=cc.cores_per_worker,
                       pool_mem_mb=cc.pool_mem_mb)
                for j in range(cc.workers_per_sgs)]
        sgss.append(SemiGlobalScheduler(sgs_id=sid, workers=pool, env=env,
                                        config=sgs_cfg, execute=execute,
                                        backend_submit=backend_submit))
    return sgss


def build_cluster(env: Env, cluster: Optional[ClusterConfig] = None,
                  sgs_cfg: Optional[SGSConfig] = None,
                  lbs_cfg: Optional[LBSConfig] = None,
                  execute: Optional[ExecuteFn] = None,
                  backend_submit: Optional[SubmitFn] = None) -> LoadBalancer:
    """Construct the full Archipelago stack: workers -> SGSs -> LBS.

    ``backend_submit`` is the execution backend's asynchronous data-plane
    hook (``core.backends``), threaded uniformly into every SGS;
    ``execute`` is the legacy synchronous hook.  Both ``None`` keeps the
    modeled fast path (invocations charge ``fn.exec_time``)."""
    cc = cluster or ClusterConfig()
    sgss = build_sgs_pool(env, cc, sgs_cfg, list(range(cc.n_sgs)),
                          execute=execute, backend_submit=backend_submit)
    return LoadBalancer(sgss, config=lbs_cfg)


def build_flat_workers(cluster: Optional[ClusterConfig] = None) -> List[Worker]:
    """All workers in one flat pool (for the centralized baselines)."""
    cc = cluster or ClusterConfig()
    n = cc.n_sgs * cc.workers_per_sgs
    return [Worker(worker_id=i, cores=cc.cores_per_worker,
                   pool_mem_mb=cc.pool_mem_mb) for i in range(n)]
