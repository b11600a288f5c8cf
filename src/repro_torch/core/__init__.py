"""Archipelago core of the port: the paper's control plane as a library.

Copy of ``src/repro/core/__init__.py`` (the port imports nothing of
``repro``), exporting the same names, with ``TorchBackend`` /
``BatchedTorchBackend`` (registered as ``torch`` / ``torch-batched``) in
place of ``JaxBackend`` / ``BatchedJaxBackend``.

Public API:
    FunctionSpec, DagSpec, Request        -- workload model
    SemiGlobalScheduler, SGSConfig        -- deadline-aware SRSF scheduler
    LoadBalancer, LBSConfig               -- sandbox-aware routing + scaling
    DemandEstimator, poisson_ppf          -- proactive demand estimation
    SandboxManager, Worker                -- even placement, soft/hard evict
    CentralizedFIFO, SparrowScheduler     -- paper baselines
    build_cluster, ClusterConfig          -- one-call stack construction
    register_stack, get_stack, Stack      -- pluggable scheduler-stack registry
    register_backend, ExecutionBackend    -- pluggable execution backends:
                                             modeled / stub / torch
    FaultPlan, register_fault, fail_sgs   -- declarative chaos injection +
                                             §6.1 failover
    AutoscaleConfig, LBSReplicaAutoscaler -- elastic LBS replica pool
"""
from .types import (DagSpec, FunctionSpec, Invocation, Request, Sandbox,
                    SandboxState)
from .estimator import DemandEstimator, RateEstimator, poisson_ppf
from .sandbox import SandboxManager, Worker
from .sgs import Env, SGSConfig, SemiGlobalScheduler
from .lbs import ConsistentHashRing, LBSConfig, LoadBalancer
from .baselines import CentralizedFIFO, SparrowScheduler
from .cluster import ClusterConfig, build_cluster, build_flat_workers
from .batching import pow2_bucket
from .backends import (BatchCoalescer, BatchedTorchBackend, CompletionQueue,
                       ContinuousBatcher, ExecutionBackend, ModeledBackend,
                       StubBackend, StubBatchedBackend, TorchBackend,
                       available_backends, get_backend, register_backend)
from .stacks import (Stack, available_stacks, get_stack, register_stack)
from .autoscale import (AutoscaleConfig, LBSReplicaAutoscaler, ScalingEvent,
                        scaling_summary)
from .fault import (FaultContext, FaultEvent, FaultInjector, FaultPlan,
                    StateStore, available_faults, checkpoint_lbs,
                    checkpoint_sgs, control_plane_delay, fail_sgs,
                    fail_worker, get_fault, mass_eviction, recovery_summary,
                    register_fault, restore_lbs, restore_sgs, sgs_failstop,
                    time_to_recovery, worker_crash)

__all__ = [
    "DagSpec", "FunctionSpec", "Invocation", "Request", "Sandbox",
    "SandboxState", "DemandEstimator", "RateEstimator", "poisson_ppf",
    "SandboxManager", "Worker", "Env", "SGSConfig", "SemiGlobalScheduler",
    "ConsistentHashRing", "LBSConfig", "LoadBalancer", "CentralizedFIFO",
    "SparrowScheduler", "ClusterConfig", "build_cluster", "build_flat_workers",
    "Stack", "available_stacks", "get_stack", "register_stack",
    "ExecutionBackend", "ModeledBackend", "StubBackend", "StubBatchedBackend",
    "TorchBackend", "BatchedTorchBackend", "BatchCoalescer", "CompletionQueue",
    "ContinuousBatcher", "pow2_bucket",
    "available_backends", "get_backend", "register_backend",
    "StateStore", "checkpoint_lbs", "checkpoint_sgs", "fail_worker",
    "restore_lbs", "restore_sgs", "fail_sgs",
    "FaultPlan", "FaultEvent", "FaultInjector", "FaultContext",
    "worker_crash", "sgs_failstop", "mass_eviction", "control_plane_delay",
    "register_fault", "get_fault", "available_faults",
    "time_to_recovery", "recovery_summary",
    "AutoscaleConfig", "ScalingEvent", "LBSReplicaAutoscaler",
    "scaling_summary",
]
