"""Serving substrate of the port: real PyTorch execution beneath the
Archipelago scheduler.

Serving runs route through the experiment API: register apps as a workload
(``serving_workload`` / ``workload_factory="serving_apps"``) and
``simulate`` with ``backend="torch"`` or ``"torch-batched"``.  Exports what
``src/repro/serving/__init__.py`` exports, with the torch executors in place
of the JAX ones, plus the continuous executor and ``batch_seed``.
"""
from .executor import (BatchingTorchExecutor, ContinuousTorchExecutor,
                       ModelInstance, ServedModel, TorchModelExecutor,
                       batch_seed)
from .engine import ServingApp, ServingWorkloadSpec, serving_workload
from .apps import multitenant_apps, smoke_apps

__all__ = ["BatchingTorchExecutor", "ContinuousTorchExecutor",
           "ModelInstance", "ServedModel", "ServingApp",
           "ServingWorkloadSpec", "TorchModelExecutor", "batch_seed",
           "serving_workload", "multitenant_apps", "smoke_apps"]
