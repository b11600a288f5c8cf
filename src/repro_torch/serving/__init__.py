"""Serving data plane of the port: continuous batching on the card."""
from .executor import ContinuousTorchExecutor, ServedModel, batch_seed

__all__ = ["ContinuousTorchExecutor", "ServedModel", "batch_seed"]
