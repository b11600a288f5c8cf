"""The jax-free control-plane pieces the port needs so far, copied from
``src/repro/core``: the core datatypes and continuous batching."""
from .batching import CompletionQueue, ContinuousBatcher, pow2_bucket
from .types import DagSpec, FunctionSpec, Invocation, Request

__all__ = ["CompletionQueue", "ContinuousBatcher", "DagSpec", "FunctionSpec",
           "Invocation", "Request", "pow2_bucket"]
