"""Discrete-event engine, copied from ``src/repro/sim/engine.py``."""
from .engine import SimEnv

__all__ = ["SimEnv"]
