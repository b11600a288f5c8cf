"""Discrete-event simulation substrate of the port.

Copy of ``src/repro/sim/__init__.py`` (the port imports nothing of
``repro``), exporting the same names.
"""
from .engine import SimEnv
from .workload import (ArrivalProcess, BurstRate, ConstantRate, DiurnalRate,
                       OnOffRate, PoissonResampled, ScaledRate, Sinusoidal,
                       WindowedRate, WorkloadSpec, make_paper_dag,
                       paper_workload_1, paper_workload_2)
from .metrics import Metrics, summarize
from .traffic import (TrafficSpec, apply_traffic, available_traffic,
                      get_traffic, register_traffic, scenario)
from .experiment import (ClassStats, Experiment, ExperimentResult, SimResult,
                         SweepResult, available_workloads,
                         get_workload_factory, register_workload, run_sweep,
                         simulate)
from .runner import run_archipelago, run_baseline, run_sparrow

__all__ = [
    "SimEnv", "ArrivalProcess", "ConstantRate", "OnOffRate",
    "PoissonResampled", "Sinusoidal", "WorkloadSpec", "make_paper_dag",
    "ScaledRate", "DiurnalRate", "BurstRate", "WindowedRate",
    "paper_workload_1", "paper_workload_2", "Metrics", "summarize",
    "TrafficSpec", "scenario", "apply_traffic",
    "register_traffic", "get_traffic", "available_traffic",
    "ClassStats", "Experiment", "ExperimentResult", "SimResult",
    "SweepResult", "run_sweep", "simulate",
    "register_workload", "get_workload_factory", "available_workloads",
    "run_archipelago", "run_baseline", "run_sparrow",
]
