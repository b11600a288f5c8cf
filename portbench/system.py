"""The system under test, wired to the benchmark's inputs.

``experiment`` and ``backend`` build one cell's window on the program's
main path: ``simulate(Experiment(stack="archipelago", backend=<continuous
torch-batched>))`` → ``ContinuousBatcher`` → ``ContinuousTorchExecutor``
→ ``models.prefill`` / ``decode_step_ragged`` → ``kernels.ops``.  Four
thin subclasses hand the program what the benchmark made and note what
the program did, without changing what it runs:

* ``FixedArrivals`` gives the scheduler the benchmark's arrival instants;
* ``UploadedEverywhere`` uploads the DAG to every SGS of the cluster with
  the mix's proactive sandboxes (``prewarm_per_fn``), ahead of the first
  request (``traffic.UPLOAD_S``): a tenant's steady state, where the
  program's own upload warms one SGS and a scale-out's first requests to
  the other wait out cold starts;
* ``BenchExecutor`` draws the weights into the program's parameter tensors
  after its set-up, hands each join the benchmark's prompts (its public
  ``prompt_tokens``), and records every join and step of the window: the
  instant on the system's clock, the slots and requests, the seconds the
  program measured, the tokens it produced (a device-side copy, read
  after the window) and whether a profiled slice was open;
* ``BenchBackend`` makes that executor and gives every DAG the mix's
  fixed latency limit as its deadline after the program's calibration, so
  that neither the scheduler's deadline-aware decisions nor the judged
  metric move with one run's calibration.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import BatchedTorchBackend, ClusterConfig
from repro_torch.serving import (ContinuousTorchExecutor, ServedModel,
                                 ServingApp, ServingWorkloadSpec,
                                 serving_workload)
from repro_torch.sim import ArrivalProcess, Experiment, simulate

from . import traffic as gen
from . import weights as wts

DRAIN_S = 60.0   # system-clock seconds after the schedule to drain it


class FixedArrivals(ArrivalProcess):
    """The benchmark's arrival instants, whatever generator is passed."""

    def __init__(self, times: np.ndarray):
        self.times = np.asarray(times, dtype=np.float64)

    def rate(self, t: float) -> float:
        span = float(self.times[-1]) if len(self.times) else 0.0
        return len(self.times) / span if span > 0 else 0.0

    def max_rate(self, t_end: float) -> float:
        return self.rate(0.0)

    def generate_np(self, t_end, rng):
        return self.times[self.times < t_end].copy()

    def generate(self, t_end, rng, dt=0.01):
        return self.generate_np(t_end, None).tolist()


@dataclasses.dataclass
class UploadedEverywhere(ServingWorkloadSpec):

    def pre_pump(self, env, stack) -> None:
        for dag, _ in self.tenants:
            for sgs in stack.lbs.sgss.values():
                sgs.preallocate(dag, self.prewarm.get(dag.dag_id, 0))


@dataclasses.dataclass
class Event:
    kind: str                   # "join" | "step"
    t: float                    # dispatch instant, system's clock (s)
    slots: Tuple[int, ...]
    rows: Tuple[int, ...]       # requests joining (joins only)
    seconds: float              # what the program measured
    in_slice: bool              # a profiled slice was open
    wall: float = 0.0           # the call's start on the host's clock (s)


class BenchExecutor(ContinuousTorchExecutor):

    def __init__(self, served: Dict[str, ServedModel], *, max_batch: int,
                 device: torch.device, leaves: List[tuple], weight_seed: int,
                 prompts: np.ndarray, calib_prompts: np.ndarray):
        super().__init__(served, max_batch=max_batch, device=device)
        self.leaves = leaves
        self.weight_seed = weight_seed
        self.prompts = prompts
        self.calib_prompts = calib_prompts
        self.env = None
        self.recording = False
        self.in_slice = False
        self.events: List[Event] = []
        self.tokens: List[torch.Tensor] = []     # st.tok after each event
        self._joining: Optional[Tuple[int, ...]] = None

    def _setup(self, fn_name: str):
        st = super()._setup(fn_name)
        wts.fill(self.leaves, self.weight_seed, self.device, into=st.params)
        return st

    def prompt_tokens(self, fn_name: str, ids: List[int],
                      n: int) -> np.ndarray:
        if self._joining is not None:
            return self.prompts[list(self._joining)]
        return self.calib_prompts[:n]

    def _note(self, kind, t, wall, fn_name, slots, rows, seconds) -> None:
        self.events.append(Event(kind, t, tuple(slots), tuple(rows),
                                 seconds, self.in_slice, wall))
        self.tokens.append(self._state[fn_name].tok[:, 0].clone())

    def admit(self, fn_name, invs, slots) -> float:
        if not self.recording:
            return super().admit(fn_name, invs, slots)
        t, wall = self.env.now(), time.perf_counter()
        self._joining = tuple(inv.request.m_idx for inv in invs)
        try:
            dur = super().admit(fn_name, invs, slots)
        finally:
            rows, self._joining = self._joining, None
        self._note("join", t, wall, fn_name, slots, rows, dur)
        return dur

    def step(self, fn_name, slots) -> float:
        if not self.recording:
            return super().step(fn_name, slots)
        t, wall = self.env.now(), time.perf_counter()
        dur = super().step(fn_name, slots)
        self._note("step", t, wall, fn_name, slots, (), dur)
        return dur

    def served_tokens(self, n_rows: int, per_request: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """The first ``per_request`` tokens each request was served
        (n_rows, per_request; -1 where it got fewer) and how many it got,
        from the recorded events."""
        out = np.full((n_rows, per_request), -1, dtype=np.int64)
        got = np.zeros(n_rows, dtype=np.int64)
        if not self.events:
            return out, got
        toks = torch.stack(self.tokens).cpu().numpy()
        owner: Dict[int, int] = {}
        for e, tok in zip(self.events, toks):
            if e.kind == "join":
                owner.update(zip(e.slots, e.rows))
            for s in e.slots:
                r = owner[s]
                if got[r] < per_request:
                    out[r, got[r]] = tok[s]
                got[r] += 1
        return out, got


class BenchBackend(BatchedTorchBackend):

    def __init__(self, limit_s: float,
                 make_executor: Callable[[Dict[str, ServedModel]], Any],
                 **kw):
        super().__init__(**kw)
        self.limit_s = limit_s
        self.make_executor = make_executor

    def _make_executor(self, served):
        return self.make_executor(served)

    def build(self, exp, spec):
        spec = super().build(exp, spec)
        return dataclasses.replace(spec, tenants=[
            (dag.with_deadline(deadline=self.limit_s), proc)
            for dag, proc in spec.tenants])

    def bind(self, env) -> None:
        super().bind(env)
        self.executor.env = env


def experiment(cfg, traffic: Dict[str, Any], times: np.ndarray,
               backend: BenchBackend, seconds: float) -> Experiment:
    """The cell's experiment: one app serving one function at the mix's
    lengths, the benchmark's arrivals, the mix's cluster."""
    served = ServedModel(cfg, prompt_len=int(traffic["prompt_len"]),
                         gen_len=int(traffic["gen_len"]))
    app = ServingApp(traffic["app"], {traffic["function"]: served},
                     slack=float(traffic["slack_s"]))
    spec = serving_workload(
        [app], duration=gen.UPLOAD_S + seconds,
        arrivals={traffic["app"]: FixedArrivals(times)},
        prewarm_per_fn=int(traffic["prewarm_per_fn"]))
    spec = UploadedEverywhere(**{f.name: getattr(spec, f.name)
                                 for f in dataclasses.fields(spec)})
    return Experiment(stack="archipelago", backend=backend, workload=spec,
                      cluster=ClusterConfig(**traffic["cluster"]),
                      warmup=0.0, drain=DRAIN_S)


def backend(cfg, traffic: Dict[str, Any], device: torch.device,
            leaves: List[tuple], weight_seed: int, prompts: np.ndarray,
            calib_prompts: np.ndarray) -> BenchBackend:
    max_batch = int(traffic["max_batch"])

    def make(served):
        return BenchExecutor(served, max_batch=max_batch, device=device,
                             leaves=leaves, weight_seed=weight_seed,
                             prompts=prompts, calib_prompts=calib_prompts)

    return BenchBackend(float(traffic["limit_ms"]) / 1e3, make,
                        max_batch=max_batch, batching="continuous",
                        mem_mb=float(traffic["mem_mb"]), device=device)
