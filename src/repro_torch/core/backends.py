"""Execution backends: *what actually runs an invocation* behind a stack.

Copy of ``src/repro/core/backends.py`` (the port imports nothing of
``repro``), with ``TorchBackend`` / ``BatchedTorchBackend`` in place of
``JaxBackend`` / ``BatchedJaxBackend``.  ``CompletionQueue``,
``BatchCoalescer``, ``ContinuousBatcher`` and ``pow2_bucket`` live in
``core.batching``.

The scheduler stacks (``core.stacks``) decide *where and when* an invocation
runs; an :class:`ExecutionBackend` decides *what executing it means*.  The
same declarative ``Experiment`` drives a purely modeled simulation, a
deterministic scripted stub, or real PyTorch calls on the card whose
measured wall times feed back into scheduling.

Built-ins:

* ``modeled`` (default) — analytic execution: an invocation occupies a core
  for ``fn.exec_time`` seconds.  ``execute`` stays ``None`` so schedulers
  take the exact pre-backend fast path — decision-identical to the
  equivalence goldens by construction.
* ``stub`` — deterministic scripted exec/setup times (CI).
* ``stub-batched`` — the stub seam run through the batching data plane
  (``BatchCoalescer`` or, with ``batching="continuous"``,
  ``ContinuousBatcher``).
* ``torch`` — hardware-in-the-loop: builds the CUDA kernels, calibrates
  every served model (weights + cache + a warm-up + the capture of its
  compiled programs = sandbox setup cost),
  rewrites the workload with *measured* ``FunctionSpec``s, and executes each
  invocation as a real model call (``serving.executor.TorchModelExecutor``).
* ``torch-batched`` — like ``torch`` but concurrently in-flight invocations
  of the same served model coalesce into padded power-of-two batches
  (``serving.executor.BatchingTorchExecutor``); ``batching="continuous"``
  swaps the request window for step-granular continuous batching
  (``ContinuousBatcher`` over ``serving.executor.ContinuousTorchExecutor``).

Where the JAX backends take ``kernels=...``, the torch ones take ``device``
(default ``"cuda"``): the tensors' device picks the implementation, the
hand-written kernels on the card and their plain PyTorch versions on the CPU
(``kernels/ops.py``).  ``data_plane()`` reports ``{"device", "batching"}``.
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Any, Callable, Dict, List, Mapping,
                    Optional, Type, Union)

from ..device import DeviceLike, resolve_device
from .batching import (BatchCoalescer, CompletionQueue, ContinuousBatcher,
                       pow2_bucket)
from .types import (DagSpec, DoneFn, ExecuteFn, FunctionSpec, Invocation,
                    SubmitFn)

if TYPE_CHECKING:   # pragma: no cover - typing only, avoids a core->sim cycle
    from ..serving.executor import ServedModel, TorchModelExecutor
    from ..sim.experiment import Experiment
    from ..sim.workload import WorkloadSpec
    from .sgs import Env

__all__ = [
    "ExecutionBackend", "ModeledBackend", "StubBackend",
    "StubBatchedBackend", "TorchBackend", "BatchedTorchBackend",
    "CompletionQueue", "BatchCoalescer", "ContinuousBatcher",
    "register_backend", "get_backend", "available_backends",
    "resolve_backend", "respec_dag", "respec_workload", "served_model_key",
    "BATCHING_CHOICES",
]

# batching disciplines of the batched data planes
BATCHING_CHOICES = ("windowed", "continuous")


class ExecutionBackend:
    """Base class for execution backends (subclass + ``@register_backend``).

    Lifecycle: ``simulate`` resolves the experiment's backend, calls
    ``build(exp, spec)`` once before the stack is constructed, then
    ``bind(env)`` with the live event loop, and hands the backend to every
    stack's ``build`` — stacks thread ``self.submit`` into their schedulers
    uniformly.

    ``submit`` is the asynchronous data-plane hook
    (``submit(inv, done, delay)``, see ``types.SubmitFn``): the scheduler
    dispatches and keeps running; the backend fires ``done(exec_s)`` at the
    completion instant via ``env.call_after``.  ``None`` means "modeled":
    schedulers charge ``fn.exec_time`` directly with zero per-invocation
    indirection (the simulator hot path, see docs/PERF.md).

    ``execute`` is the legacy *synchronous* hook (``Invocation -> seconds``).
    Backends that only set it keep working: the default ``bind`` wraps it
    into a ``submit`` that runs the hook at dispatch time, with the
    completion event landing at the exact instant and insertion order the
    pre-seam code produced (an unscripted ``stub`` therefore stays
    decision-identical to ``modeled``).  Batched backends instead deliver
    completions through :class:`CompletionQueue` — deterministic ordering,
    ties broken by ``inv_id``.

    ``build`` may also return a re-specced workload (measured or scripted
    ``FunctionSpec``s) — the stack and metrics layers only ever see the
    resolved spec.
    """

    name: str = "base"
    execute: Optional[ExecuteFn] = None
    submit: Optional[SubmitFn] = None
    # times real work on a device: ``run_sweep`` runs such cells one after
    # another, since parallel cells would share the card and skew each
    # other's measured times
    on_device: bool = False

    def build(self, exp: "Experiment", spec: "WorkloadSpec") -> "WorkloadSpec":
        return spec

    def bind(self, env: "Env") -> None:
        """Attach the live event loop for this run (called once per
        ``simulate``, after ``build`` and before the stack is constructed).

        The default adapts a legacy ``execute`` hook to the asynchronous
        seam.  Backends with a native ``submit`` override this to (re)build
        their per-run state — instances are reusable across sweep cells, so
        anything holding an old env must be reconstructed here.
        """
        self.env = env
        if self.execute is not None:
            execute = self.execute
            call_after = env.call_after

            def submit(inv: Invocation, done: DoneFn, delay: float = 0.0
                       ) -> None:
                # legacy hook: runs synchronously at dispatch time; the
                # completion event lands at exactly the instant, insertion
                # point and order the pre-seam code produced, so an
                # unscripted stub stays decision-identical to modeled
                # (batched backends route completions through a
                # CompletionQueue instead — inv_id-ordered, since batch
                # flush timing has no modeled twin to mirror)
                exec_s = execute(inv)
                call_after(delay + exec_s, done, exec_s)

            self.submit = submit

    def counters(self) -> Dict[str, int]:
        return {}

    def data_plane(self) -> Dict[str, str]:
        """Data-plane identity for result rows: which device ran the model
        (``device``; the scripted ``stub-batched`` keeps the JAX package's
        ``kernels: "none"``) and which batching discipline the submit hook
        ran (``batching``).  Empty for modeled backends — there is no data
        plane to identify."""
        return {}


_BACKENDS: Dict[str, Type[ExecutionBackend]] = {}


def register_backend(name: str, *aliases: str
                     ) -> Callable[[Type[ExecutionBackend]],
                                   Type[ExecutionBackend]]:
    """Class decorator: make a backend constructible by name through
    ``Experiment(backend=name)``.  Raises on duplicate registration."""

    def deco(cls: Type[ExecutionBackend]) -> Type[ExecutionBackend]:
        names = (name, *aliases)
        taken = [n for n in names if n in _BACKENDS]
        if taken:       # validate before inserting: no partial registration
            raise ValueError(f"backend {taken[0]!r} is already registered")
        for n in names:
            _BACKENDS[n] = cls
        cls.name = name
        return cls

    return deco


def get_backend(name: str) -> Type[ExecutionBackend]:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered backends: "
            f"{', '.join(sorted(_BACKENDS))}") from None


def available_backends() -> List[str]:
    return sorted(_BACKENDS)


def resolve_backend(backend: Union[str, ExecutionBackend],
                    kwargs: Optional[Mapping[str, Any]] = None
                    ) -> ExecutionBackend:
    """A name constructs a fresh backend from ``kwargs``; a ready instance
    passes through (reuse one ``TorchBackend`` across sweep cells so models
    calibrate once)."""
    if isinstance(backend, str):
        return get_backend(backend)(**dict(kwargs or {}))
    if kwargs:
        raise ValueError(
            "backend_kwargs only apply when `backend` is a name; "
            "configure the instance directly instead")
    return backend


# ---------------------------------------------------------------------------
# Workload re-speccing (shared by stub/torch: swap FunctionSpecs, keep slack)
# ---------------------------------------------------------------------------


def respec_dag(dag: DagSpec, fn_specs: Mapping[str, FunctionSpec],
               slack: Optional[float] = None) -> DagSpec:
    """Copy of ``dag`` with its ``FunctionSpec``s substituted from
    ``fn_specs`` (missing names keep the modeled spec) and the deadline
    re-derived as new-critical-path + slack (default: the slack the original
    DAG granted).  Identity when nothing changes, so a no-op backend stays
    decision-identical to ``modeled``."""
    fns = tuple(fn_specs.get(f.name, f) for f in dag.functions)
    if fns == dag.functions:
        return dag
    if slack is None:
        slack = dag.slack
    return DagSpec(dag_id=dag.dag_id, functions=fns,
                   edges=dag.edges).with_deadline(slack=slack)


def respec_workload(spec: "WorkloadSpec",
                    fn_specs: Mapping[str, FunctionSpec],
                    slacks: Optional[Mapping[str, float]] = None
                    ) -> "WorkloadSpec":
    """``respec_dag`` over every tenant; extra fields of ``WorkloadSpec``
    subclasses (served models, prewarm plans) carry over unchanged."""
    tenants = [(respec_dag(dag, fn_specs,
                           None if slacks is None
                           else slacks.get(dag.dag_id, dag.slack)), proc)
               for dag, proc in spec.tenants]
    return dataclasses.replace(spec, tenants=tenants)


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------


@register_backend("modeled")
class ModeledBackend(ExecutionBackend):
    """Analytic execution (the default): an invocation holds a core for
    ``fn.exec_time`` simulated seconds.  ``execute`` is ``None`` so the
    schedulers' modeled fast path runs unchanged — ``backend="modeled"`` is
    byte-identical to the pre-backend simulator (equivalence goldens)."""


@register_backend("stub")
class StubBackend(ExecutionBackend):
    """Deterministic scripted execution for CI and backend-seam tests.

    ``exec_time`` / ``setup_time`` script the respective ``FunctionSpec``
    fields: a scalar applies to every function, a mapping scripts per
    function name, unset keeps the workload's modeled value.  The hook runs
    through the schedulers' *real-execution* code path (the one ``torch``
    takes) while returning exactly the scripted seconds, so runs are
    reproducible without hardware work.
    """

    def __init__(self, exec_time: Union[float, Mapping[str, float], None] = None,
                 setup_time: Union[float, Mapping[str, float], None] = None):
        self.exec_time = exec_time
        self.setup_time = setup_time
        self.n_executions = 0

    @staticmethod
    def _scripted(table: Union[float, Mapping[str, float], None],
                  name: str, default: float) -> float:
        if table is None:
            return default
        if isinstance(table, Mapping):
            return float(table.get(name, default))
        return float(table)

    def build(self, exp: "Experiment", spec: "WorkloadSpec") -> "WorkloadSpec":
        known = {f.name for dag, _ in spec.tenants for f in dag.functions}
        for label, table in (("exec_time", self.exec_time),
                             ("setup_time", self.setup_time)):
            if isinstance(table, Mapping) and set(table) - known:
                raise ValueError(
                    f"stub {label} scripts unknown function(s) "
                    f"{sorted(set(table) - known)}; workload functions: "
                    f"{', '.join(sorted(known))}")
        fn_specs: Dict[str, FunctionSpec] = {}
        for dag, _ in spec.tenants:
            for f in dag.functions:
                fn_specs[f.name] = FunctionSpec(
                    name=f.name,
                    exec_time=self._scripted(self.exec_time, f.name,
                                             f.exec_time),
                    mem_mb=f.mem_mb,
                    setup_time=self._scripted(self.setup_time, f.name,
                                              f.setup_time))

        def execute(inv) -> float:
            # the scripted time was written into the re-specced FunctionSpec,
            # so the hook replays it: scheduling sees the same number the
            # metrics will, exactly like a calibrated real backend
            self.n_executions += 1
            return inv.fn.exec_time

        self.execute = execute
        return respec_workload(spec, fn_specs)

    def counters(self) -> Dict[str, int]:
        return {"n_executions": self.n_executions}


@register_backend("stub-batched")
class StubBatchedBackend(StubBackend):
    """Scripted times through the *batching* data plane (CI).

    Same scripting knobs as ``stub`` (``exec_time``/``setup_time``), but the
    submit hook is a native :class:`BatchCoalescer`: concurrently in-flight
    invocations of the same function coalesce into one scripted "batch
    execution" of ``exec_time + batch_cost * (bucket - 1)`` seconds (bucket
    = padded power-of-two size; the default ``batch_cost=0`` models perfect
    batching).  Deterministically exercises window/bucket coalescing, batch
    occupancy counters, and inv_id-ordered completions without hardware.
    """

    def __init__(self,
                 exec_time: Union[float, Mapping[str, float], None] = None,
                 setup_time: Union[float, Mapping[str, float], None] = None,
                 batch_window: float = 0.005, max_batch: int = 8,
                 batch_cost: float = 0.0, batching: str = "windowed",
                 n_steps: int = 4):
        super().__init__(exec_time, setup_time)
        if batching not in BATCHING_CHOICES:
            raise ValueError(f"batching must be one of {BATCHING_CHOICES}, "
                             f"got {batching!r}")
        if n_steps < 0:
            raise ValueError(f"n_steps must be >= 0, got {n_steps}")
        self.batch_window = batch_window
        self.max_batch = max_batch
        self.batch_cost = batch_cost
        self.batching = batching
        self.n_steps = n_steps
        self._coalescer: Optional[BatchCoalescer] = None
        self._batcher: Optional[ContinuousBatcher] = None
        self._fn_exec: Dict[str, float] = {}

    def build(self, exp: "Experiment", spec: "WorkloadSpec") -> "WorkloadSpec":
        spec = super().build(exp, spec)
        # scripted per-function exec times, addressable by name (the
        # continuous hooks receive fn_name, not an Invocation)
        self._fn_exec = {f.name: f.exec_time
                         for dag, _ in spec.tenants for f in dag.functions}
        self.execute = None     # native async submit: skip the legacy adapter
        return spec

    def bind(self, env: "Env") -> None:
        self.env = env
        if self.batching == "continuous":
            # scripted continuous twin: a lone request still costs exactly
            # exec_time (half in the admitting prefill, half spread over
            # n_steps decode ticks), so windowed/continuous stub runs are
            # directly comparable; batch_cost charges padded-slot overhead
            # per tick just like the windowed script does per batch
            def admit(fn_name: str, invs: List[Invocation],
                      slots: List[int]) -> float:
                self.n_executions += 1
                bucket = pow2_bucket(len(slots))
                return (self._fn_exec[fn_name] * 0.5
                        + self.batch_cost * (bucket - 1))

            def step(fn_name: str, slots: List[int]) -> float:
                self.n_executions += 1
                bucket = pow2_bucket(len(slots))
                per_step = self._fn_exec[fn_name] * 0.5 / max(1, self.n_steps)
                return per_step + self.batch_cost * (bucket - 1)

            self._batcher = ContinuousBatcher(env, admit, step,
                                              lambda fn: self.n_steps,
                                              max_batch=self.max_batch)
            self.submit = self._batcher.submit
            self._coalescer = None
            return

        def run_batch(fn_name: str, invs: List[Invocation]) -> float:
            self.n_executions += 1
            bucket = pow2_bucket(len(invs))
            return invs[0].fn.exec_time + self.batch_cost * (bucket - 1)

        self._coalescer = BatchCoalescer(env, run_batch,
                                         batch_window=self.batch_window,
                                         max_batch=self.max_batch)
        self.submit = self._coalescer.submit
        self._batcher = None

    def drop_invocations(self, inv_ids: List[int]) -> None:
        """Dead-member release (core.fault worker crash): purge the crashed
        worker's in-flight members from whichever data plane is bound."""
        if self._batcher is not None:
            self._batcher.drop(inv_ids)
        elif self._coalescer is not None:
            self._coalescer.drop(inv_ids)

    def counters(self) -> Dict[str, int]:
        c = dict(super().counters())
        if self._coalescer is not None:
            c.update(self._coalescer.counters())
        if self._batcher is not None:
            c.update(self._batcher.counters())
        return c

    def data_plane(self) -> Dict[str, str]:
        return {"kernels": "none", "batching": self.batching}


def served_model_key(served: Mapping[str, "ServedModel"]) -> tuple:
    """Content-based calibration-cache key for a served-model set.

    Keys on what determines the measured times (config identity + shapes +
    batch), NOT on ``id(m)``: object ids can be reused after a
    ``ServedModel`` is garbage-collected, which would false-hit the cache
    and serve stale calibration for a different model.  (The JAX package's
    key also holds the config's ``kernels``; here a backend's device is
    fixed for its lifetime.)
    """
    return tuple(sorted(
        (name, m.cfg.name, m.cfg.arch_type, m.cfg.n_layers, m.cfg.d_model,
         m.prompt_len, m.gen_len, m.batch)
        for name, m in served.items()))


@register_backend("torch")
class TorchBackend(ExecutionBackend):
    """Hardware-in-the-loop: real PyTorch execution under the schedulers.

    Needs served models: either the workload is a serving workload
    (``serving.engine.serving_workload`` attaches ``spec.served``) or
    ``served={fn_name: ServedModel}`` is passed directly.  ``build``
    calibrates each model (kernel build, then weights + cache + a warm-up,
    the capture of its compiled programs and timed runs — the measured sandbox setup/exec costs become the
    ``FunctionSpec``s, so every scheduling decision operates on real
    numbers) and the execute hook runs the actual model per invocation.
    Calibration is cached per served-model set (``served_model_key``): pass
    one ``TorchBackend`` instance across sweep cells to calibrate once.

    ``device`` (default ``"cuda"``) is where the models run; without CUDA
    the default raises, and ``device="cpu"`` runs the plain PyTorch versions
    of the kernels.
    """

    on_device = True

    def __init__(self, served: Optional[Mapping[str, "ServedModel"]] = None,
                 mem_mb: float = 512.0, calib_runs: int = 3,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.served = served
        self.mem_mb = mem_mb
        self.calib_runs = calib_runs
        self.executor: Optional["TorchModelExecutor"] = None
        self.fn_specs: Optional[Dict[str, FunctionSpec]] = None
        self._calibrated_key: Optional[tuple] = None

    def _resolve_served(self, spec: "WorkloadSpec"
                        ) -> Mapping[str, "ServedModel"]:
        served = self.served if self.served is not None \
            else getattr(spec, "served", None)
        if not served:
            raise ValueError(
                f'backend="{self.name}" needs served models: use a serving '
                'workload (repro_torch.serving.engine.serving_workload) or '
                'pass backend_kwargs=dict(served={fn_name: ServedModel})')
        return served

    def _make_executor(self, served: Mapping[str, "ServedModel"]):
        from ..serving.executor import TorchModelExecutor  # lazy: core->serving
        return TorchModelExecutor(dict(served), device=self.device)

    def build(self, exp: "Experiment", spec: "WorkloadSpec") -> "WorkloadSpec":
        served = self._resolve_served(spec)
        key = served_model_key(served)
        if self.executor is None or self._calibrated_key != key:
            self.executor = self._make_executor(served)
            self.fn_specs = self.executor.calibrate(mem_mb=self.mem_mb,
                                                    runs=self.calib_runs)
            self._calibrated_key = key
        # the batching executors have no per-invocation hook; the subclass
        # installs a native async submit in bind() instead
        self.execute = getattr(self.executor, "execute", None)
        return respec_workload(spec, self.fn_specs,
                               getattr(spec, "slacks", None))

    def counters(self) -> Dict[str, int]:
        n = self.executor.n_executions if self.executor is not None else 0
        return {"n_executions": n}

    def data_plane(self) -> Dict[str, str]:
        return {"device": self.device.type, "batching": "none"}


@register_backend("torch-batched")
class BatchedTorchBackend(TorchBackend):
    """Hardware-in-the-loop with a *batched* data plane.

    Like ``torch``, but concurrently in-flight invocations of the same
    ``ServedModel`` share the card: ``batching="windowed"`` coalesces them
    (``BatchCoalescer``: ``batch_window`` sim seconds / ``max_batch`` size)
    into ONE padded batched execution per power-of-two bucket
    (``BatchingTorchExecutor``, every bucket calibrated up front);
    ``batching="continuous"`` lets requests join and leave a running batch
    at decode-step boundaries (``ContinuousBatcher`` over
    ``ContinuousTorchExecutor``, whose vacated cache slots are scrubbed
    through ``release_slots``).

    ``batch_window``, ``max_batch`` and ``batching`` are ordinary sweepable
    ``backend_kwargs``.  Calibration is cached on the content key
    (``served_model_key``); pass one instance across sweep cells to
    calibrate once.
    """

    def __init__(self, served: Optional[Mapping[str, "ServedModel"]] = None,
                 mem_mb: float = 512.0, calib_runs: int = 3,
                 batch_window: float = 0.005, max_batch: int = 8,
                 batching: str = "windowed", device: DeviceLike = "cuda"):
        super().__init__(served, mem_mb=mem_mb, calib_runs=calib_runs,
                         device=device)
        if batching not in BATCHING_CHOICES:
            raise ValueError(f"batching must be one of {BATCHING_CHOICES}, "
                             f"got {batching!r}")
        self.batch_window = batch_window
        self.max_batch = max_batch
        self.batching = batching
        self._coalescer: Optional[BatchCoalescer] = None
        self._batcher: Optional[ContinuousBatcher] = None

    def _make_executor(self, served: Mapping[str, "ServedModel"]):
        from ..serving.executor import (BatchingTorchExecutor,  # lazy
                                        ContinuousTorchExecutor)
        cls = (ContinuousTorchExecutor if self.batching == "continuous"
               else BatchingTorchExecutor)
        return cls(dict(served), max_batch=self.max_batch, device=self.device)

    def bind(self, env: "Env") -> None:
        self.env = env
        if self.batching == "continuous":
            ex = self.executor
            self._batcher = ContinuousBatcher(
                env, ex.admit, ex.step, ex.gen_steps,
                max_batch=self.max_batch,
                release=getattr(ex, "release_slots", None))
            self.submit = self._batcher.submit
            self._coalescer = None
            return
        self._coalescer = BatchCoalescer(env, self.executor.run_batch,
                                         batch_window=self.batch_window,
                                         max_batch=self.max_batch)
        self.submit = self._coalescer.submit
        self._batcher = None

    def drop_invocations(self, inv_ids: List[int]) -> None:
        """Dead-member release (core.fault worker crash): purge the crashed
        worker's in-flight members from whichever data plane is bound.  For
        the continuous plane the freed cache slots are scrubbed in the
        executor's slot slab via ``release_slots``."""
        if self._batcher is not None:
            self._batcher.drop(inv_ids)
        elif self._coalescer is not None:
            self._coalescer.drop(inv_ids)

    def counters(self) -> Dict[str, int]:
        c = dict(super().counters())
        if self._coalescer is not None:
            c.update(self._coalescer.counters())
        if self._batcher is not None:
            c.update(self._batcher.counters())
        return c

    def data_plane(self) -> Dict[str, str]:
        return {"device": self.device.type, "batching": self.batching}
