"""Real PyTorch execution beneath the sandbox abstraction.

Port of ``src/repro/serving/executor.py``: ``batch_seed``, ``ServedModel``,
the per-invocation data plane (``ModelInstance``, ``TorchModelExecutor``),
the windowed one (``BatchingTorchExecutor``) and the continuous one
(``ContinuousTorchExecutor``).

A *model instance* is the GPU-serving analogue of the paper's sandbox:
resident weights + a KV/SSM cache on the device, warmed up by one prefill
and one decode step.  Its measured set-up time is what a cold start costs
the scheduler.  Where the JAX package compiles executables at set-up, the
port runs eagerly, and its one build step, ``nvcc`` for the CUDA kernels,
happens once per executor before any instance is set up
(``build_seconds``), so that it never becomes a sandbox's modeled cold
start.

Prompts come from numpy seeded by the invocation (``inv_id``) or by
``batch_seed`` of the member set (``jax.random`` cannot be replayed here).
Each executor draws them apart from the model call (``run_tokens``,
``_admit_tokens``) so tests can feed both packages the same tokens.

``ContinuousTorchExecutor`` keeps the JAX executor's surface (``admit``,
``step``, ``gen_steps``, ``release_slots``, ``calibrate``, ``buckets``,
``bucket_admit_s``, ``bucket_step_s``, ``n_executions``).  Where the JAX
executor compiles one executable per bucket, this one runs eagerly; its
set-up runs every bucket once, so no first launch lands on the serving
path.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, replace
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.batching import pow2_bucket
from ..core.types import FunctionSpec, Invocation
from ..device import DeviceLike, resolve_device
from ..kernels import _build
from ..models import (decode_step, decode_step_ragged, init_cache,
                      init_params, prefill)
from ..models.config import ModelConfig


def batch_seed(inv_ids: Iterable[int]) -> int:
    """Deterministic, order-INDEPENDENT seed for a batched execution.

    The member set alone determines the seed: coalescing order (which
    depends on flush timing) must not change what the batch computes."""
    data = b"".join(i.to_bytes(8, "little")
                    for i in sorted(int(i) for i in inv_ids))
    return zlib.crc32(data)


@dataclass
class ServedModel:
    """What a 'function' computes: prefill `prompt_len` tokens, then decode
    `gen_len` tokens, at batch size `batch`."""

    cfg: ModelConfig
    prompt_len: int = 64
    gen_len: int = 8
    batch: int = 1


def build_kernels(device: torch.device) -> float:
    """Build the CUDA kernels (once per checkout) before a model on
    ``device`` is set up; returns the wall seconds it took, 0 when built
    already or off the card."""
    return _build.build() if device.type == "cuda" else 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pow2_buckets(max_batch: int) -> List[int]:
    """The power-of-two batch sizes a batched executor runs: 1, 2, 4, ...,
    up to the smallest power of two covering ``max_batch``."""
    return [1 << i for i in range(pow2_bucket(max_batch).bit_length())]


def prompt_tokens(served: ServedModel, seed: int, n: int) -> np.ndarray:
    """The (n, prompt_len) prompt of an execution seeded by ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, served.cfg.vocab_size, (n, served.prompt_len))


@dataclass
class ModelInstance:
    """A warm sandbox: weights + cache on the device, warmed up.

    ``params`` may be given (shared by the buckets of one function, or
    carried over from the JAX package by ``models.params_from_numpy``); the
    instance then skips the weight init."""

    served: ServedModel
    device: torch.device
    params: Any = None
    cache: Any = None
    setup_seconds: float = 0.0
    last_tokens: Optional[torch.Tensor] = None   # (batch, gen_len + 1)

    def setup(self, seed: int = 0) -> float:
        """Weights (unless given), the cache, and one warm-up prefill +
        decode step.  Returns real wall time (the sandbox setup overhead
        that Archipelago moves off the critical path)."""
        t0 = time.perf_counter()
        sm = self.served
        if self.params is None:
            self.params = init_params(sm.cfg, seed, self.device)
        self.cache = init_cache(sm.cfg, sm.batch, sm.prompt_len + sm.gen_len,
                                self.device)
        tokens = torch.zeros((sm.batch, sm.prompt_len), dtype=torch.long,
                             device=self.device)
        prefill(sm.cfg, self.params, tokens, self.cache)
        decode_step(sm.cfg, self.params, self.cache,
                    torch.zeros((sm.batch, 1), dtype=torch.long,
                                device=self.device), sm.prompt_len)
        _sync(self.device)
        self.setup_seconds = time.perf_counter() - t0
        return self.setup_seconds

    def run(self, seed: int = 0) -> float:
        """One request: prefill + gen_len greedy decode steps on a prompt
        seeded by ``seed``.  Returns measured wall seconds."""
        return self.run_tokens(prompt_tokens(self.served, seed,
                                             self.served.batch))

    def run_tokens(self, tokens: np.ndarray) -> float:
        """Prefill ``tokens`` (batch, prompt_len), then decode gen_len
        greedy tokens; ``last_tokens`` keeps the first sampled token and the
        decoded ones.  Returns measured wall seconds.  Every cache position
        a step reads was written in this run, so the cache is reused."""
        sm = self.served
        t0 = time.perf_counter()
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)
        out = torch.empty((sm.batch, sm.gen_len + 1), dtype=torch.int32,
                          device=self.device)
        logits, _ = prefill(sm.cfg, self.params, toks, self.cache)
        tok = torch.argmax(logits, dim=-1)                      # (B, 1)
        out[:, :1] = tok
        for i in range(sm.gen_len):
            logits, _ = decode_step(sm.cfg, self.params, self.cache, tok,
                                    sm.prompt_len + i)
            tok = torch.argmax(logits, dim=-1)
            out[:, i + 1:i + 2] = tok
        _sync(self.device)
        self.last_tokens = out
        return time.perf_counter() - t0


class TorchModelExecutor:
    """Maps function names -> model instances; measures real setup/exec.

    Used two ways:
      * ``calibrate()`` produces FunctionSpecs whose exec_time / setup_time
        are *measured*, so the scheduler operates on real numbers.
      * as the SGS ``execute`` hook, it runs the actual model per invocation.
    Runs on the card unless ``device`` names another.
    """

    def __init__(self, served: Dict[str, ServedModel],
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.served = served
        self._instances: Dict[str, ModelInstance] = {}
        self.build_seconds = 0.0
        self.n_executions = 0

    def ensure_instance(self, fn_name: str) -> ModelInstance:
        inst = self._instances.get(fn_name)
        if inst is None:
            self.build_seconds += build_kernels(self.device)
            inst = ModelInstance(self.served[fn_name], self.device)
            inst.setup()
            self._instances[fn_name] = inst
        return inst

    def calibrate(self, mem_mb: float = 512.0,
                  runs: int = 3) -> Dict[str, FunctionSpec]:
        """Measure setup + exec time per function; build real FunctionSpecs."""
        specs = {}
        for name in self.served:
            inst = self.ensure_instance(name)
            times = [inst.run(seed=i) for i in range(runs)]
            specs[name] = FunctionSpec(
                name=name, exec_time=sorted(times)[len(times) // 2],
                mem_mb=mem_mb, setup_time=inst.setup_seconds)
        return specs

    def execute(self, inv: Invocation) -> float:
        """SGS execute hook: run the real model for this invocation."""
        inst = self.ensure_instance(inv.fn.name)
        self.n_executions += 1
        return inst.run(seed=inv.inv_id)


class BatchingTorchExecutor:
    """Batched data plane: pads concurrently in-flight invocations of the
    same ``ServedModel`` into one real batched execution.

    A *bucket* is a power-of-two batch size; each bucket gets its own
    instance (cache at that batch), all set up and timed in ``calibrate``,
    off the serving path; the buckets of one function share its weights.
    At run time the coalescer (``core.batching.BatchCoalescer``) calls
    ``run_batch`` with the gathered invocations; the batch executes once at
    the smallest bucket that fits and every member shares the measured wall
    time.  Each invocation occupies one batch slot (one sequence): the
    bucket size *replaces* the ``ServedModel.batch`` dimension.
    """

    def __init__(self, served: Dict[str, ServedModel], max_batch: int = 8,
                 device: DeviceLike = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self.served = served
        self.max_batch = max_batch
        self._instances: Dict[Tuple[str, int], ModelInstance] = {}
        # calibration medians per (fn_name, bucket) — measured batched
        # execution seconds, recorded for reporting/analysis
        self.bucket_exec_s: Dict[Tuple[str, int], float] = {}
        self.build_seconds = 0.0
        self.n_executions = 0           # real batched runs

    def buckets(self) -> List[int]:
        return pow2_buckets(self.max_batch)

    def ensure_instance(self, fn_name: str, bucket: int) -> ModelInstance:
        key = (fn_name, bucket)
        inst = self._instances.get(key)
        if inst is None:
            self.build_seconds += build_kernels(self.device)
            shared = next((i.params for (f, _), i in self._instances.items()
                           if f == fn_name), None)
            inst = ModelInstance(replace(self.served[fn_name], batch=bucket),
                                 self.device, params=shared)
            inst.setup()
            self._instances[key] = inst
        return inst

    def calibrate(self, mem_mb: float = 512.0,
                  runs: int = 3) -> Dict[str, FunctionSpec]:
        """Set up EVERY bucket per function and measure each bucket's
        batched execution time.  The returned ``FunctionSpec``s carry the
        batch-1 numbers — what a single invocation costs unbatched — so
        scheduling stays comparable with the per-invocation ``torch``
        backend; per-bucket medians live in ``bucket_exec_s``."""
        specs = {}
        for name in self.served:
            for b in self.buckets():
                inst = self.ensure_instance(name, b)
                times = [inst.run(seed=i) for i in range(runs)]
                self.bucket_exec_s[(name, b)] = sorted(times)[len(times) // 2]
            specs[name] = FunctionSpec(
                name=name, exec_time=self.bucket_exec_s[(name, 1)],
                mem_mb=mem_mb,
                setup_time=self._instances[(name, 1)].setup_seconds)
        return specs

    def run_batch(self, fn_name: str, invs: List[Invocation]) -> float:
        """Execute ``invs`` as ONE padded batch; returns measured wall
        seconds (the shared runtime of every member)."""
        bucket = pow2_bucket(len(invs))
        inst = self.ensure_instance(fn_name, bucket)
        self.n_executions += 1
        return inst.run(seed=batch_seed(inv.inv_id for inv in invs))


@dataclass
class _ContinuousState:
    """Per-function continuous-serving state: resident weights + a slot slab.

    The *slab* is one persistent KV cache allocated at the padded capacity
    (``pow2_bucket(max_batch)`` sequences); every request owns one slot for
    its lifetime.  ``tok``/``pos`` hold each slot's last sampled token and
    absolute decode position; ``finite`` stays true while every logit the
    data plane produced was finite."""

    served: ServedModel
    cap: int
    params: Any = None
    slab: Any = None
    tok: Optional[torch.Tensor] = None        # (cap, 1) int32
    pos: Optional[torch.Tensor] = None        # (cap,)  int32
    finite: Optional[torch.Tensor] = None     # () bool
    setup_seconds: float = 0.0


class ContinuousTorchExecutor:
    """Step-granular data plane: continuous batching over a slot slab.

    * ``admit(fn, invs, slots)`` — ONE batched prefill of the joiners,
      scattered into their cache slots (plus the first sampled token).
    * ``step(fn, slots)`` — ONE ragged decode step for every active slot.
    * ``gen_steps(fn)`` — decode steps a request owes after its prefill.

    Batches are padded to power-of-two buckets by repeating the first
    member's slot: duplicate rows compute identical values, so the duplicate
    scatter is deterministic.  Runs on the card unless ``device`` names
    another; weights come from ``init_params`` seeded with ``seed``.
    """

    def __init__(self, served: Dict[str, ServedModel], max_batch: int = 8,
                 device: DeviceLike = None, seed: int = 0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        for name, sm in served.items():
            if sm.cfg.frontend or sm.cfg.arch_type == "encdec":
                raise NotImplementedError(
                    f"continuous batching does not support frontend/encdec "
                    f"models yet (function {name!r}, model {sm.cfg.name})")
        self.device = resolve_device(device)
        self.served = served
        self.max_batch = max_batch
        self.seed = seed
        self._state: Dict[str, _ContinuousState] = {}
        # calibration medians per (fn_name, bucket): batched prefill seconds
        # and per-decode-step seconds
        self.bucket_admit_s: Dict[Tuple[str, int], float] = {}
        self.bucket_step_s: Dict[Tuple[str, int], float] = {}
        self.build_seconds = 0.0
        self.n_admits = 0               # batched prefills run (admit)
        self.n_steps = 0                # ragged decode steps run (step)

    @property
    def n_executions(self) -> int:
        """Device dispatches (admit + step), as the JAX executor counts."""
        return self.n_admits + self.n_steps

    def buckets(self) -> List[int]:
        return pow2_buckets(self.max_batch)

    def gen_steps(self, fn_name: str) -> int:
        return self.served[fn_name].gen_len

    def _ensure(self, fn_name: str) -> _ContinuousState:
        st = self._state.get(fn_name)
        if st is None:
            st = self._setup(fn_name)
            self._state[fn_name] = st
        return st

    def _setup(self, fn_name: str) -> _ContinuousState:
        self.build_seconds += build_kernels(self.device)
        t0 = time.perf_counter()
        sm = self.served[fn_name]
        cfg = sm.cfg
        cap = pow2_bucket(self.max_batch)
        st = _ContinuousState(served=sm, cap=cap)
        st.params = init_params(cfg, self.seed, self.device)
        st.slab = init_cache(cfg, cap, sm.prompt_len + sm.gen_len,
                             self.device)
        st.tok = torch.zeros((cap, 1), dtype=torch.int32, device=self.device)
        st.pos = torch.zeros((cap,), dtype=torch.int32, device=self.device)
        st.finite = torch.ones((), dtype=torch.bool, device=self.device)
        # run every bucket once: kernels load and libraries initialise here,
        # off the serving path (container build, in paper terms)
        for b in self.buckets():
            ids = torch.arange(b, device=self.device)
            self._join(st, torch.zeros((b, sm.prompt_len), dtype=torch.long,
                                       device=self.device), ids)
            self._step(st, ids)
        _sync(self.device)
        st.setup_seconds = time.perf_counter() - t0
        return st

    # -- the two device programs -------------------------------------------
    def _join(self, st: _ContinuousState, tokens: torch.Tensor,
              slot_ids: torch.Tensor) -> None:
        sm = st.served
        cache = init_cache(sm.cfg, tokens.shape[0],
                           sm.prompt_len + sm.gen_len, self.device)
        lg, c = prefill(sm.cfg, st.params, tokens, cache)
        first = torch.argmax(lg, dim=-1).to(torch.int32)        # (b,1)
        st.finite &= torch.isfinite(lg).all()
        for se, ce in zip(st.slab["layers"], c["layers"]):
            for key in se:
                se[key].index_copy_(1, slot_ids, ce[key])
        st.tok.index_copy_(0, slot_ids, first)
        st.pos.index_fill_(0, slot_ids, sm.prompt_len)

    def _step(self, st: _ContinuousState, slot_ids: torch.Tensor) -> None:
        sm = st.served
        # a private copy of the active rows: decode updates it in place
        sub = {"layers": [{key: t.index_select(1, slot_ids)
                           for key, t in e.items()}
                          for e in st.slab["layers"]]}
        pos = st.pos.index_select(0, slot_ids)
        lg, c2 = decode_step_ragged(sm.cfg, st.params, sub,
                                    st.tok.index_select(0, slot_ids), pos)
        ntok = torch.argmax(lg, dim=-1).to(torch.int32)         # (b,1)
        st.finite &= torch.isfinite(lg).all()
        for se, ce in zip(st.slab["layers"], c2["layers"]):
            for key in se:
                se[key].index_copy_(1, slot_ids, ce[key])
        st.tok.index_copy_(0, slot_ids, ntok)
        st.pos.index_copy_(0, slot_ids, pos + 1)

    # -- batcher hooks --------------------------------------------------------
    def _pad_slots(self, slots: List[int]) -> Tuple[int, torch.Tensor]:
        """Pad the slot list to its bucket by repeating the first slot."""
        b = pow2_bucket(len(slots))
        ids = list(slots) + [slots[0]] * (b - len(slots))
        return b, torch.tensor(ids, dtype=torch.long, device=self.device)

    def admit(self, fn_name: str, invs: List[Invocation],
              slots: List[int]) -> float:
        return self._admit_seeded(fn_name,
                                  [inv.inv_id for inv in invs], slots)

    def prompt_tokens(self, fn_name: str, ids: List[int],
                      n: int) -> np.ndarray:
        """The (n, prompt_len) prompt of a joining member set, drawn from
        numpy seeded by ``batch_seed(ids)``."""
        return prompt_tokens(self.served[fn_name], batch_seed(ids), n)

    def _admit_seeded(self, fn_name: str, ids: List[int],
                      slots: List[int]) -> float:
        return self._admit_tokens(
            fn_name, self.prompt_tokens(fn_name, ids, len(slots)), slots)

    def _admit_tokens(self, fn_name: str, tokens: np.ndarray,
                      slots: List[int]) -> float:
        """Prefill ``tokens`` (len(slots), prompt_len) into ``slots``;
        returns measured wall seconds."""
        st = self._ensure(fn_name)
        t0 = time.perf_counter()
        b, slot_ids = self._pad_slots(slots)
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)
        if b > len(slots):
            toks = torch.cat([toks, toks[:1].expand(b - len(slots), -1)])
        self._join(st, toks, slot_ids)
        _sync(self.device)
        self.n_admits += 1
        return time.perf_counter() - t0

    def step(self, fn_name: str, slots: List[int]) -> float:
        st = self._ensure(fn_name)
        t0 = time.perf_counter()
        _, slot_ids = self._pad_slots(slots)
        self._step(st, slot_ids)
        _sync(self.device)
        self.n_steps += 1
        return time.perf_counter() - t0

    def release_slots(self, fn_name: str, slots: List[int]) -> None:
        """Scrub the token/position rows of vacated cache slots (slab
        hygiene: freed slots are never gathered again until a join
        overwrites them)."""
        st = self._state.get(fn_name)
        if st is None or not slots:
            return
        ids = torch.tensor(sorted(slots), dtype=torch.long,
                           device=self.device)
        st.tok.index_fill_(0, ids, 0)
        st.pos.index_fill_(0, ids, 0)

    # -- inspection -------------------------------------------------------------
    def last_tokens(self, fn_name: str, slots: List[int]) -> List[int]:
        """Each slot's last sampled token (copied to the host)."""
        st = self._state[fn_name]
        return st.tok[list(slots), 0].tolist()

    def logits_finite(self, fn_name: str) -> bool:
        """Whether every logit the function's data plane produced so far was
        finite."""
        return bool(self._state[fn_name].finite.item())

    def calibrate(self, mem_mb: float = 512.0,
                  runs: int = 3) -> Dict[str, FunctionSpec]:
        """Set up every function and measure each bucket's batched prefill
        and per-step decode medians.  The returned ``FunctionSpec`` carries
        the batch-1 full-request time (prefill + ``gen_len`` steps); the
        per-bucket medians live in ``bucket_admit_s`` / ``bucket_step_s``."""
        specs = {}
        for name in self.served:
            st = self._ensure(name)
            for b in self.buckets():
                slots = list(range(b))
                a = sorted(self._admit_seeded(name, slots, slots)
                           for _ in range(runs))
                s = sorted(self.step(name, slots) for _ in range(runs))
                self.bucket_admit_s[(name, b)] = a[runs // 2]
                self.bucket_step_s[(name, b)] = s[runs // 2]
            exec_s = (self.bucket_admit_s[(name, 1)]
                      + st.served.gen_len * self.bucket_step_s[(name, 1)])
            specs[name] = FunctionSpec(name=name, exec_time=exec_s,
                                       mem_mb=mem_mb,
                                       setup_time=st.setup_seconds)
        return specs
