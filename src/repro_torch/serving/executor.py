"""Real PyTorch execution beneath the sandbox abstraction.

Port of ``src/repro/serving/executor.py``: ``batch_seed``, ``ServedModel``,
the per-invocation data plane (``ModelInstance``, ``TorchModelExecutor``),
the windowed one (``BatchingTorchExecutor``) and the continuous one
(``ContinuousTorchExecutor``).

A *model instance* is the GPU-serving analogue of the paper's sandbox:
resident weights + a KV/SSM cache on the device and its compiled programs.
Its measured set-up time is what a cold start costs the scheduler.  As the
JAX package compiles an executable per call and bucket at set-up, set-up
here runs each program once (the warm-up) and captures it as a CUDA graph
(``serving.graphs``), inside the set-up clock; every join, prefill and
decode step after that is one replay.  The other build step, ``nvcc`` for
the CUDA kernels, happens once per executor before any instance is set up
(``build_seconds``), so that it never becomes a sandbox's modeled cold
start.

Prompts come from numpy seeded by the invocation (``inv_id``) or by
``batch_seed`` of the member set (``jax.random`` cannot be replayed here).
As in the JAX package, the draw and its copy to the device fall inside the
timed region of a run or a join.  ``run_tokens`` and ``_admit_tokens``
take given tokens, so tests can feed both packages the same prompt.  The
finiteness bookkeeping of the continuous executor (``logits_finite``) is
enqueued after a join's or step's clock stops.

Models with a modality frontend get zero frontend embeddings of
``(batch, n_frontend_tokens, d_model)`` in the compute dtype, as the JAX
executor passes them (the frontends are stubs in both packages).

``ContinuousTorchExecutor`` keeps the JAX executor's surface (``admit``,
``step``, ``gen_steps``, ``release_slots``, ``calibrate``, ``buckets``,
``bucket_admit_s``, ``bucket_step_s``, ``n_executions``).  As the JAX
executor compiles one join and one step executable per bucket, this one
captures one join and one step program per bucket at set-up
(``_ContinuousState.joins`` / ``steps``).  Off the card the programs run
their bodies through the same static buffers.  With the tracer on
(``repro_torch.trace``) each join and step records its span (split into
stage, launch and sync), its device interval and, for a step, the device
time of its gather, model and scatter and the bytes of slab rows it
addressed in place and copied.
"""
from __future__ import annotations

import time
import weakref
import zlib
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..core.batching import pow2_bucket
from ..core.types import FunctionSpec, Invocation
from ..device import DeviceLike, resolve_device
from ..kernels import _build
from ..models import (decode_step, decode_step_ragged, in_place_leaves,
                      init_cache, init_params, prefill)
from ..models.config import ModelConfig
from .graphs import Program, ProgramSet


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


def _weakly(obj: Any, fn) -> Any:
    """``fn(obj, ...)`` through a weak reference to ``obj``: ``obj`` owns
    the program whose body this is, and a body that owned ``obj`` back
    would make a reference cycle, keeping a dropped executor's weights,
    caches and graphs on the card until the cycle collector runs."""
    ref = weakref.ref(obj)
    return lambda *a, **kw: fn(ref(), *a, **kw)


def frontend_stub(cfg: ModelConfig, batch: int,
                  device: torch.device) -> Optional[torch.Tensor]:
    """Zero frontend embeddings (batch, n_frontend_tokens, d_model) for a
    model with a modality frontend, else None."""
    if not cfg.frontend:
        return None
    return torch.zeros((batch, cfg.n_frontend_tokens, cfg.d_model),
                       dtype=cfg.dtype(), device=device)


@dataclass
class ModelInstance:
    """A warm sandbox: weights + cache on the device, and its two compiled
    programs, ``prefill_fn`` and ``decode_fn`` (the reference's ``jax.jit``
    prefill and decode).

    ``params`` may be given (shared by the buckets of one function, or
    carried over from the JAX package by ``models.params_from_numpy``); the
    instance then skips the weight init.  ``programs`` may be given too
    (the buckets of one function share its side stream and memory
    pool)."""

    served: ServedModel
    device: torch.device
    params: Any = None
    cache: Any = None
    setup_seconds: float = 0.0
    last_tokens: Optional[torch.Tensor] = None   # (batch, gen_len + 1)
    programs: Optional[ProgramSet] = None
    prefill_fn: Optional[Program] = None
    decode_fn: Optional[Program] = None

    def setup(self, seed: int = 0) -> float:
        """Weights (unless given), the cache, the static buffers, one
        warm-up prefill + decode step, then the capture of both.  Returns
        real wall time (the sandbox setup overhead that Archipelago moves
        off the critical path)."""
        t0 = time.perf_counter()
        sm, dev = self.served, self.device
        if self.params is None:
            self.params = init_params(sm.cfg, seed, dev)
        # an encoder-decoder's cross K/V hold the frames its prefill encodes
        enc_len = (sm.cfg.n_frontend_tokens if sm.cfg.arch_type == "encdec"
                   else None)
        self.cache = init_cache(sm.cfg, sm.batch, sm.prompt_len + sm.gen_len,
                                dev, enc_len=enc_len)
        # the decode state the programs carry on the device: the last token,
        # the position t and the tokens so far (one spare column, which the
        # warm-up step writes when gen_len is 0)
        self._tok = torch.zeros((sm.batch, 1), dtype=torch.long, device=dev)
        self._t = torch.zeros((), dtype=torch.int32, device=dev)
        self._out = torch.zeros((sm.batch, sm.gen_len + 2), dtype=torch.int32,
                                device=dev)
        if self.programs is None:
            self.programs = ProgramSet(dev)
        self.prefill_fn = self.programs.add(
            _weakly(self, ModelInstance._prefill), {"tokens": torch.zeros(
                (sm.batch, sm.prompt_len), dtype=torch.long, device=dev)},
            host=("tokens",))
        self.decode_fn = self.programs.add(
            _weakly(self, ModelInstance._decode), {})
        with self.programs.side_stream():
            self.prefill_fn.warm_up()
            self.decode_fn.warm_up()
        self.programs.capture()
        _sync(dev)
        self.setup_seconds = time.perf_counter() - t0
        return self.setup_seconds

    # -- the two programs' bodies ----------------------------------------------
    def _prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """Prefill ``tokens`` into the cache, the first greedy token into
        column 0 of the output, and t = prompt_len."""
        sm = self.served
        logits, _ = prefill(sm.cfg, self.params, tokens, self.cache,
                            frontend_stub(sm.cfg, sm.batch, self.device))
        self._tok.copy_(torch.argmax(logits, dim=-1))           # (B, 1)
        self._out[:, :1].copy_(self._tok)
        self._t.fill_(sm.prompt_len)
        return logits

    def _decode(self) -> torch.Tensor:
        """One greedy decode step at t: its token into column
        t - prompt_len + 1 of the output, then t += 1."""
        sm = self.served
        logits, _ = decode_step(sm.cfg, self.params, self.cache, self._tok,
                                self._t)
        self._tok.copy_(torch.argmax(logits, dim=-1))
        col = (self._t - (sm.prompt_len - 1)).long().view(1)
        self._out.index_copy_(1, col, self._tok.to(torch.int32))
        self._t.add_(1)
        return logits

    def run(self, seed: int = 0) -> float:
        """One request: prefill + gen_len greedy decode steps on a prompt
        seeded by ``seed``.  Returns measured wall seconds, the prompt's
        draw included."""
        t0 = time.perf_counter()
        return self.run_tokens(prompt_tokens(self.served, seed,
                                             self.served.batch), t0)

    def run_tokens(self, tokens: np.ndarray,
                   t0: Optional[float] = None) -> float:
        """Prefill ``tokens`` (batch, prompt_len), then decode gen_len
        greedy tokens: one prefill call and ``gen_len`` decode calls, as
        the reference dispatches them; ``last_tokens`` keeps the first
        sampled token and the decoded ones.  Returns measured wall seconds
        since ``t0`` (default: the call).  Every cache position a step
        reads was written in this run, so the cache is reused."""
        sm = self.served
        if t0 is None:
            t0 = time.perf_counter()
        self.prefill_fn(tokens=tokens)
        for _ in range(sm.gen_len):
            self.decode_fn()
        _sync(self.device)
        dur = time.perf_counter() - t0
        self.last_tokens = self._out[:, :sm.gen_len + 1].clone()
        return dur


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
    instance (cache and programs at that batch), all set up and timed in
    ``calibrate``, off the serving path; the buckets of one function share
    its weights and its programs' memory pool.
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
            # the buckets of one function share its weights, side stream
            # and memory pool
            other = next((i for (f, _), i in self._instances.items()
                          if f == fn_name), None)
            inst = ModelInstance(
                replace(self.served[fn_name], batch=bucket), self.device,
                params=other and other.params,
                programs=other and other.programs)
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
    data plane produced was finite.  ``logits`` keeps the last join's or
    step's logits until its finiteness is noted, after its clock stops.
    ``joins`` / ``steps`` hold each bucket's compiled join and step (the
    JAX executor's ``join_fns`` / ``step_fns``), ``programs`` all of
    them.  ``slab_bytes`` gives, per bucket, the bytes of slab rows a step
    addresses in place and those it copies (``in_place_bytes``,
    ``copied_bytes``: the tracer's step span carries them)."""

    served: ServedModel
    cap: int
    params: Any = None
    slab: Any = None
    tok: Optional[torch.Tensor] = None        # (cap, 1) int32
    pos: Optional[torch.Tensor] = None        # (cap,)  int32
    finite: Optional[torch.Tensor] = None     # () bool
    logits: Optional[torch.Tensor] = None     # (b, 1, V), until noted
    setup_seconds: float = 0.0
    programs: Optional[ProgramSet] = None
    joins: Dict[int, Program] = field(default_factory=dict)
    steps: Dict[int, Program] = field(default_factory=dict)
    slab_bytes: Dict[int, Dict[str, int]] = field(default_factory=dict)


class ContinuousTorchExecutor:
    """Step-granular data plane: continuous batching over a slot slab.

    * ``admit(fn, invs, slots)`` — ONE batched prefill of the joiners,
      scattered into their cache slots (plus the first sampled token).
    * ``step(fn, slots)`` — ONE ragged decode step for every active slot,
      against the slab's full-attention K/V in place (``_step``).
    * ``gen_steps(fn)`` — decode steps a request owes after its prefill.

    Batches are padded to power-of-two buckets by repeating the first
    member's slot, and every row is written into its slot.  The copies
    compute identical values, except in an MoE layer, where they compete
    for expert capacity and one can be dropped: for an MoE model the write
    that lands in the first slot is unspecified (as in the reference), and
    so, since a step writes K/V in place before it attends, are the K/V
    its first slot's rows read at the new position.
    Runs on the card unless ``device`` names another; weights come from
    ``init_params`` seeded with ``seed``.
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
        """Device dispatches (admit + step), as the JAX executor counts: on
        the card each is one replay of a captured program."""
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
        """The function's weights, slab and programs, inside the set-up
        clock: each bucket's join and step warmed up and captured, then
        the slab, ``tok`` and ``pos`` zeroed, as the reference leaves them.
        ``finite`` keeps the warm-up's logits folded in: it is the port's
        own check, which the reference does not have."""
        self.build_seconds += build_kernels(self.device)
        t0 = time.perf_counter()
        sm = self.served[fn_name]
        cfg, dev = sm.cfg, self.device
        cap = pow2_bucket(self.max_batch)
        st = _ContinuousState(served=sm, cap=cap, programs=ProgramSet(dev))
        st.params = init_params(cfg, self.seed, dev)
        st.slab = init_cache(cfg, cap, sm.prompt_len + sm.gen_len, dev)
        st.tok = torch.zeros((cap, 1), dtype=torch.int32, device=dev)
        st.pos = torch.zeros((cap,), dtype=torch.int32, device=dev)
        st.finite = torch.ones((), dtype=torch.bool, device=dev)
        for b in self.buckets():
            st.joins[b] = st.programs.add(
                _weakly(st, self._join),
                {"tokens": torch.zeros((b, sm.prompt_len), dtype=torch.long,
                                       device=dev),
                 "slot_ids": torch.arange(b, device=dev)},
                host=("tokens", "slot_ids"))
            st.steps[b] = st.programs.add(
                _weakly(st, self._step),
                {"slot_ids": torch.arange(b, device=dev)},
                host=("slot_ids",))
            st.slab_bytes[b] = self._slab_bytes(st, b)
        # compile every bucket up front, as the JAX executor does (the whole
        # bill is set-up, off the serving path; container build, in paper
        # terms): one eager run of each program, then the capture of all
        with st.programs.side_stream():
            for b in self.buckets():
                st.logits = st.joins[b].warm_up()
                self._note_finite(st)
                st.logits = st.steps[b].warm_up()
                self._note_finite(st)
        st.programs.capture()
        # the reference warms up into locals and leaves the slab, tokens
        # and positions as allocated: zero them in place (the graphs hold
        # their addresses), after the warm-up on the current stream
        for entry in st.slab["layers"]:
            for t in entry.values():
                t.zero_()
        st.tok.zero_()
        st.pos.zero_()
        _sync(dev)
        st.setup_seconds = time.perf_counter() - t0
        return st

    # -- the two programs' bodies --------------------------------------------
    @staticmethod
    def _join(st: _ContinuousState, tokens: torch.Tensor,
              slot_ids: torch.Tensor) -> torch.Tensor:
        """Prefill ``tokens`` (b, prompt_len) into a fresh cache, scatter it
        into the slab rows ``slot_ids``, with the first greedy token and
        the position; returns the logits (b, 1, V)."""
        sm = st.served
        cache = init_cache(sm.cfg, tokens.shape[0],
                           sm.prompt_len + sm.gen_len, tokens.device)
        lg, c = prefill(sm.cfg, st.params, tokens, cache)
        first = torch.argmax(lg, dim=-1).to(torch.int32)        # (b,1)
        for se, ce in zip(st.slab["layers"], c["layers"]):
            for key in se:
                se[key].index_copy_(1, slot_ids, ce[key])
        st.tok.index_copy_(0, slot_ids, first)
        st.pos.index_fill_(0, slot_ids, sm.prompt_len)
        return lg

    @staticmethod
    def _slab_bytes(st: _ContinuousState, b: int) -> Dict[str, int]:
        """The bytes of slab rows a bucket-``b`` step addresses in place
        (``in_place_leaves``) and those it gathers and scatters (every
        other leaf), its padding rows included."""
        out = {"in_place_bytes": 0, "copied_bytes": 0}
        for g, e in zip(st.served.cfg.groups(), st.slab["layers"]):
            for key, t in e.items():
                kind = ("in_place_bytes" if key in in_place_leaves(g)
                        else "copied_bytes")
                out[kind] += b * t.numel() // st.cap * t.element_size()
        return out

    @staticmethod
    def _step(st: _ContinuousState, slot_ids: torch.Tensor) -> torch.Tensor:
        """One ragged decode step of the slab rows ``slot_ids``; returns the
        logits (b, 1, V).

        A full-attention group's K/V (``in_place_leaves``) are read and
        written in the slab itself: the step writes each row's new position
        there and the decode kernel reads each row's keys through the slot
        ids (as int32, the kernel's row index).  Every other leaf (a Mamba
        group's conv inputs and state, a sliding window's ring), with the
        tokens and positions, is gathered into a private copy of the active
        rows and scattered back.  A padded bucket's rows repeat the first
        slot: they compute the same K/V as it and write them to the same
        position, so a dense model's result is the unpadded one."""
        sm, dev = st.served, slot_ids.device
        trace.mark("gather", dev)
        rows, ids = slot_ids.int(), slot_ids.long()
        kept = [in_place_leaves(g) for g in sm.cfg.groups()]
        sub = {"layers": [{key: t if key in keep else t.index_select(1, ids)
                           for key, t in e.items()}
                          for e, keep in zip(st.slab["layers"], kept)]}
        pos = st.pos.index_select(0, ids)
        tok = st.tok.index_select(0, ids)
        trace.mark("model", dev)
        lg, c2 = decode_step_ragged(sm.cfg, st.params, sub, tok, pos,
                                    rows=rows)
        ntok = torch.argmax(lg, dim=-1).to(torch.int32)         # (b,1)
        trace.mark("scatter", dev)
        for se, ce, keep in zip(st.slab["layers"], c2["layers"], kept):
            for key in se:
                if key not in keep:
                    se[key].index_copy_(1, ids, ce[key])
        st.tok.index_copy_(0, ids, ntok)
        st.pos.index_copy_(0, ids, pos + 1)
        trace.mark("end", dev)
        return lg

    def _note_finite(self, st: _ContinuousState) -> None:
        """Fold the kept logits into ``finite`` (enqueued, not waited for)
        and drop them: called after a join's or step's clock stops."""
        st.finite &= torch.isfinite(st.logits).all()
        st.logits = None

    # -- batcher hooks --------------------------------------------------------
    @staticmethod
    def _pad_slots(slots: List[int]) -> Tuple[int, List[int]]:
        """Pad the slot list to its bucket by repeating the first slot."""
        b = pow2_bucket(len(slots))
        return b, list(slots) + [slots[0]] * (b - len(slots))

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
        self._ensure(fn_name)
        t0 = self._start("executor.join", fn_name, slots)
        return self._admit_tokens(
            fn_name, self.prompt_tokens(fn_name, ids, len(slots)), slots, t0)

    def _admit_tokens(self, fn_name: str, tokens: np.ndarray,
                      slots: List[int], t0: Optional[float] = None) -> float:
        """Prefill ``tokens`` (len(slots), prompt_len) into ``slots``;
        returns measured wall seconds since ``t0`` (default: the call,
        after the function's set-up)."""
        st = self._ensure(fn_name)
        if t0 is None:
            t0 = self._start("executor.join", fn_name, slots)
        b, slot_ids = self._pad_slots(slots)
        toks = np.asarray(tokens)
        toks = np.concatenate([toks, np.repeat(toks[:1], b - len(slots), 0)])
        dur = self._run(st, st.joins[b], t0, tokens=toks, slot_ids=slot_ids)
        self._note_finite(st)
        self.n_admits += 1
        return dur

    def step(self, fn_name: str, slots: List[int]) -> float:
        st = self._ensure(fn_name)
        t0 = self._start("executor.step", fn_name, slots, st.slab_bytes)
        b, slot_ids = self._pad_slots(slots)
        dur = self._run(st, st.steps[b], t0, slot_ids=slot_ids)
        self._note_finite(st)
        self.n_steps += 1
        return dur

    def _start(self, name: str, fn_name: str, slots: List[int],
               slab_bytes: Optional[Dict[int, Dict[str, int]]] = None
               ) -> float:
        """Start a join's or step's clock; with the tracer on, its span and
        the span's stage open there (both ranges open before the clock is
        read).  A step's span carries its bucket's ``slab_bytes``."""
        if not trace.ON:
            return time.perf_counter()
        bucket = pow2_bucket(len(slots))
        call = trace.begin(name, fn=fn_name, bucket=bucket,
                           slots=tuple(slots),
                           **(slab_bytes[bucket] if slab_bytes else {}))
        call.start = trace.begin("stage").start
        return call.start

    def _run(self, st: _ContinuousState, prog: Program, t0: float,
             **host: Any) -> float:
        """Stage ``host`` into ``prog``, launch it and wait for the
        device; returns the seconds since ``t0``, with the logits kept in
        ``st``."""
        if trace.ON:
            return self._run_traced(st, prog, t0, host)
        st.logits = prog(**host)
        _sync(self.device)
        return time.perf_counter() - t0

    def _run_traced(self, st: _ContinuousState, prog: Program, t0: float,
                    host: Dict[str, Any]) -> float:
        """``_run`` inside the spans ``_start`` opened: stage, launch and
        sync tile the call, and the device stamps and the body's marks are
        read once the call's clock has stopped."""
        first = trace.stamp(self.device)
        prog.stage(**host)
        trace.then("launch")
        with trace.collecting() as marks:
            st.logits = prog.launch()
        last = trace.stamp(self.device)
        trace.then("sync")
        _sync(self.device)
        t1 = time.perf_counter()
        trace.end(t1)
        call = trace.end(t1)
        call.device_s = trace.between(first, last)
        call.phases = trace.phases(marks or prog.marks)
        return t1 - t0

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
