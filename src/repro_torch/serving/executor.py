"""Real PyTorch execution beneath the continuous batcher.

Port of ``src/repro/serving/executor.py:29-50, 242-458``: ``batch_seed``,
``ServedModel`` and the continuous data plane.  The per-invocation and
windowed executors are not ported yet (ROADMAP, Queue 1).

``ContinuousTorchExecutor`` keeps the JAX executor's surface (``admit``,
``step``, ``gen_steps``, ``release_slots``, ``calibrate``, ``buckets``,
``bucket_admit_s``, ``bucket_step_s``, ``n_executions``).  Where the JAX
executor compiles one executable per bucket, this one runs eagerly; its
set-up builds the CUDA kernels and runs every bucket once, so neither a
build nor a first launch lands on the serving path.  Prompts come from numpy
seeded by ``batch_seed`` (``jax.random`` cannot be replayed), drawn apart
from the join (``_admit_tokens``) so tests can feed both executors the same
tokens.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.batching import pow2_bucket
from ..core.types import FunctionSpec, Invocation
from ..device import DeviceLike, resolve_device
from ..kernels import _build
from ..models import (decode_step_ragged, init_cache, init_params, prefill)
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
        out, b = [], 1
        top = pow2_bucket(self.max_batch)
        while b <= top:
            out.append(b)
            b *= 2
        return out

    def gen_steps(self, fn_name: str) -> int:
        return self.served[fn_name].gen_len

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _ensure(self, fn_name: str) -> _ContinuousState:
        st = self._state.get(fn_name)
        if st is None:
            st = self._setup(fn_name)
            self._state[fn_name] = st
        return st

    def _setup(self, fn_name: str) -> _ContinuousState:
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            self.build_seconds += _build.build()
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
        self._sync()
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
        sm = self.served[fn_name]
        rng = np.random.default_rng(batch_seed(ids))
        return rng.integers(0, sm.cfg.vocab_size, (n, sm.prompt_len))

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
        self._sync()
        self.n_admits += 1
        return time.perf_counter() - t0

    def step(self, fn_name: str, slots: List[int]) -> float:
        st = self._ensure(fn_name)
        t0 = time.perf_counter()
        _, slot_ids = self._pad_slots(slots)
        self._step(st, slot_ids)
        self._sync()
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
