"""Synthetic-but-structured data pipeline.

Copy of ``src/repro/train/data.py`` (numpy only; the port imports nothing
of ``repro``): the same batches for every seed and step.

No external corpora: the pipeline still exercises the
real mechanics — deterministic sharded batching, prefetch, pack-to-length —
over a synthetic Zipfian token stream with Markov bigram structure (so a
~100M model's loss visibly drops below the unigram entropy during the
example training run).
"""
from __future__ import annotations

import threading
import queue as _queue
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew
    markov_strength: float = 0.8  # P(next in successor set | cur)
    n_successors: int = 8


class SyntheticLM:
    """Deterministic, seekable synthetic token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.unigram = p / p.sum()
        # each token gets a small successor set (bigram structure)
        self.successors = rng.integers(0, v, size=(v, cfg.n_successors))

    def batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 32) ^ step)
        B, S = cfg.batch_size, cfg.seq_len
        out = np.empty((B, S), np.int32)
        cur = rng.choice(cfg.vocab_size, size=B, p=self.unigram)
        out[:, 0] = cur
        for t in range(1, S):
            use_markov = rng.random(B) < cfg.markov_strength
            succ_pick = self.successors[cur, rng.integers(
                0, cfg.n_successors, size=B)]
            indep = rng.choice(cfg.vocab_size, size=B, p=self.unigram)
            cur = np.where(use_markov, succ_pick, indep).astype(np.int32)
            out[:, t] = cur
        return out

    def iterate(self, start_step: int = 0) -> Iterator[np.ndarray]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (double buffering) over a batch iterator."""

    def __init__(self, it: Iterator[np.ndarray], depth: int = 2):
        self._q: _queue.Queue = _queue.Queue(maxsize=depth)
        self._it = it
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for item in self._it:
            if self._stop:
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop = True
