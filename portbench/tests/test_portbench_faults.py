"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the program's continuous executor (its decode
step's body) for the run, which otherwise runs as ``run.py --smoke`` does,
past the look for a card.  The faults a serving cell on one chip can have:
a step that returns its state unchanged, half of the batch left out, and a
token altered where it is produced.  (No cell spans chips: there is no
exchange between chips to leave out.)"""
import argparse
import json
import time

import pytest
import torch

from portbench import harness
from repro_torch.serving.executor import ContinuousTorchExecutor

STEP = ContinuousTorchExecutor._step


def state_unchanged(st, slot_ids):
    """The step's writes into the slab are lost: the cache stays as it
    was, while tokens and positions move on."""
    keep = [{k: t.clone() for k, t in e.items()} for e in st.slab["layers"]]
    lg = STEP(st, slot_ids)
    for e, k in zip(st.slab["layers"], keep):
        for key, t in e.items():
            t.copy_(k[key])
    return lg


def half_the_batch(st, slot_ids):
    """Only the first half of the active rows is stepped."""
    n = slot_ids.shape[0]
    return STEP(st, slot_ids[: max(1, n // 2)]) if n > 1 \
        else STEP(st, slot_ids)


def token_altered(st, slot_ids):
    """The first row's sampled token is replaced by the next id."""
    lg = STEP(st, slot_ids)
    s = slot_ids[:1]
    V = st.served.cfg.vocab_size
    st.tok.index_copy_(0, s, torch.remainder(st.tok.index_select(0, s) + 1,
                                             V))
    return lg


@pytest.mark.parametrize("workload", ["minicpm-2b.chat", "mamba2-370m.chat"])
@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   token_altered])
def test_a_broken_step_is_not_correct(monkeypatch, capsys, in_process,
                                      workload, fault):
    monkeypatch.setattr(ContinuousTorchExecutor, "_step",
                        staticmethod(fault))
    ns = argparse.Namespace(workload=workload, seed=23, seconds=1.5,
                            trace=0, smoke=True)
    assert harness.run_cell(ns, time.perf_counter()) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
