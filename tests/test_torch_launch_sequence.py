"""The operations a continuous join and step launch, held to a record.

A captured join or step replays, on the card, the kernels its body
launched while it was captured.  Here each body of the reduced minicpm-2b
and mamba2-370m runs once on the CPU under a ``TorchDispatchMode`` that
lists every ATen operation it dispatches, in order, and the lists are held
to ``tests/data/launch_sequences.json``: a change that adds, drops or
reorders an operation in these configs' joins or steps shows here.  The
record is written from a checkout by

    PYTHONPATH=src python tests/test_torch_launch_sequence.py --write \\
        tests/data/launch_sequences.json

and is rewritten only for a change meant to alter these bodies.
"""
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.serving.executor import (ContinuousTorchExecutor,
                                          ServedModel)

DATA = Path(__file__).resolve().parent / "data" / "launch_sequences.json"
ARCHS = ("minicpm-2b", "mamba2-370m")
PROMPT, GEN, MAX_BATCH = 8, 3, 2


class Recording(TorchDispatchMode):

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def sequences():
    """Per ``<arch>/<join|step>/<bucket>``, the operations one call of the
    body dispatches, in order."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        served = {"gen": ServedModel(cfg, prompt_len=PROMPT, gen_len=GEN)}
        ex = ContinuousTorchExecutor(served, max_batch=MAX_BATCH,
                                     device="cpu")
        st = ex._ensure("gen")
        for b in ex.buckets():
            tokens = torch.arange(b * PROMPT).reshape(b, PROMPT) % 97
            slots = torch.arange(b)
            with torch.no_grad(), Recording() as rec:
                ex._join(st, tokens, slots)
            out[f"{arch}/join/{b}"] = rec.ops
            with torch.no_grad(), Recording() as rec:
                ex._step(st, slots)
            out[f"{arch}/step/{b}"] = rec.ops
    return out


@pytest.fixture(scope="module")
def recorded():
    return sequences()


@pytest.mark.parametrize("body", [f"{a}/{k}/{b}" for a in ARCHS
                                  for k in ("join", "step") for b in (1, 2)])
def test_a_reduced_join_and_step_launch_the_recorded_operations(recorded,
                                                                body):
    want = json.loads(DATA.read_text())[body]
    assert recorded[body] == want


if __name__ == "__main__":
    if sys.argv[1:2] != ["--write"] or len(sys.argv) != 3:
        sys.exit("usage: test_torch_launch_sequence.py --write PATH")
    Path(sys.argv[2]).write_text(json.dumps(sequences(), indent=0) + "\n")
