"""The control comes out not correct: the reference put in the program's
place at fp8, the precision below the configurations' bfloat16, read on
the same prompts and served tokens (``readings.py``, as run on the chip at
the cells' own sizes), here at the reduced sizes of ``--smoke`` against
the smoke limit, on three seeds."""
import pytest

from portbench import cells, harness
from portbench.control import readings


@pytest.mark.parametrize("workload", ["minicpm-2b.chat", "mamba2-370m.chat"])
def test_the_control_fails_and_the_program_passes(one_thread, workload):
    s = harness.set_up(cells.find_cell(workload), smoke=True, seed=1)
    seeds = [1, 2, 3]
    rows = readings(s, seeds, set(seeds), 1.5,
                                      diagnose=False)
    limit = s.traffic["check"]["max_logit_gap"]
    for r in rows:
        assert r["program_gap"] <= limit < r["control_gap"], r
