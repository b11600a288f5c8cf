"""The port's tracer (``repro_torch.trace``) on the benchmark's smoke path:
a window served with it on from set-up records a span for each join and
step that lasts the seconds the benchmark recorded, and its calls, served
again with the tracer off, give the same tokens."""
import numpy as np

from portbench import harness
from portbench import traffic as gen
from portbench.cells import find_cell
from repro_torch import trace

SEED = 2 ** 31 + 11


def test_a_traced_smoke_window_serves_the_tokens_of_an_untraced_one(
        one_thread):
    cell = find_cell("minicpm-2b.chat")
    trace.clear()
    trace.enable()
    try:
        s = harness.set_up(cell, True, SEED)
        times = gen.arrivals(s.traffic, 1.0, SEED)
        prompts = gen.prompts(s.traffic, len(times), s.dims["vocab_size"],
                              SEED)
        trace.clear()
        run, _ = harness.window(s, times, prompts, 1.0, 0.0)
    finally:
        trace.enable(False)
    calls = [c for c in trace.spans()
             if c.name in ("executor.join", "executor.step")]
    trace.clear()
    assert [(c.name, c.slots, c.end - c.start) for c in calls] == [
        (f"executor.{e.kind}", e.slots, e.seconds) for e in run.events]
    assert any(c.phases for c in calls)
    traced = s.backend.executor

    plain = harness.set_up(cell, True, SEED).backend.executor
    fn = s.traffic["function"]
    assert not trace.ON
    for e, want in zip(run.events, traced.tokens):
        if e.kind == "join":
            plain._admit_tokens(fn, prompts[list(e.rows)], list(e.slots))
        else:
            plain.step(fn, list(e.slots))
        np.testing.assert_array_equal(plain._state[fn].tok[:, 0].numpy(),
                                      want.numpy())
    assert trace.spans() == []
