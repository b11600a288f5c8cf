"""The port's tracer (``repro_torch.trace``) on the CPU: the spans of the
executor's joins and steps, how they nest and tile, the step body's marks,
and the ranges a profile holds.  On the card the
marks are timing events inside the captured graphs
(``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro_torch import trace, trace_readings
from repro_torch.configs import get_config
from repro_torch.core import BatchedTorchBackend
from repro_torch.serving import ServedModel, graphs, smoke_apps
from repro_torch.serving.executor import ContinuousTorchExecutor
from repro_torch.sim import Experiment, simulate

F32 = dict(compute_dtype="float32", param_dtype="float32")
NAMES = {"executor.join", "executor.step", "stage", "launch", "sync"}
# a step's phases (reduced minicpm-2b: one attention group) and its marks
PHASES = ["gather", "model", "attn", "scatter"]
MARKS = ["gather", "model", "attn", "model", "scatter", "end"]


class Replaying:
    """A CUDA graph's stand-in off the card: capture and every replay run
    the body (a real capture runs nothing, a real replay no Python)."""

    def __init__(self, pool, stream):
        self.body = None

    def capture(self, body):
        self.body = body
        return body()

    def replay(self):
        self.body()


@pytest.fixture
def tracing():
    trace.clear()
    trace.enable()
    yield
    trace.enable(False)
    trace.clear()


def _executor(max_batch=4):
    cfg = get_config("minicpm-2b", reduced=True).with_(**F32)
    served = {"gen": ServedModel(cfg, prompt_len=8, gen_len=4)}
    return ContinuousTorchExecutor(served, max_batch=max_batch, device="cpu")


def _serve(ex):
    """Two joins and two steps; each call's kind and returned seconds."""
    rng = np.random.default_rng(0)
    out = [("join", ex._admit_tokens("gen", rng.integers(0, 100, (3, 8)),
                                     [0, 1, 2]))]
    out.append(("step", ex.step("gen", [0, 1, 2])))
    out.append(("join", ex._admit_tokens("gen", rng.integers(0, 100, (1, 8)),
                                         [3])))
    out.append(("step", ex.step("gen", [0, 1, 2, 3])))
    return out


def _calls(kind=None):
    names = {"executor.join", "executor.step"} if kind is None \
        else {f"executor.{kind}"}
    return [(i, s) for i, s in enumerate(trace.spans()) if s.name in names]


def _children(i):
    return [s for s in trace.spans() if s.parent == i]


def _profiled_names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.name() in NAMES]


def _window(apps, backend):
    return simulate(Experiment(
        stack="archipelago", workload_factory="serving_apps",
        workload_kwargs=dict(apps=apps, duration=1.0, rps=6.0),
        backend=backend, drain=30.0))


def test_with_the_tracer_off_a_served_window_records_nothing(monkeypatch):
    """Off, a window served under the scheduler records no span, opens no
    profiler range, and its captured programs hold no mark."""
    monkeypatch.setattr(graphs, "graph_for", lambda device: Replaying)
    trace.clear()
    be = BatchedTorchBackend(max_batch=4, batching="continuous",
                             device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r = _window(smoke_apps(), be)
    assert r.n_completed == r.n_requests > 0
    assert be.executor.n_steps > 0
    assert trace.spans() == []
    assert _profiled_names(prof) == []
    progs = [p for st in be.executor._state.values()
             for p in st.programs.programs]
    assert progs and all(p.graph is not None and p.marks == []
                         for p in progs)


@pytest.mark.parametrize("on", [False, True])
def test_a_program_holds_the_marks_its_capture_saw(monkeypatch, on):
    """A step program captured with the tracer on holds its body's marks
    in order (the executor's four, and the model's around its one group);
    one captured with it off, and every join, none."""
    monkeypatch.setattr(graphs, "graph_for", lambda device: Replaying)
    trace.clear()
    trace.enable(on)
    try:
        ex = _executor()
        st = ex._ensure("gen")
    finally:
        trace.enable(False)
    for b in ex.buckets():
        assert st.joins[b].marks == []
        assert [n for n, _ in st.steps[b].marks] == (MARKS if on else [])


@pytest.mark.parametrize("kind", ["join", "step"])
def test_stage_launch_and_sync_tile_their_call(tracing, kind):
    ex = _executor()
    _serve(ex)
    calls = _calls(kind)
    assert len(calls) == 2
    for i, call in calls:
        kids = _children(i)
        assert [k.name for k in kids] == ["stage", "launch", "sync"]
        assert kids[0].start == call.start and kids[-1].end == call.end
        for a, b in zip(kids, kids[1:]):
            assert a.end == b.start
        assert all(k.end > k.start for k in kids)


@pytest.mark.parametrize("kind", ["join", "step"])
def test_a_call_span_lasts_the_seconds_the_call_returned(tracing, kind):
    ex = _executor()
    ex._ensure("gen")
    trace.clear()
    seconds = [s for k, s in _serve(ex) if k == kind]
    spans = [c for _, c in _calls(kind)]
    assert [c.end - c.start for c in spans] == seconds
    assert [c.bucket for c in spans] == ([4, 1] if kind == "join" else [4, 4])
    assert spans[-1].slots == ((3,) if kind == "join" else (0, 1, 2, 3))
    assert all(c.fn == "gen" for c in spans)


def test_gather_model_and_scatter_tile_the_step_body(tracing):
    """Off the card the body runs at every call and its marks take the
    host's clock: the phases (the model's split into its group and the
    rest) follow one another inside the launch, and the device interval
    (the stamps around stage and launch) holds them."""
    ex = _executor()
    ex._ensure("gen")
    trace.clear()
    _serve(ex)
    steps = _calls("step")
    assert len(steps) == 2
    for i, step in steps:
        assert list(step.phases) == PHASES
        assert all(v > 0 for v in step.phases.values())
        _, launch, _ = _children(i)
        assert sum(step.phases.values()) <= launch.end - launch.start
        assert sum(step.phases.values()) <= step.device_s
        assert step.device_s <= step.end - step.start
    for _, join in _calls("join"):
        assert join.phases == {} and 0 < join.device_s <= join.end - join.start


def test_a_served_window_records_one_span_per_call(tracing):
    """Under the scheduler every join and step the executor makes records
    one top-level span, tiled by its stage, launch and sync; the readings
    count each of them."""
    be = BatchedTorchBackend(max_batch=4, batching="continuous",
                             device="cpu")
    r = _window(smoke_apps(), be)
    assert r.n_completed == r.n_requests > 0
    ex = be.executor
    joins, steps = _calls("join"), _calls("step")
    assert (len(joins), len(steps)) == (ex.n_admits, ex.n_steps)
    assert all(s.parent is None for _, s in joins + steps)
    for i, _ in joins + steps:
        assert [k.name for k in _children(i)] == ["stage", "launch", "sync"]
    got = trace_readings.summarize(trace.spans())
    assert (got["join"]["n"], got["step"]["n"]) == (ex.n_admits, ex.n_steps)
    assert got["slab_copy_ms"] > 0 and got["launch_ms"] > 0


def test_a_cpu_profile_holds_each_span_as_a_range(tracing):
    """While a profile records, every span opens a range of its name: the
    profile holds as many ranges of each name as spans were mirrored, and
    each step's launch range inside its step's."""
    ex = _executor()
    ex._ensure("gen")
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(ex)
    _serve(ex)                          # after the profile: no range
    spans = trace.spans()
    assert sum(s.mirrored for s in spans) == len(spans) // 2
    names = _profiled_names(prof)
    for n in ("executor.join", "executor.step", "stage", "launch", "sync"):
        assert names.count(n) == sum(s.mirrored and s.name == n
                                     for s in spans) > 0
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name() in ("executor.step", "launch")]
    steps = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs
             if e.name() == "executor.step"]
    launches = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs
                if e.name() == "launch"]
    assert len(steps) == 2
    for s0, s1 in steps:
        assert sum(s0 <= a and b <= s1 for a, b in launches) == 1
    # one reading ends a span and begins the next: the next range opens
    # before the first one closes, so the reading lies inside both
    _, host = trace_readings.profile_events(prof)
    kids = sorted((s, t, n) for n, s, t in host
                  if n in ("stage", "launch", "sync"))
    assert [n for _, _, n in kids] == ["stage", "launch", "sync"] * 4
    for k in range(0, len(kids), 3):
        stage, launch, sync = kids[k:k + 3]
        assert launch[0] <= stage[1] and sync[0] <= launch[1]
    got = trace_readings.clock_agreement(spans, host)
    assert got["pairs"] == len(spans) // 2 and got["unequal"] == []


def test_phases_sum_the_phases_that_share_a_name():
    marks = [("gather", 0.0), ("mamba", 1.0), ("attn", 3.0), ("mamba", 4.0),
             ("model", 8.0), ("end", 8.5)]
    assert trace.phases(marks) == {"gather": 1.0, "mamba": 6.0,
                                   "attn": 1.0, "model": 0.5}
    assert list(trace.phases(marks)) == ["gather", "mamba", "attn", "model"]
    assert trace.phases(marks[:1]) == {}
