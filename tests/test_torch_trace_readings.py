"""The tracer's readings (``repro_torch.trace_readings``) over hand-made
spans and profiles: which calls they keep, what each number sums, and
None where there is nothing to read."""
import pytest

from repro_torch import trace
from repro_torch.trace import Span
from repro_torch.trace_readings import (clock_agreement, profile_readings,
                                        summarize)

SLICE = [(0.045, 0.060)]


def _call(spans, name, t0, t1, cuts, device_s, phases=None):
    """A call span from t0 to t1, tiled by stage / launch / sync at cuts."""
    i = len(spans)
    spans.append(Span(name, t0, t1, device_s=device_s, phases=phases or {}))
    for n, a, b in zip(("stage", "launch", "sync"), (t0,) + cuts,
                       cuts + (t1,)):
        spans.append(Span(n, a, b, parent=i))


def _spans():
    out = []
    _call(out, "executor.join", 0.000, 0.010, (0.002, 0.003), 0.008)
    _call(out, "executor.step", 0.020, 0.030, (0.021, 0.023), 0.009,
          {"gather": 0.002, "model": 0.005, "scatter": 0.001})
    # overlaps the profiled slice: left out of every reading
    _call(out, "executor.step", 0.040, 0.050, (0.041, 0.049), 0.001,
          {"gather": 0.0005, "model": 0.0003, "scatter": 0.0001})
    return out


def test_summarize_reads_the_calls_outside_the_profiled_slices():
    got = summarize(_spans(), SLICE)
    assert got["launch_ms"] == pytest.approx(1.5)
    assert got["step_device_ms"] == pytest.approx(9.0)
    assert got["slab_copy_ms"] == pytest.approx(3.0)
    assert got["call_idle_pct"] == pytest.approx(15.0)
    assert got["join"] == pytest.approx(dict(
        n=1, timed_ms=10.0, stage_ms=2.0, launch_ms=1.0, sync_ms=7.0,
        device_ms=8.0))
    assert got["step"] == pytest.approx(dict(
        n=1, timed_ms=10.0, stage_ms=1.0, launch_ms=2.0, sync_ms=7.0,
        device_ms=9.0, gather_ms=2.0, model_ms=5.0, scatter_ms=1.0))
    # with no slice the third call counts too
    assert summarize(_spans())["step"]["n"] == 2


@pytest.mark.parametrize("spans, profiled", [([], []), (_spans(), [(0, 1)])],
                         ids=["no span", "all in a slice"])
def test_summarize_reads_none_with_no_call_to_read(spans, profiled):
    got = summarize(spans, profiled)
    assert got == dict(launch_ms=None, step_device_ms=None,
                       slab_copy_ms=None, step_mamba_ms=None,
                       step_attn_ms=None, slab_in_place_pct=None,
                       call_idle_pct=None, join=None, step=None)


def _hybrid_step(t0, groups):
    """A step of a hybrid whose groups took ``groups`` [(kind, s)] between
    the embedding's 1 ms and the head's 2 ms, as ``trace.phases`` sums the
    marks of one name."""
    marks, t = [("gather", 0.0), ("model", 0.001)], 0.002
    for kind, sec in groups:
        marks.append((kind, t))
        t += sec
    marks += [("model", t), ("scatter", t + 0.002), ("end", t + 0.003)]
    return Span("executor.step", t0, t0 + 0.05, device_s=0.04,
                phases=trace.phases(marks))


def test_step_mamba_and_attn_ms_sum_each_kind_over_a_step_s_groups():
    spans = [_hybrid_step(0.0, [("mamba", 0.005), ("attn", 0.001),
                                ("mamba", 0.009), ("attn", 0.002),
                                ("mamba", 0.004)]),
             _hybrid_step(0.1, [("mamba", 0.010), ("attn", 0.004)]),
             # profiled: left out
             _hybrid_step(0.2, [("mamba", 1.0), ("attn", 1.0)])]
    assert list(spans[0].phases) == ["gather", "model", "mamba", "attn",
                                     "scatter"]
    assert spans[0].phases == pytest.approx(
        {"gather": 0.001, "model": 0.003, "mamba": 0.018, "attn": 0.003,
         "scatter": 0.001})
    got = summarize(spans, [(0.19, 0.26)])
    assert got["step_mamba_ms"] == pytest.approx((18.0 + 10.0) / 2)
    assert got["step_attn_ms"] == pytest.approx((3.0 + 4.0) / 2)
    assert got["step"]["model_ms"] == pytest.approx(3.0)


@pytest.mark.parametrize("kinds, want", [
    (["attn"], ("step_mamba_ms",)),             # a dense model
    (["mamba"], ("step_attn_ms",)),             # a pure SSM
], ids=["dense", "ssm"])
def test_a_step_group_reading_is_none_where_no_step_has_the_kind(kinds,
                                                                want):
    got = summarize([_hybrid_step(0.0, [(k, 0.003) for k in kinds])])
    for name in want:
        assert got[name] is None
    other = ({"step_mamba_ms", "step_attn_ms"} - set(want)).pop()
    assert got[other] == pytest.approx(3.0)


def _step(t0, in_place, copied):
    return Span("executor.step", t0, t0 + 0.01, device_s=0.009,
                in_place_bytes=in_place, copied_bytes=copied)


@pytest.mark.parametrize("steps, want", [
    ([(4096, 0), (8192, 0)], 100.0),            # every leaf full attention
    ([(0, 512), (0, 1024)], 0.0),               # a pure SSM
    ([(3000, 1000), (6000, 2000)], 75.0),       # a hybrid
    ([(3000, 1000), (0, 0)], 75.0),             # a span without bytes
], ids=["in place", "copied", "mixed", "no bytes"])
def test_slab_in_place_pct_weighs_the_steps_by_their_bytes(steps, want):
    spans = [_step(0.1 * i, a, c) for i, (a, c) in enumerate(steps)]
    # a join carries no slab bytes, and a profiled step is left out
    spans.append(Span("executor.join", 1.0, 1.01, device_s=0.009))
    spans.append(_step(2.0, 0, 10 ** 6))
    got = summarize(spans, [(1.99, 2.02)])
    assert got["slab_in_place_pct"] == pytest.approx(want)


def test_slab_in_place_pct_reads_none_without_steps():
    spans = [Span("executor.join", 0.0, 0.01, device_s=0.009)]
    assert summarize(spans)["slab_in_place_pct"] is None


def test_profile_readings_split_the_idle_between_calls_and_the_rest():
    dev = [(0, 100), (128, 132), (150, 200), (210, 300), (400, 500),
           (600, 700)]
    host = [("executor.step", 100, 320), ("launch", 120, 140),
            ("cudaGraphLaunch", 125, 135), ("cudaGraphLaunch", 350, 360)]
    got = profile_readings(dev, host)
    # gaps 100-128, 132-150, 200-210, 300-400, 500-600; the call holds
    # 28 + 18 + 10 + 20
    assert got["idle_s"] == pytest.approx(256e-9)
    assert got["idle_in_calls_pct"] == pytest.approx(100 * 76 / 256)
    # from the launch's opening, 128-300: 28 idle of 172; from the end of
    # its cudaGraphLaunch, 150-300: 10 idle of 150
    assert got["graph_idle_pct"] == pytest.approx(100 * 28 / 172)
    assert got["graph_idle_after_launch_pct"] == pytest.approx(100 * 10 / 150)
    assert (got["graph_launches"], got["launch_ranges"],
            got["graph_launches_in_launch"]) == (2, 1, 1)


def test_profile_readings_read_none_from_an_empty_profile():
    got = profile_readings([], [])
    assert got["idle_in_calls_pct"] is None and got["graph_idle_pct"] is None
    assert got["graph_idle_after_launch_pct"] is None
    assert got["graph_launches"] == got["launch_ranges"] == 0


def test_clock_agreement_reads_each_range_s_excess_over_its_span():
    """Ranges on a clock 2 ppm fast and 5 µs ahead, each opening 1 µs
    before its span and closing 2 µs after it, but one that a stall keeps
    open 30 µs longer."""
    spans, host = [], []
    for k in range(50):
        t0 = 100.0 + 0.01 * k
        spans.append(Span("launch", t0, t0 + 0.001, mirrored=True))
        r0, r1 = (round(t * (1 + 2e-6) * 1e9) + 5000
                  for t in (t0, t0 + 0.001))
        host.append(("launch", r0 - 1000,
                     r1 + 2000 + (30_000 if k == 7 else 0)))
    spans.append(Span("sync", 0.0, 1.0, mirrored=True))
    spans.append(Span("sync", 2.0, 3.0, mirrored=True))
    host.append(("sync", 0, 10))
    spans.append(Span("stage", 5.0, 6.0))          # not mirrored
    got = clock_agreement(spans, host)
    assert got["pairs"] == 50 and got["unequal"] == ["sync"]
    assert got["rate_ppm"] == pytest.approx(2.0, abs=0.1)
    med, p99, worst = got["excess_us"]
    assert med == pytest.approx(3.0, abs=0.01)
    assert worst == pytest.approx(33.0, abs=0.01)
    assert list(got["excess_us_by_name"]) == ["launch"]
    assert clock_agreement(spans[-1:], host) is None
