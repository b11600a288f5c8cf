"""The end-to-end and per-layer arithmetic on hand-built records."""

import numpy as np
import pytest

from portbench import metrics, record
from portbench.counts import dense, kernels
from portbench.profiling import Slice
from portbench.system import Event

TRAFFIC = {"prompt_len": 4, "gen_len": 2, "limit_ms": 1000.0}
DIMS = {"d_model": 8, "n_layers": 2, "n_heads": 2, "n_kv_heads": 2,
        "head_dim": 4, "d_ff": 16, "vocab_size": 300}


def make_run(arrival, completion, first=None, events=(), keys=(),
             slice_=None, wall=2.0, counters=None):
    arrival = np.asarray(arrival, dtype=float)
    completion = np.asarray(completion, dtype=float)
    return record.Run(
        cell="x", traffic=TRAFFIC, dims=DIMS, counts=dense, setup_s=3.0,
        wall_s=wall, horizon=15.0, arrival=arrival,
        completion=completion,
        first_token=completion if first is None else np.asarray(first),
        cold_starts=2, queuing=np.array([0.1, 0.3] + [0.0] *
                                        (len(arrival) - 2)),
        counters=counters or {"n_decode_ticks": 4, "n_step_slots": 10},
        events=list(events), keys=list(keys), slice=slice_)


def test_nearest_rank_percentile():
    xs = np.arange(1, 21, dtype=float)          # 1..20
    assert record.nearest_rank(xs, 95) == 19.0
    assert record.nearest_rank(xs, 100) == 20.0
    assert record.nearest_rank(np.array([7.0]), 95) == 7.0


def test_a_failed_request_counts_as_missing():
    arr = np.zeros(20)
    comp = np.full(20, 0.5)
    run = make_run(arr, comp)
    assert record.latency_p95_ms(run) == pytest.approx(500.0)
    assert record.deadline_met_pct(run) == 100.0
    assert record.tokens_per_s(run) == pytest.approx(20 * 3 / 2.0)
    comp[3] = np.nan                            # never completed
    run = make_run(arr, comp)
    assert record.deadline_met_pct(run) == pytest.approx(95.0)
    assert record.tokens_per_s(run) == pytest.approx(19 * 3 / 2.0)
    # it runs to the end of the run's clock: the p95 of 20 is the 19th
    comp[4] = np.nan
    run = make_run(arr, comp)
    assert record.latency_p95_ms(run) == pytest.approx(15000.0)
    assert record.ttft_p95_ms(run) == pytest.approx(15000.0)


def test_a_stall_moves_the_p95():
    arr = np.arange(40) * 0.1
    comp = arr + 0.2
    base = record.latency_p95_ms(make_run(arr, comp))
    assert base == pytest.approx(200.0)
    stalled = comp.copy()
    stalled[10:14] += 0.9           # one stall holds back four requests
    assert record.latency_p95_ms(make_run(arr, stalled)) == pytest.approx(
        1100.0)
    assert record.deadline_met_pct(make_run(arr, stalled)) == 90.0


def test_per_layer_readers():
    ev = [Event("join", 0.0, (0, 1), (0, 1), 0.02, True, 100.0),
          Event("step", 0.02, (0, 1), (), 0.01, True, 100.025),
          Event("step", 0.03, (0, 1), (), 0.01, False, 100.039)]
    keys = [None, [5, 5], [6, 6]]
    sl = Slice(busy_s=0.5, window_s=2.0,
               kernel_s={"void fa_kernel_persist<64>": 1e-4,
                         "dec_kernel_tc<64>": 2e-5, "gemm": 1.0},
               device_ops=[], idle_gaps=[])
    run = make_run([0, 0], [0.04, 0.04], events=ev, keys=keys, slice_=sl)
    read = {n: metrics.load(n).read(run) for n in (
        "host_ms", "queue_ms", "decode_occupancy", "step_ms",
        "join_ms", "idle_pct", "mfu", "join_mfu", "step_mfu",
        "flash_attention_roofline", "decode_attention_roofline",
        "ssd_scan_roofline")}
    # 5 ms after the join, 4 ms after the first step
    assert read["host_ms"] == pytest.approx(4.5)
    assert read["queue_ms"] == pytest.approx(200.0)
    assert read["decode_occupancy"] == 2.5
    assert read["step_ms"] == pytest.approx(10.0)
    assert read["join_ms"] == pytest.approx(20.0)
    assert read["idle_pct"] == pytest.approx(75.0)
    jf = dense.join_flops(DIMS, 2, 4)
    sf = dense.step_flops(DIMS, [5, 5]) + dense.step_flops(DIMS, [6, 6])
    assert read["mfu"] == pytest.approx(100 * (jf + sf) / (2.0 * 989e12))
    assert read["join_mfu"] == pytest.approx(100 * jf / (0.02 * 989e12))
    assert read["step_mfu"] == pytest.approx(100 * sf / (0.02 * 989e12))
    f, b = kernels.flash_attention(2, 4, 2, 2, 4)
    bound = 2 * max(f / 989e12, b / 3.35e12)        # one launch a layer
    assert read["flash_attention_roofline"] == pytest.approx(
        100 * bound / 1e-4)
    # only the step inside the slice counts
    f, b = kernels.decode_attention([5, 5], 2, 2, 4)
    assert read["decode_attention_roofline"] == pytest.approx(
        100 * 2 * max(f / 989e12, b / 3.35e12) / 2e-5)
    assert read["ssd_scan_roofline"] is None        # no such launch


def test_host_ms_leaves_out_the_calls_a_profiled_slice_overlaps():
    ev = [Event("step", 0.01 * i, (0,), (), 0.01, False, 100.0 + 0.012 * i)
          for i in range(6)]
    ev[3].wall += 5.0                   # the profiler's start and stop
    ev[4].wall += 5.0
    ev[5].wall += 5.0
    sl = Slice(busy_s=0.5, window_s=2.0, kernel_s={}, device_ops=[],
               idle_gaps=[], profiled=[(100.03, 105.04)])
    run = make_run([0], [0.1], events=ev, keys=[[5]] * 6, slice_=sl)
    assert metrics.load("host_ms").read(run) == pytest.approx(2.0)
    # without the slice's span the profiler's seconds would count
    sl.profiled = []
    assert metrics.load("host_ms").read(run) == pytest.approx(1002.0)
    assert metrics.load("host_ms").read(make_run([0], [0.1])) is None


def test_rooflines_and_idle_read_nothing_without_a_slice():
    run = make_run([0], [0.1], events=[
        Event("join", 0.0, (0,), (0,), 0.01, False)], keys=[None])
    for n in ("flash_attention_roofline", "decode_attention_roofline",
              "idle_pct"):
        assert metrics.load(n).read(run) is None
    assert metrics.load("step_ms").read(run) is None


def test_every_metric_file_matches_benchmark_json():
    from portbench.cells import load_benchmark
    bench = load_benchmark()
    for m in bench["per_layer"]:
        mod = metrics.load(m["name"])
        assert (mod.LAYER, mod.MOVES, mod.UNIT, mod.SOURCE, mod.BETTER) == (
            m["layer"], m["moves"], m["unit"], m["source"], m["better"]), \
            m["name"]
    names = {m["name"] for m in bench["end_to_end"]}
    assert names == set(record.END_TO_END)
