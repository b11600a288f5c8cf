"""The port's sharded parallel core (``repro_torch.sim.shard``): the cases
of ``tests/test_shards.py`` on the port, and its rows against the JAX
package's.

Cross-shard determinism is a hard contract: the same seed must produce an
``ExperimentResult`` byte-identical to the single-process path at ANY shard
count and ANY partition of SGS ids.  The refusals include the port's own
on-device backends (``torch``, ``torch-batched``), as the JAX package
refuses ``jax`` and ``jax-batched``.
"""
import json

import pytest

pytest.importorskip("torch")

import repro.sim as jsim  # noqa: E402
from repro_torch.core.autoscale import AutoscaleConfig  # noqa: E402
from repro_torch.core.fault import FaultPlan, worker_crash  # noqa: E402
from repro_torch.sim import Experiment, run_sweep, simulate  # noqa: E402
from repro_torch.sim.shard import (default_partition,  # noqa: E402
                                   simulate_sharded, validate_shardable)


def _canonical(result):
    """JSON bytes of one result row with the wall-clock field normalized —
    everything else must match bit-for-bit."""
    d = result.to_dict()
    d["wall_s"] = 0.0
    return json.dumps(d, sort_keys=True)


def _kw(**kw):
    kw.setdefault("workload_factory", "paper_workload_1")
    kw.setdefault("workload_kwargs",
                  dict(duration=2.0, scale=0.5, dags_per_class=2))
    kw.setdefault("drain", 3.0)
    return kw


def _base(**kw):
    return Experiment(**_kw(**kw))


# ---------------------------------------------------------------------------
# Row identity: sharded vs sequential, and against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_sharded_rows_byte_identical(shards):
    seq = simulate(_base(seed=4))
    shd = simulate(_base(seed=4, shards=shards))
    assert _canonical(shd) == _canonical(seq)


def test_sharded_rows_equal_the_jax_packages():
    """The same sharded experiment in both packages gives the same row."""
    port = simulate(_base(seed=5, shards=3))
    ref = jsim.simulate(jsim.Experiment(**_kw(seed=5, shards=3)))
    assert port.n_completed > 0
    assert _canonical(port) == _canonical(ref)


def test_sharded_identity_under_scale_out_and_autoscale():
    """The hard case: an overloaded run whose DAGs scale out to multi-SGS
    active sets (stall barriers + cross-shard preallocations + lottery
    reads) with the LBS replica autoscaler ticking — every scaling decision
    and every latency must still match the sequential run exactly."""
    kw = dict(workload_kwargs=dict(duration=3.0, scale=4.0),
              seed=3, autoscale=AutoscaleConfig())
    seq = simulate(_base(**kw))
    shd = simulate(_base(**kw, shards=4))
    assert seq.scaling_events          # the scenario must exercise scaling
    assert _canonical(shd) == _canonical(seq)


def test_shards_one_and_none_use_sequential_path():
    seq = simulate(_base(seed=0))
    one = simulate(_base(seed=0, shards=1))
    assert _canonical(one) == _canonical(seq)


def test_shard_stats_telemetry():
    r = simulate(_base(seed=1, shards=2))
    st = r.sim.shard_stats
    assert st["shards"] == 2
    assert len(st["shard_events"]) == 2
    assert st["n_epochs"] > 0
    assert st["barrier_wait_s"] >= 0.0
    # exact event-count decomposition: parent + shards == the run's total
    assert st["parent_events"] + sum(st["shard_events"]) == r.n_events
    # telemetry must never leak into the result row (byte-identity contract)
    assert "shard_stats" not in r.to_dict()


# ---------------------------------------------------------------------------
# Partition invariance
# ---------------------------------------------------------------------------

_PARTITIONS = [
    [[0, 1, 2, 3], [4, 5, 6, 7]],           # contiguous halves
    [[0, 2, 4, 6], [1, 3, 5, 7]],           # interleaved
    [[7, 0], [3, 5, 1], [6], [2, 4]],       # ragged, shuffled within shards
    [[5], [2], [0], [7], [1], [4], [6], [3]],   # singletons, shuffled order
]


@pytest.mark.parametrize("partition", _PARTITIONS)
def test_any_partition_yields_identical_rows(partition):
    seq = simulate(_base(seed=6))
    shd = simulate_sharded(_base(seed=6, shards=len(partition)),
                           partition=partition)
    assert _canonical(shd) == _canonical(seq)


def test_default_partition_covers_and_balances():
    p = default_partition(10, 3)
    assert sorted(x for part in p for x in part) == list(range(10))
    assert max(len(part) for part in p) - min(len(part) for part in p) <= 1


@pytest.mark.parametrize("bad", [
    [[0, 1], [1, 2, 3, 4, 5, 6, 7]],        # duplicate id
    [[0, 1, 2], [4, 5, 6, 7]],              # missing id
    [[0, 1, 2, 3, 4, 5, 6, 7], []],         # empty shard
])
def test_bad_partitions_rejected(bad):
    with pytest.raises(ValueError):
        simulate_sharded(_base(seed=0, shards=len(bad)), partition=bad)


# ---------------------------------------------------------------------------
# Validation gates
# ---------------------------------------------------------------------------


def test_validate_rejects_non_archipelago_stack():
    with pytest.raises(ValueError, match="archipelago"):
        simulate(_base(seed=0, shards=2, stack="fifo"))


@pytest.mark.parametrize("backend,kwargs", [
    ("stub", {}),
    ("torch", dict(device="cpu")),
    ("torch-batched", dict(device="cpu", batching="continuous")),
])
def test_validate_rejects_non_modeled_backend(backend, kwargs):
    """Refused before any model is built: the sharded core's shard
    processes own their data plane, which a card-timed backend cannot
    split."""
    with pytest.raises(ValueError, match="modeled"):
        simulate(_base(seed=0, shards=2, backend=backend,
                       backend_kwargs=kwargs))


def test_validate_rejects_more_shards_than_sgs():
    with pytest.raises(ValueError, match="exceeds"):
        simulate(_base(seed=0, shards=9))   # default cluster: 8 SGSs


def test_validate_rejects_hooks():
    exp = _base(seed=0, shards=2)
    with pytest.raises(ValueError, match="hooks"):
        validate_shardable(exp, hooks=[(0.5, lambda env, stack: None)])


def test_validate_rejects_fault_plans():
    exp = _base(seed=0, shards=2,
                faults=FaultPlan(events=(worker_crash(k=1, at=1.0),)))
    with pytest.raises(ValueError, match="fault"):
        simulate(exp)


# ---------------------------------------------------------------------------
# Sweep integration: shards as an axis, daemonic fallback
# ---------------------------------------------------------------------------


def test_shards_is_a_sweepable_axis():
    base = _base(seed=2)
    sweep = run_sweep(base, {"shards": [None, 2, 4]})
    rows = sweep.rows
    assert [r["cell"]["shards"] for r in rows] == [None, 2, 4]
    ref = json.dumps({**rows[0]["result"], "wall_s": 0.0}, sort_keys=True)
    for r in rows[1:]:
        assert json.dumps({**r["result"], "wall_s": 0.0},
                          sort_keys=True) == ref


def test_daemonic_pool_workers_fall_back_sequentially():
    """Inside run_sweep(workers=N) the pool's daemonic children cannot
    spawn shard processes; simulate() honors the request with the
    (identical) sequential path instead of crashing."""
    base = _base(seed=2)
    seq = run_sweep(base, {"shards": [None, 2]}, workers=1)
    par = run_sweep(base, {"shards": [None, 2]}, workers=2)

    def norm(rows):
        return json.dumps(
            [{**r, "result": {**r["result"], "wall_s": 0.0}} for r in rows],
            sort_keys=True)

    assert norm(par.rows) == norm(seq.rows)
