"""The port's control plane against the JAX package's: the equivalence
goldens, ``simulate`` under every stack, a traffic scenario and fault plans
(modeled, stub and stub-batched backends), and the registries.

The control plane is plain Python and numpy in both packages, so the two
must make the same decision at every step: results are compared whole,
``wall_s`` (the one wall-clock field) aside.
"""
import hashlib
import inspect
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.sim as jsim  # noqa: E402
import repro.serving  # noqa: E402,F401  (registers the JAX "serving_apps")
import repro_torch.core as tcore  # noqa: E402
import repro_torch.serving  # noqa: E402,F401
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.core.backends import _BACKENDS as T_BACKENDS  # noqa: E402
from repro_torch.core.fault import _FAULTS as T_FAULTS  # noqa: E402
from repro_torch.core.stacks import _STACKS as T_STACKS  # noqa: E402
from repro_torch.sim.traffic import _TRAFFIC as T_TRAFFIC  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "golden_equivalence.json"
sys.path.insert(0, str(ROOT))
from benchmarks.equivalence_fingerprint import CONFIGS  # noqa: E402

STACKS = ["archipelago", "baseline", "fifo", "pull", "sparrow"]


def _hex(x) -> str:
    return "none" if x is None else float(x).hex()


def fingerprint_one(name: str) -> dict:
    """``benchmarks/equivalence_fingerprint.py::fingerprint_one`` against
    the port's ``run_archipelago``."""
    cfg = CONFIGS[name]
    kind, wkw = cfg["workload"]
    spec = (tsim.paper_workload_1 if kind == "wl1"
            else tsim.paper_workload_2)(**wkw)
    assert "workload_method" in inspect.signature(
        tsim.run_archipelago).parameters
    res = tsim.run_archipelago(
        spec, cluster=tcore.ClusterConfig(**cfg["cluster"]),
        sgs_cfg=tcore.SGSConfig(**cfg["sgs"]), seed=cfg["seed"],
        workload_method="legacy")
    m = res.metrics
    h = hashlib.sha256()
    for r in m.requests:
        h.update((f"{_hex(r.arrival_time)}|{_hex(r.completion_time)}|"
                  f"{r.n_cold_starts}|{r.sgs_id}|"
                  f"{_hex(r.total_queuing_delay)}\n").encode())
    sgss = [res.lbs.sgss[k] for k in sorted(res.lbs.sgss)]
    return {
        "n_requests": len(m.requests),
        "n_completed": len(m.completed),
        "cold_starts": [s.n_cold_starts for s in sgss],
        "warm_hits": [s.n_warm_hits for s in sgss],
        "allocations": [s.sandboxes.n_allocations for s in sgss],
        "soft_evictions": [s.sandboxes.n_soft_evictions for s in sgss],
        "hard_evictions": [s.sandboxes.n_hard_evictions for s in sgss],
        "revivals": [s.sandboxes.n_revivals for s in sgss],
        "n_events": res.env.n_events,
        "timeline_sha256": h.hexdigest(),
    }


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_archipelago_reproduces_the_equivalence_golden(name):
    got, want = fingerprint_one(name), json.loads(GOLDEN.read_text())[name]
    assert {k: got[k] for k in want} == want


# -- simulate: the same result in both packages ------------------------------


def _experiment(pkg, stack="archipelago", backend="modeled",
                backend_kwargs=None, traffic=None, faults=None):
    """One small paper_workload_1 cell; ``faults`` names plan events built
    from the package's own constructors."""
    core, sim = pkg
    plan = None
    if faults == "worker_crash":
        plan = core.FaultPlan(events=(core.worker_crash(k=2, at=1.0),
                                      core.worker_crash(k=1, at=2.5)),
                              seed=1)
    elif faults == "sgs_failstop":
        plan = core.FaultPlan(events=(core.sgs_failstop(at=1.5, sgs=1),),
                              seed=2)
    return sim.Experiment(
        stack=stack, backend=backend, backend_kwargs=dict(backend_kwargs or {}),
        workload_factory="paper_workload_1",
        workload_kwargs=dict(duration=4.0, scale=0.02, dags_per_class=1,
                             seed=7),
        cluster=core.ClusterConfig(n_sgs=2, workers_per_sgs=3,
                                   cores_per_worker=4, pool_mem_mb=1024.0),
        warmup=1.0, drain=6.0, seed=3, traffic=traffic, faults=plan)


def _same_result(**kw):
    rows = [sim.simulate(_experiment((core, sim), **kw)).to_dict()
            for core, sim in ((jcore, jsim), (tcore, tsim))]
    for r in rows:
        del r["wall_s"]
    assert rows[0] == rows[1]
    assert rows[1]["n_completed"] > 0
    return rows[1]


@pytest.mark.parametrize("stack", STACKS)
def test_modeled_simulate_matches_jax_under_every_stack(stack):
    _same_result(stack=stack)


@pytest.mark.parametrize("traffic,faults", [
    ("flash_crowd", None), (None, "worker_crash"), (None, "sgs_failstop")])
def test_modeled_simulate_matches_jax_with_traffic_and_faults(traffic, faults):
    row = _same_result(traffic=traffic, faults=faults)
    if faults:
        assert row["fault_events"]
        acc = row["accounting"]
        assert acc["lost"] == 0 and acc["duplicate_completions"] == 0


@pytest.mark.parametrize("backend,kwargs", [
    ("stub", dict(exec_time=0.05, setup_time=0.3)),
    ("stub-batched", dict(exec_time=0.05, batch_window=0.02, max_batch=4)),
    ("stub-batched", dict(exec_time=0.05, batching="continuous", n_steps=4,
                          max_batch=4)),
], ids=["stub", "stub-batched-windowed", "stub-batched-continuous"])
@pytest.mark.parametrize("faults", [None, "worker_crash"])
def test_stub_simulate_matches_jax(backend, kwargs, faults):
    row = _same_result(backend=backend, backend_kwargs=kwargs, faults=faults)
    assert row["backend_counters"]["n_executions"] > 0


# -- registries -------------------------------------------------------------------


def test_registries_list_the_same_names():
    """Each package's built-in names, read in a fresh process (other test
    files register test-only names in this one)."""
    code = ("import json\n"
            "import repro.core, repro.sim, repro.serving\n"
            "import repro_torch.core, repro_torch.sim, repro_torch.serving\n"
            "print(json.dumps({p: [c.available_stacks(), c.available_faults(),"
            " s.available_traffic(), s.available_workloads(),"
            " c.available_backends()] for p, c, s in ("
            "('jax', repro.core, repro.sim),"
            " ('torch', repro_torch.core, repro_torch.sim))}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    names = json.loads(r.stdout.splitlines()[-1])
    jax_names, torch_names = names["jax"], names["torch"]
    assert torch_names[0] == STACKS
    assert torch_names[:4] == jax_names[:4]
    swap = {"jax": "torch", "jax-batched": "torch-batched"}
    assert torch_names[4] == sorted(swap.get(n, n) for n in jax_names[4])


@pytest.mark.parametrize("kind", ["stack", "backend", "workload", "fault",
                                  "traffic"])
def test_registering_in_one_package_leaves_the_other_alone(kind):
    name = f"test-only-{kind}"
    port = {"stack": (tcore.register_stack, T_STACKS,
                      jcore.available_stacks),
            "backend": (tcore.register_backend, T_BACKENDS,
                        jcore.available_backends),
            "workload": (tsim.register_workload,
                         tsim.experiment.WORKLOAD_FACTORIES,
                         jsim.available_workloads),
            "fault": (tcore.register_fault, T_FAULTS,
                      jcore.available_faults),
            "traffic": (tsim.register_traffic, T_TRAFFIC,
                        jsim.available_traffic)}
    register, registry, jax_names = port[kind]
    before = jax_names()
    obj = type(name.replace("-", "_"), (tcore.ExecutionBackend,), {}) \
        if kind in ("stack", "backend") else (lambda *a, **k: None)
    register(name)(obj)
    try:
        assert name in registry
        assert jax_names() == before and name not in before
    finally:
        del registry[name]
