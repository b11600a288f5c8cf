"""Multi-tenant serving on the PyTorch port: four apps spanning
architecture families (dense, SSM, MoE, VLM pipeline) share one cluster
under Archipelago; a two-stage vision DAG exercises DAG-aware scheduling.
Real PyTorch execution via the ``torch`` backend — the whole run is one
declarative ``Experiment`` through the same ``simulate`` pipeline as the
paper-figure simulations.  The twin of ``examples/multitenant_serving.py``;
it runs on the card unless ``--device cpu`` is given (and raises without
CUDA).

    python examples/multitenant_serving_torch.py [--device cpu]
(works after `pip install -e .` or with PYTHONPATH=src)
"""
import argparse
import os
import sys

try:
    import repro_torch  # noqa: F401
except ImportError:  # no editable install: fall back to the checkout layout
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core import ClusterConfig
from repro_torch.device import device_name, resolve_device
from repro_torch.serving import multitenant_apps
from repro_torch.sim import Experiment, simulate


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    apps = multitenant_apps()
    print(f"calibrating 5 models on {device_name(dev)}...")
    r = simulate(Experiment(
        stack="archipelago",
        backend="torch",
        backend_kwargs=dict(device=str(dev)),
        workload_factory="serving_apps",
        workload_kwargs=dict(apps=apps, duration=10.0, rps=3.0,
                             prewarm_per_fn=3),
        cluster=ClusterConfig(n_sgs=3, workers_per_sgs=2,
                              cores_per_worker=2),
        # report past the pre-warm transient
        warmup=4.0, drain=15.0))
    for name, spec in sorted(r.sim.backend.fn_specs.items()):
        print(f"  {name}: exec={spec.exec_time*1e3:.1f}ms "
              f"setup={spec.setup_time:.1f}s")
    for dag_id, cs in sorted(r.per_class.items()):
        print(f"{dag_id}: n={cs.n_requests} done={cs.n_completed} "
              f"p50={(cs.p50 or 0)*1e3:.1f}ms p99={(cs.p99 or 0)*1e3:.1f}ms "
              f"deadlines_met={(cs.deadline_met_frac or 0)*100:.2f}% "
              f"cold_starts={cs.cold_starts}")
    print(f"real executions: {r.sim.backend.counters()['n_executions']}; "
          f"SGSs used: {[s for s in r.sim.lbs.sgss]}")
    assert r.n_completed == r.n_requests
    print("OK")


if __name__ == "__main__":
    main()
