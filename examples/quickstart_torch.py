"""Quickstart on the PyTorch port: serve a small model through the full
Archipelago stack (LBS -> SGS -> workers) via the declarative experiment
API, with REAL PyTorch execution beneath the sandbox abstraction
(backend="torch").  The twin of ``examples/quickstart.py``; it runs on the
card unless ``--device cpu`` is given (and raises without CUDA).

    python examples/quickstart_torch.py [--device cpu]
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

from repro_torch.configs import get_config
from repro_torch.core import ClusterConfig
from repro_torch.device import device_name, resolve_device
from repro_torch.serving import ServedModel, ServingApp
from repro_torch.sim import Experiment, simulate


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    # one tenant app: a chat-style model (reduced minicpm-2b family)
    app = ServingApp(
        dag_id="chat",
        models={"chat/generate": ServedModel(
            get_config("minicpm-2b", reduced=True),
            prompt_len=32, gen_len=4, batch=2)},
        slack=0.5,
    )
    print(f"simulating with backend='torch' on {device_name(dev)} "
          f"(calibration builds the model: this is the real sandbox setup "
          f"cost Archipelago hides)...")
    # the serving workload pre-warms sandboxes before traffic (the "DAG
    # upload" step, §3); warmup=5s reports the steady-state window so the
    # cold transient doesn't drown the percentiles
    r = simulate(Experiment(
        stack="archipelago",
        backend="torch",
        backend_kwargs=dict(device=str(dev)),
        workload_factory="serving_apps",
        workload_kwargs=dict(apps=[app], duration=8.0, rps=10.0,
                             prewarm_per_fn=4),
        cluster=ClusterConfig(n_sgs=2, workers_per_sgs=2,
                              cores_per_worker=2),
        warmup=5.0, drain=10.0))
    for name, spec in r.sim.backend.fn_specs.items():
        print(f"  calibrated {name}: exec={spec.exec_time*1e3:.1f}ms "
              f"setup={spec.setup_time:.2f}s "
              f"(SNE={spec.setup_time/spec.exec_time:.0f}x -- the paper's "
              f"T3 regime)")
    print(f"  steady state: n={r.n_requests} done={r.n_completed} "
          f"p50={(r.latency_percentiles['p50'] or 0)*1e3:.1f}ms "
          f"p99={(r.latency_percentiles['p99'] or 0)*1e3:.1f}ms "
          f"deadlines_met={(r.deadline_met_frac or 0)*100:.1f}% "
          f"cold_starts={r.cold_start_count}")
    print(f"real model executions: "
          f"{r.sim.backend.counters()['n_executions']}")
    assert r.n_completed > 0
    assert r.deadline_met_frac > 0.5, "most requests should meet deadline"
    print("OK")


if __name__ == "__main__":
    main()
