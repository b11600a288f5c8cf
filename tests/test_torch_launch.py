"""The port's serving launcher (``python -m repro_torch.launch.serve``)
against the JAX package's (``python -m repro.launch.serve``): the same
lines for the scripted backends, the same request counts for the real
ones on the CPU, ``--device`` in place of ``--kernels``, and
``configs.all_configs``."""
import dataclasses
import re
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import all_configs as j_all_configs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.configs import all_configs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.config import PORT_ONLY, ModelConfig  # noqa: E402

SCRIPTED = [["--backend", "modeled"], ["--backend", "stub"],
            ["--backend", "stub-batched"],
            ["--backend", "stub-batched", "--batching", "continuous"]]
# (arch, the port's backend flags, the reference's for the same run)
REAL = [("minicpm-2b", ["--backend", "torch"],
         ["--backend", "jax", "--kernels", "xla"]),
        ("mamba2-370m",
         ["--backend", "torch-batched", "--batching", "continuous"],
         ["--backend", "jax-batched", "--batching", "continuous",
          "--kernels", "xla"])]
SMALL = ["--requests", "8", "--rps", "4", "--prompt", "16", "--gen", "2"]
RESULT = re.compile(r" n=(\d+) done=(\d+) ")


def _reference(monkeypatch, capsys, argv, drain=None):
    """``repro.launch.serve.main()`` on ``argv``; ``drain`` replaces its
    experiment's drain (simulated seconds after the last arrival)."""
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *argv])
    if drain is not None:
        make = jserve.Experiment
        monkeypatch.setattr(jserve, "Experiment",
                            lambda **kw: make(**{**kw, "drain": drain}))
    jserve.main()
    return capsys.readouterr().out


def _port(capsys, argv):
    tserve.main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("flags", SCRIPTED, ids=lambda f: "-".join(f[1::2]))
def test_scripted_backends_print_the_reference_lines(monkeypatch, capsys,
                                                     flags):
    argv = [*flags, "--requests", "20", "--rps", "10"]
    want = _reference(monkeypatch, capsys, argv)
    got = _port(capsys, argv)
    assert got == want
    assert RESULT.search(got)


@pytest.mark.parametrize("case", REAL, ids=lambda c: c[0])
def test_torch_backends_serve_on_the_cpu_as_the_jax_ones(monkeypatch,
                                                         capsys, case):
    """Every request completed on the CPU, the data plane names it, and
    the request and completion counts are the reference's.  The
    reference's host-timed compiles advance its simulated clock, so on a
    loaded host its requests can outlast its 10 s drain: it runs with a
    drain that no compile outlasts.  Latencies, deadlines met and cold
    starts follow host-timed calibration: not compared."""
    arch, flags, jflags = case
    got = _port(capsys, ["--arch", arch, *flags, "--device", "cpu", *SMALL])
    want = _reference(monkeypatch, capsys, ["--arch", arch, *jflags, *SMALL],
                      drain=3600.0)
    n, done = RESULT.search(got).groups()
    assert int(n) > 0 and n == done
    assert (n, done) == RESULT.search(want).groups()
    assert "device=cpu" in got and "[serve] calibrating" in got


def test_without_device_the_launcher_runs_on_the_card(monkeypatch, capsys):
    """No ``--device``: CUDA, which raises where it is missing; nothing
    runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--backend", "torch", *SMALL])
    assert "done=" not in capsys.readouterr().out


def test_kernels_is_refused_and_device_reaches_only_the_torch_backends(
        capsys):
    with pytest.raises(SystemExit):
        tserve.parse_args(["--kernels", "xla"])
    assert "unrecognized arguments: --kernels" in capsys.readouterr().err
    args = tserve.parse_args([])
    assert (args.backend, args.device) == ("torch", None)
    cfg = all_configs(reduced=True)["minicpm-2b"]
    exp = tserve.build_experiment(args, cfg)
    assert exp.backend_kwargs == {"device": None}
    assert exp.warmup == args.requests / args.rps / 2
    stub = tserve.build_experiment(
        tserve.parse_args(["--backend", "stub-batched", "--device", "cpu"]),
        cfg)
    assert "device" not in stub.backend_kwargs and stub.warmup == 0.0


@pytest.mark.parametrize("reduced", [False, True])
def test_all_configs_equal_the_reference(reduced):
    """Every config the launcher can name equals the JAX package's, the
    port's own fields (``PORT_ONLY``) at their defaults."""
    got, want = all_configs(reduced), j_all_configs(reduced)
    assert list(got) == list(want)
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)
                if f.name in PORT_ONLY}
    for arch, cfg in got.items():
        j = dataclasses.asdict(want[arch])
        j.pop("kernels")
        t = dataclasses.asdict(cfg)
        assert {n: t.pop(n) for n in PORT_ONLY} == defaults, arch
        assert t == j, arch
