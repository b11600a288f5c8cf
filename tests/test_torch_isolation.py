"""The port stands alone: it loads neither jax nor the JAX package, and its
entry points never carry on quietly on the CPU when CUDA is absent."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import BatchedTorchBackend, TorchBackend  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.serving import (BatchingTorchExecutor,  # noqa: E402
                                 ContinuousTorchExecutor, ServedModel,
                                 TorchModelExecutor)

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "examples" / "train_small_torch.py"]


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = ("import sys\n"
            "import repro_torch, repro_torch.launch.serve\n"
            "import repro_torch.train, repro_torch.launch.train\n"
            "import repro_torch.kernels, repro_torch.models\n"
            "import repro_torch.core, repro_torch.sim, repro_torch.serving\n"
            "from repro_torch.sim import get_workload_factory\n"
            "get_workload_factory('serving_apps')\n"
            "from repro_torch.launch.serve import main\n"
            "main(['--backend', 'torch-batched', '--batching', "
            "'continuous', '--device', 'cpu', '--requests', '4', "
            "'--rps', '4', '--prompt', '8', '--gen', '1'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_neither_jax_nor_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}: imports {n}"


def test_entry_points_refuse_to_fall_back_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("minicpm-2b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(cfg, 1, 8)
    for executor in (ContinuousTorchExecutor, TorchModelExecutor,
                     BatchingTorchExecutor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            executor({"f": ServedModel(cfg)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(cfg, n_requests=1, rps=1.0, prompt_len=4, gen_len=1,
              max_batch=1)
    for backend in (TorchBackend, BatchedTorchBackend):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            backend()
