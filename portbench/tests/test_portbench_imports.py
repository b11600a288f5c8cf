"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX package
``repro``; the reference imports nothing of ``repro_torch`` either.  Names
are compared by their top-level module name, whole."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import forbidden

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_top_level_names_are_compared_whole():
    assert forbidden(["repro_torch", "repro_torch.core.sgs", "numpy",
                      "jaxtyping", "reprolib", "flaxen"]) == []
    assert forbidden(["repro.core.sgs"]) == ["repro"]
    assert forbidden(["repro"]) == ["repro"]
    assert forbidden(["jax.numpy", "jaxlib.xla_client", "flax.linen",
                      "repro_torch"]) == ["flax", "jax", "jaxlib"]


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")
    if "__pycache__" not in p.parts))
def test_no_file_of_the_benchmark_imports_the_jax_stack(path):
    names = set(imported(BENCH / path))
    assert forbidden(names) == []
    if path.startswith("reference/"):
        assert names <= {"__future__", "contextlib", "importlib", "math",
                         "typing", "torch"}, names


def test_the_reference_and_judge_load_nothing_of_the_program():
    code = ("import sys, json\n"
            "import portbench.judge, portbench.weights\n"
            "import portbench.reference.dense, portbench.reference.mamba2\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
