import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def one_thread():
    """The suite's workers share the machine's cores: a run here takes one
    of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def in_process(monkeypatch, one_thread):
    """A run inside the test process: pytest's workers hold modules that
    other test files loaded (``jax``, ``repro``), which ``run.py``'s own
    process never does and ``test_portbench_imports`` checks; here the
    harness's look at ``sys.modules`` is left out."""
    from portbench import harness
    monkeypatch.setattr(harness, "forbidden", lambda modules: [])
