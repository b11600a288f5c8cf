import os
import sys

# Smoke tests and benches must see the host's real (single) CPU device —
# only launch/dryrun.py forces 512 placeholder devices.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Let `python -m pytest` work from a bare checkout: prefer an installed
# `repro` (pip install -e .) or PYTHONPATH=src, else fall back to src/.
try:
    import repro  # noqa: F401
except ImportError:                                     # pragma: no cover
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
