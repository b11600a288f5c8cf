"""Run one cell of the port's benchmark (see ``portbench/harness.py``):

    python3 portbench/run.py --workload minicpm-2b.chat --seed 1 \
        --seconds 40 --trace 0
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
