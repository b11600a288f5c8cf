"""The readings a cell's correctness limit is set from, on the chip
(``portbench/control.py``):

    python3 portbench/readings.py --workload minicpm-2b.chat --seconds 10 \
        --seeds 1 2 3 4 5 6 7 8 9 10 11 12 --control-seeds 1 2 3

Prints one JSON line per seed, then the lower and upper readings.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from portbench import cells, harness  # noqa: E402
from portbench.control import readings  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="portbench/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--smoke", action="store_true")
    a = p.parse_args(argv)
    cell = cells.find_cell(a.workload)
    try:
        s = harness.set_up(cell, a.smoke, a.seeds[0])
    except SystemExit as e:
        return int(e.code)
    rows = readings(s, a.seeds, set(a.control_seeds), a.seconds)
    prog = [r["program_gap"] for r in rows]
    ctl = [r["control_gap"] for r in rows if "control_gap" in r]
    print(json.dumps({"workload": a.workload, "lower": max(prog),
                      "upper": min(ctl) if ctl else None,
                      "card": harness.power_limit(),
                      "seconds": time.perf_counter() - T_START}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
