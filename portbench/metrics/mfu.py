"""The model's operations in every join and step of the window over the
window's wall time at the chip's bf16 peak."""
from portbench import peaks
from portbench.metrics import event_flops

LAYER = "model"
MOVES = "tokens_per_s"
UNIT = "%"
SOURCE = "program_span"
BETTER = "higher"


def read(run):
    f = sum(f for _, f in event_flops(run))
    return 100.0 * f / (run.wall_s * peaks.BF16_FLOPS) if f else None
