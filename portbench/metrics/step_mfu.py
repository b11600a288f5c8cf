"""The whole decode step's share of the chip's peak: the model's
operations in the window's steps over the seconds the executor measured
for them."""
from portbench import peaks
from portbench.metrics import event_flops

LAYER = "model"
MOVES = "tokens_per_s"
UNIT = "%"
SOURCE = "program_span"
BETTER = "higher"


def read(run):
    ev = event_flops(run, ("step",))
    s = sum(t for t, _ in ev)
    return 100.0 * sum(f for _, f in ev) / (s * peaks.BF16_FLOPS) if s else None
