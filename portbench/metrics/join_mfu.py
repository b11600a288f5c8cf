"""The whole join's share of the chip's peak: the model's operations in the
window's joins over the seconds the executor measured for them."""
from portbench import peaks
from portbench.metrics import event_flops

LAYER = "model"
MOVES = "latency_p95_ms"
UNIT = "%"
SOURCE = "program_span"
BETTER = "higher"


def read(run):
    ev = event_flops(run, ("join",))
    s = sum(t for t, _ in ev)
    return 100.0 * sum(f for _, f in ev) / (s * peaks.BF16_FLOPS) if s else None
