"""``flash_attention``'s share of its roofline in the profiled slice: the
joins' causal attention (``counts.kernels.flash_attention``) at the chip's
peaks over the device time of the kernels named below."""
from portbench.metrics import roofline_pct

LAYER = "kernels"
MOVES = "latency_p95_ms"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
PATTERNS = ("fa_kernel", "fa_hd256")


def read(run):
    return roofline_pct(run, "flash_attention", PATTERNS)
