"""``ssd_scan``'s share of its roofline in the profiled slice: the joins'
chunked state-space scan (``counts.kernels.ssd_scan``) at the chip's peaks
over the device time of the kernels named below."""
from portbench.metrics import roofline_pct

LAYER = "kernels"
MOVES = "latency_p95_ms"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
PATTERNS = ("ssd_kernel",)


def read(run):
    return roofline_pct(run, "ssd_scan", PATTERNS)
