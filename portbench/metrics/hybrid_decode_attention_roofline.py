"""``decode_attention``'s share of its roofline in the profiled slice of a
hybrid's cell: the steps' grouped-query attention through the slab's rows
(``counts.kernels.decode_attention``: one query a row over its valid keys,
the K/V heads read once for their G query heads) at the chip's peaks over
the device time of the kernels named below."""
from portbench.metrics import roofline_pct

LAYER = "kernels"
MOVES = "tokens_per_s"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
PATTERNS = ("dec_kernel",)


def read(run):
    return roofline_pct(run, "decode_attention", PATTERNS)
