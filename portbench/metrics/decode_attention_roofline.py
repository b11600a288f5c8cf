"""``decode_attention``'s share of its roofline in the profiled slice: the
steps' one-query attention over each row's valid keys
(``counts.kernels.decode_attention``) at the chip's peaks over the device
time of the kernels named below."""
from portbench.metrics import roofline_pct

LAYER = "kernels"
MOVES = "tokens_per_s"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
PATTERNS = ("dec_kernel",)


def read(run):
    return roofline_pct(run, "decode_attention", PATTERNS)
