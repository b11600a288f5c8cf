"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W): the
yardstick of every roofline and mfu share.  A card set below 700 W reads
lower against them; the result line carries the card's power limit."""
BF16_FLOPS = 989e12         # FLOP/s, bf16 tensor cores, no sparsity
HBM_BYTES = 3.35e12         # bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
