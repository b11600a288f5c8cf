"""Public kernel entry points of the port.

Port of ``src/repro/kernels/ops.py:29-139``.  The JAX package picks an
implementation from ``ModelConfig.kernels``; here the device of the tensors
picks it, inside each wrapper of ``KERNEL_TABLE``: a CPU tensor runs the
plain PyTorch version, a CUDA tensor launches the hand-written kernel, and
anything the kernel does not take raises.  There is no fallback from a CUDA
tensor to the plain version.

    attention         kernels/flash_attention.py   csrc/flash_attention.cu
    decode_attention  kernels/decode_attention.py  csrc/decode_attention.cu
    ssd               kernels/ssd_scan.py          csrc/ssd_scan.cu

Three hot spots of the models stay plain PyTorch on every device, as they
are plain jnp on every backend in the JAX package, which wrote no Pallas
kernel for them:

* ``ssd_step``, the single-token Mamba2 recurrence (a few memory-bound
  elementwise operations at S = 1);
* ``models.layers.moe_block``, the mixture-of-experts dispatch, expert
  FFNs and combine;
* a sliding-window ring's decode step (``models.layers.gqa_attention``
  under a mask): a ring cache is not the prefix the decode kernel reads.
"""
from __future__ import annotations

from typing import Dict, Mapping

from .decode_attention import decode_attention
from .flash_attention import flash_attention as attention
from .ssd_scan import ssd_scan as ssd

# hot spot -> its wrapper, whose ``launches`` counts kernel launches (the
# plain-only hot spots are listed in the module docstring)
KERNEL_TABLE = {"attention": attention, "decode_attention": decode_attention,
                "ssd": ssd}


def ssd_step(state, x, dt, A, Bm, Cm):
    """Single-token SSM recurrence: ``models.layers.ssd_decode_step`` on
    every device (see the module docstring)."""
    # lazy: models.layers imports this module
    from ..models.layers import ssd_decode_step
    return ssd_decode_step(state, x, dt, A, Bm, Cm)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, per hot spot."""
    return {name: fn.launches for name, fn in KERNEL_TABLE.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_TABLE.values():
        fn.launches = 0


def set_launch_counts(counts: Mapping[str, int]) -> None:
    """Set the launches of the hot spots ``counts`` names (a captured
    program restores them after capture and adds to them on replay)."""
    for name, n in counts.items():
        KERNEL_TABLE[name].launches = n
