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

``ssd_step``, the single-token Mamba2 recurrence, is plain PyTorch on every
device, as it is plain jnp on every backend in the JAX package: at S = 1 it
is a few memory-bound elementwise operations, and no TPU kernel was written
for it.
"""
from __future__ import annotations

from typing import Dict

from .decode_attention import decode_attention
from .flash_attention import flash_attention as attention
from .ssd_scan import ssd_scan as ssd

# hot spot -> its wrapper, whose ``launches`` counts kernel launches
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
