"""Public kernel entry points of the port.

Port of ``src/repro/kernels/ops.py:29-108`` for the two hot spots of the
dense decoder.  The JAX package picks an implementation from
``ModelConfig.kernels``; here the device of the tensors picks it, inside
each wrapper of ``KERNEL_TABLE``: a CPU tensor runs the plain PyTorch
version, a CUDA tensor launches the hand-written kernel, and anything the
kernel does not take raises.  There is no fallback from a CUDA tensor to the
plain version.

    attention         kernels/flash_attention.py   csrc/flash_attention.cu
    decode_attention  kernels/decode_attention.py  csrc/decode_attention.cu

``ssd`` and ``ssd_step`` (Mamba2) are not ported yet (ROADMAP, Queue 2).
"""
from __future__ import annotations

from typing import Dict

from .decode_attention import decode_attention
from .flash_attention import flash_attention as attention

# hot spot -> its wrapper, whose ``launches`` counts kernel launches
KERNEL_TABLE = {"attention": attention, "decode_attention": decode_attention}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, per hot spot."""
    return {name: fn.launches for name, fn in KERNEL_TABLE.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_TABLE.values():
        fn.launches = 0
