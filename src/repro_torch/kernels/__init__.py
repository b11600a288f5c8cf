"""Hand-written Hopper kernels for the data-plane hot spots.

Each kernel has its CUDA source under ``repro_torch/csrc``, a wrapper module
here (``<name>.py``: device dispatch, checks, launch counter, plain PyTorch
version), and an oracle in ``ref.py``; ``ops.py`` is the entry point the
models call.  Kernels are built with ``nvcc`` at first use (``_build.py``).
"""
from . import ops, ref
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .ssd_scan import ssd_scan

__all__ = ["ops", "ref", "flash_attention", "decode_attention", "ssd_scan"]
