"""Where the port's entry points run.

Every entry point (``init_params``, ``init_cache``, ``ContinuousTorchExecutor``,
``launch.serve.serve``) runs on the card unless its caller names another
device: ``device=None`` means ``"cuda"``.  Without CUDA that raises; it never
carries on quietly on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_sm_counts: Dict[int, int] = {}     # device index -> streaming multiprocessors
_l2_bytes: Dict[int, int] = {}      # device index -> L2 cache bytes


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def device_name(device: Optional[torch.device]) -> str:
    """Human-readable name of the device a result was measured on."""
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device, which the kernels' launch
    plans fill."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def l2_bytes(device: torch.device) -> int:
    """Bytes of a CUDA device's L2 cache, which the flash kernel's walk
    order (``flash_order``) weighs a launch's K/V against."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _l2_bytes:
        _l2_bytes[idx] = torch.cuda.get_device_properties(idx).L2_cache_size
    return _l2_bytes[idx]
