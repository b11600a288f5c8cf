"""Production mesh construction and the H100's constants.

Port of ``src/repro/launch/mesh.py``.  FUNCTIONS, not module-level
constants: importing this module touches no device or process-group
state.  Each mesh is ``init_device_mesh`` over whatever process group is
initialised: the fake group of the dry-run (``launch/dryrun.py``), a real
NCCL group on a cluster.

An H100 cluster is built of 8-GPU NVLink nodes joined by a network, where a
v5e pod rides ICI on both axes of its 16 x 16 mesh.  So the production
meshes keep the ``model`` axis inside one node (a 16-wide model axis would
send every tensor-parallel collective across the node boundary):
``(data 32, model 8)`` on 256 GPUs, ``(pod 2, data 32, model 8)`` on 512.
"""
from __future__ import annotations

from typing import Tuple

SINGLE_SHAPE: Tuple[int, int] = (32, 8)
MULTI_SHAPE: Tuple[int, int, int] = (2, 32, 8)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(data 32, model 8) on 256 GPUs, or (pod 2, data 32, model 8) on
    512: the model axis inside one 8-GPU NVLink node."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = MULTI_SHAPE if multi_pod else SINGLE_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """(world // model, model) over the current process group's ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


# NVIDIA H100 SXM data sheet, per GPU
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 dense (no sparsity)
HBM_BW = 3.35e12                # bytes/s, HBM3
NVLINK_BW = 450e9               # bytes/s per direction, NVLink 4 (900 GB/s
                                # bidirectional): the model / expert / tp axes
NET_BW = 50e9                   # bytes/s, one 400 Gb/s NIC per GPU: the data
                                # and pod axes
HBM_BYTES = 80e9                # device memory, 80 GB

# mesh axes inside one NVLink node; every other axis crosses the network
NODE_AXES = ("model", "expert", "tp")


def link_bw(axis: str) -> float:
    """Bytes/s per GPU of a collective over mesh axis ``axis``."""
    return NVLINK_BW if axis in NODE_AXES else NET_BW
