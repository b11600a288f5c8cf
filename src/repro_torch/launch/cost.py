"""Per-device cost of a traced step: FLOPs, bytes and collective wire bytes.

The counterpart of XLA's ``compiled.cost_analysis()`` and of
``src/repro/launch/roofline.py::parse_collective_bytes``.  The reference
compiles a step for the production mesh and reads the per-device cost of
the compiled program; here :class:`DeviceCostMode`, a
``TorchDispatchMode``, prices each operation as rank 0 runs it, while the
step runs eagerly on ``DTensor``s over a fake process group (or on plain
meta tensors, with no mesh at all).

* A ``DTensor`` operation is handed back to DTensor (the mode returns
  ``NotImplemented`` for tensor subclasses), which desugars it into
  operations on rank 0's local shards and the collectives that its
  redistributions need; the mode prices those.
* **FLOPs**: ``torch.utils.flop_counter.flop_registry`` (products,
  convolutions, attention) on the local tensors.  (``FlopCounterMode`` by
  itself counts a ``DTensor``'s global FLOPs.)  Elementwise operations
  count no FLOPs.
* **Bytes**: each operation's local inputs read once and outputs written
  once.  Views count zero, as XLA counts no bytes for a bitcast; a gather
  (indexing by a tensor) reads the rows it returns, not its whole source;
  ``copy_`` and ``index_put_`` write their destination without reading it.
* **Collectives**: the ``_c10d_functional`` operations (and DTensor's
  all-to-all), each priced in wire bytes with the reference's ring factors
  (:func:`collective_wire_bytes`) and keyed by its kind and by the mesh
  axis of its group, so that the roofline can price each axis at its
  link's bandwidth.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_aten = torch.ops.aten
# names of the collective operations (their overload packets' last part)
_COLLECTIVE = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "_dtensor")
# operations that read and write nothing: metadata, waits, allocation
_FREE = {_aten._unsafe_view, _aten.empty, _aten.empty_like,
         _aten.empty_strided, _aten.lift_fresh, _aten.lift_fresh_copy}
_GATHER = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding}
_WRITE = {_aten.copy_, _aten.index_put_, _aten.index_put,
          _aten._index_put_impl_}


def collective_wire_bytes(kind: str, operand_bytes: float,
                          result_bytes: float, group: int) -> float:
    """Wire bytes per participating device, ring-algorithm factors
    (``src/repro/launch/roofline.py:66-73``): all-gather (g-1)/g x result,
    reduce-scatter (g-1)/g x operand, all-reduce 2 (g-1)/g x operand,
    all-to-all (g-1)/g x operand, collective-permute 1 x operand."""
    g = max(int(group), 1)
    ring = (g - 1) / g
    if kind == "all-gather":
        return ring * result_bytes
    if kind == "reduce-scatter":
        return ring * operand_bytes
    if kind == "all-reduce":
        return 2 * ring * operand_bytes
    if kind == "all-to-all":
        return ring * operand_bytes
    if kind == "collective-permute":
        return float(operand_bytes)
    raise ValueError(f"unknown collective kind {kind!r}; known: {KINDS}")


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _desugared() -> Tuple[type, ...]:
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor
    return (DTensor, AsyncCollectiveTensor)


def mesh_groups(mesh: Any) -> Dict[str, Tuple[str, int]]:
    """{process-group name: (mesh axis name, group size)} of a
    ``DeviceMesh``'s dims."""
    if mesh is None:
        return {}
    return {mesh.get_group(i).group_name: (name, mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


class DeviceCostMode(TorchDispatchMode):
    """Sums the per-device cost of everything that runs under it (see the
    module docstring).  ``mesh`` names the axes of the collectives' groups;
    without one the mode prices plain tensors and expects no
    collective."""

    def __init__(self, mesh: Optional[Any] = None):
        super().__init__()
        self.groups = mesh_groups(mesh)
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_by_kind: Dict[str, float] = {k: 0.0 for k in KINDS}
        self.coll_by_axis: Dict[str, float] = defaultdict(float)
        self.coll_calls: Dict[Tuple[str, str], int] = defaultdict(int)
        # (kind, axis, operand numel) of every collective, in order
        self.coll_log: List[Tuple[str, str, int]] = []
        self.flops_by_op: Dict[str, float] = defaultdict(float)
        self.bytes_by_op: Dict[str, float] = defaultdict(float)
        self.paused = 0         # > 0: run operations without pricing them

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _desugared()) for t in types):
            # a DTensor (or an async collective's wrapper): let it desugar
            # into operations on local tensors, which come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if any(t not in (torch.Tensor, torch.nn.Parameter) for t in types):
            # DTensor's sharding propagation infers shapes on fake tensors:
            # no work of the step
            return out
        if not self.paused:
            self._price(func, args, kwargs, out)
        return out

    def add(self, name: str, flops: float, nbytes: float) -> None:
        """Price work that ran unpriced (``kernels_priced``)."""
        self.flops += flops
        self.bytes += nbytes
        self.flops_by_op[name] += flops
        self.bytes_by_op[name] += nbytes

    def _price(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        ns = func.namespace
        name = packet.__name__
        if ns in _NAMESPACES and name in _COLLECTIVE:
            self._collective(_COLLECTIVE[name], args, kwargs, out)
            return
        if ns in _NAMESPACES:       # wait_tensor and the like
            return
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[str(packet)] += f
        if func.is_view or packet in _FREE:
            return
        if packet in _GATHER:
            idx = [a for a in tree_leaves((args[1:], kwargs))
                   if isinstance(a, torch.Tensor)]
            b = _nbytes(idx) + 2 * _nbytes(out)
        elif packet in _WRITE:
            # copy_(dst, src): read src, write dst; index_put_(dst, idx,
            # values): read idx and values, write values' worth of dst
            src = args[1:] if packet is _aten.copy_ else (args[1], args[2])
            b = _nbytes(src) + (_nbytes(args[0]) if packet is _aten.copy_
                                else _nbytes(args[2]))
        else:
            b = _nbytes((args, kwargs)) + _nbytes(out)
        self.bytes += b
        self.bytes_by_op[str(packet)] += b

    def _collective(self, kind: str, args, kwargs, out) -> None:
        group_name = kwargs.get("group_name", args[-1])
        if not isinstance(group_name, str):
            group_name = getattr(group_name, "group_name", str(group_name))
        axis, size = self.groups.get(group_name, ("world", None))
        if size is None:
            import torch.distributed as dist
            size = dist.get_world_size()
        operand, result = _nbytes(args[0]), _nbytes(out)
        wire = collective_wire_bytes(kind, operand, result, size)
        self.coll_by_kind[kind] += wire
        self.coll_by_axis[axis] += wire
        self.coll_calls[(kind, axis)] += 1
        self.coll_log.append((kind, axis, args[0].numel()))

    def summary(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes_accessed": self.bytes,
                "coll_bytes": sum(self.coll_by_kind.values()),
                "coll_by_kind": dict(self.coll_by_kind),
                "coll_by_axis": dict(self.coll_by_axis),
                "coll_calls": {f"{k} over {a}": n for (k, a), n
                               in sorted(self.coll_calls.items())}}


# ---------------------------------------------------------------------------
# The three hot spots as their hand kernels run them
# ---------------------------------------------------------------------------


def attended_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs attention scores, queries aligned to the end of
    the keys (``kernels/ref.py``'s masks)."""
    n = 0
    for i in range(Sq):
        hi = Sk - Sq + i if causal else Sk - 1
        lo = max(0, hi - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def _flash_cost(q, k, v, *, causal=True, window=0):
    B, Sq, Hq, hd = q.shape
    return (4 * hd * B * Hq * attended_pairs(Sq, k.shape[1], causal, window),
            _nbytes((q, k, v)) + _nbytes(q))


def _decode_cost(q, k, v, valid_len):
    # every row's whole cache: the values of valid_len are not known here
    B, Hq, hd = q.shape
    live = B * k.shape[1]
    return (4 * hd * Hq * live,
            2 * _nbytes(q) + 2 * live * k.shape[2] * hd * k.element_size()
            + _nbytes(valid_len))


def _ssd_cost(x, dt, A, Bm, Cm, *, chunk, init_state=None):
    B, S, H, P = x.shape
    N, nc = Bm.shape[-1], -(-S // chunk)
    flops = B * H * nc * (2 * chunk * chunk * (N + P) + 4 * chunk * N * P)
    return flops, (2 * _nbytes(x) + _nbytes((dt, A, Bm, Cm, init_state))
                   + (1 if init_state is None else 2) * B * H * P * N * 4)


KERNEL_COST = {"attention": _flash_cost, "decode_attention": _decode_cost,
               "ssd": _ssd_cost}


@contextlib.contextmanager
def kernels_priced(mode: "DeviceCostMode"):
    """Within it, ``kernels.ops``' three hot spots are priced as their hand
    kernels run on the card (inputs read once, outputs written once, the
    kernels' products: the formulas of ``chip_smoke.py`` phase 4's bounds),
    not op by op as their plain versions, which compute the same values
    on meta and CPU tensors.  A backward through the plain version is still
    priced op by op."""
    from ..kernels import ops
    saved = {name: getattr(ops, name) for name in KERNEL_COST}

    def priced(name, fn):
        def call(*args, **kw):
            mode.paused += 1
            try:
                out = fn(*args, **kw)
            finally:
                mode.paused -= 1
            f, b = KERNEL_COST[name](*args, **kw)
            mode.add(f"kernel {name}", f, b)
            return out
        return call

    for name, fn in saved.items():
        setattr(ops, name, priced(name, fn))
    try:
        yield mode
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
