"""Sharding rules: parameter / cache / input specs for any mesh, and the
placement of tensors on a ``DeviceMesh``.

Port of ``src/repro/models/sharding.py``, rule for rule (the port imports
nothing of ``repro``).  Scheme:
  * weights — tensor-parallel over ``model`` (heads / FFN hidden / experts /
    vocab); replicated over ``data`` (and ``pod``).
  * activations & caches — batch over ``data`` (x ``pod``); for batch-1
    long-context decode the KV cache is sharded over ``data`` on the
    *sequence* axis instead (context-parallel decode).
  * MoE experts — expert-parallel over ``model`` when the expert count
    divides the axis; otherwise tensor-parallel within each expert.

A *spec* is a tuple with one entry per tensor dim, each ``None``, a mesh
axis name, or a tuple of axis names: the content of a JAX
``PartitionSpec``.  The rules take any ``mesh`` that gives ordered axis
names and sizes: a ``torch.distributed.device_mesh.DeviceMesh``
(``mesh_dim_names``, ``size(i)``) or a plain ``{"data": 32, "model": 8}``
mapping, so they can be held to the JAX package's without a process group.
:func:`placements` and :func:`distribute` put tensors on a real
``DeviceMesh`` (the counterpart of the reference's ``named``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

from ..train.tree import map_with_path
from .config import ModelConfig

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """Ordered {axis name: size} of a ``DeviceMesh`` or a mapping."""
    if hasattr(mesh, "mesh_dim_names"):
        return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return dict(mesh)


def data_axes(mesh: Any) -> Tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def model_axes(mesh: Any) -> Union[str, Tuple[str, str]]:
    """The tensor-parallel logical axis: plain ``model``, or the 2D
    ``(expert, tp)`` split used by the expert-parallel perf variant."""
    if "model" in mesh_axes(mesh):
        return "model"
    return ("expert", "tp")


def model_axis_size(mesh: Any) -> int:
    axes = mesh_axes(mesh)
    if "model" in axes:
        return axes["model"]
    return axes["expert"] * axes["tp"]


def _data_size(mesh: Any) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh_axes(mesh)[a]
    return n


# The JAX package's rule, kept for parity so that every leaf is placed as
# there; what fits an H100 is read from the dry-run's per-device bytes.
FSDP_THRESHOLD_BYTES = 8 << 30      # add data-axis weight sharding above this


def needs_fsdp(cfg: ModelConfig, mesh: Any) -> bool:
    """True when the bf16 weights over the model axis exceed
    ``FSDP_THRESHOLD_BYTES`` a device (mixtral-8x22b, llama4-scout)."""
    bytes_per_dev = cfg.param_count() * 2 / model_axis_size(mesh)
    return bytes_per_dev > FSDP_THRESHOLD_BYTES


def _leaf_name(path: Sequence[str]) -> Optional[str]:
    """The last dict key of a tree path (list indices are digits)."""
    for p in reversed(path):
        if not p.isdigit():
            return p
    return None


def _pad(ndim: int, *tail: Entry) -> Spec:
    return (None,) * (ndim - len(tail)) + tail


def param_pspecs(cfg: ModelConfig, params: Any, mesh: Any,
                 fsdp: Optional[bool] = None) -> Any:
    """Spec tree mirroring ``params`` (name-based rules).

    With ``fsdp`` the d_model dimension of large matrices is additionally
    sharded over ``data`` (2D weight sharding): each layer's weights are
    all-gathered where they are used."""
    axes = mesh_axes(mesh)
    msize = model_axis_size(mesh)
    max_ = model_axes(mesh)
    if fsdp is None:
        fsdp = needs_fsdp(cfg, mesh)
    dshard = "data" if fsdp else None
    if max_ == "model":
        expert_parallel = cfg.n_experts > 0 and cfg.n_experts % msize == 0
        e_ax, t_ax = "model", None
    else:
        # 2D split: experts over `expert`, within-expert tensor over `tp`
        expert_parallel = (cfg.n_experts > 0
                           and cfg.n_experts % axes["expert"] == 0)
        e_ax, t_ax = "expert", "tp"

    def rule(path, leaf) -> Spec:
        name = _leaf_name(path)
        nd = leaf.dim()
        if name == "embed":
            return (max_, dshard)
        if name == "lm_head":
            return (dshard, max_)
        if name in ("final_norm", "enc_norm") or name.startswith("ln") \
                or name in ("norm_w", "conv_b", "dt_bias", "A_log", "D",
                            "conv_w", "router"):
            return _pad(nd)
        if name in ("wq", "wk", "wv", "xwq", "xwk", "xwv", "in_proj"):
            # (..., d, h): d over data (fsdp), h over model
            return _pad(nd, dshard, max_)
        if name in ("wo", "xwo", "out_proj"):
            # (..., h, d): h over model, d over data (fsdp)
            return _pad(nd, max_, dshard)
        if name in ("w_gate", "w_up"):
            if nd == 4:     # stacked MoE (L, E, d, f)
                return ((None, e_ax, dshard, t_ax) if expert_parallel
                        else (None, None, dshard, max_))
            return _pad(nd, dshard, max_)
        if name == "w_down":
            if nd == 4:     # (L, E, f, d)
                return ((None, e_ax, t_ax, dshard) if expert_parallel
                        else (None, None, max_, dshard))
            return _pad(nd, max_, dshard)
        return _pad(nd)

    return map_with_path(rule, params)


def cache_pspecs(cfg: ModelConfig, cache: Any, mesh: Any,
                 batch: int) -> Any:
    """Cache specs.  batch >= data-axis size -> shard batch; batch smaller
    (long-context) -> shard the KV sequence axis over ``data``."""
    dp = data_axes(mesh)
    max_ = model_axes(mesh)
    dp_size = _data_size(mesh)
    batch_sharded = batch % dp_size == 0 and batch >= dp_size
    msize = model_axis_size(mesh)
    kv_axis_ok = cfg.n_kv_heads and cfg.n_kv_heads % msize == 0
    hd_ok = cfg.hd % msize == 0 if cfg.n_heads else False
    ssm_heads_ok = cfg.n_ssm_heads % msize == 0 if cfg.ssm_state else False
    b = dp if batch_sharded else None

    def rule(path, leaf) -> Spec:
        name = _leaf_name(path)
        if name in ("k", "v", "xk", "xv"):
            # (L, B, W, Hkv, hd)
            w = None if batch_sharded else "data"
            if kv_axis_ok:
                return (None, b, w, max_, None)
            if hd_ok:
                return (None, b, w, None, max_)
            return (None, b, w, None, None)
        if name == "conv":      # (L, B, dc-1, dxbc)
            return (None, b, None, max_)
        if name == "state":     # (L, B, H, P, N)
            return (None, b, max_ if ssm_heads_ok else None, None, None)
        return _pad(leaf.dim())

    return map_with_path(rule, cache)


def input_pspecs(cfg: ModelConfig, mesh: Any, batch: int
                 ) -> Dict[str, Spec]:
    dp_size = _data_size(mesh)
    b = data_axes(mesh) if (batch % dp_size == 0 and batch >= dp_size) \
        else None
    return {"tokens": (b, None), "frontend": (b, None, None),
            "token": (b, None)}


# ---------------------------------------------------------------------------
# Placing tensors on a DeviceMesh
# ---------------------------------------------------------------------------


def placements(mesh: Any, spec: Spec) -> list:
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim: mesh axis ``a``
    shards the tensor dim whose entry names it.  A tensor dim named by two
    mesh axes is sharded on both, in mesh order, as GSPMD does."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh_axes(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {axis!r} shards two dims of spec "
                             f"{spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def distribute(mesh: Any, tree: Any, specs: Any) -> Any:
    """``tree`` with each tensor a ``DTensor`` on ``mesh``, placed by the
    spec at the same path of ``specs`` (the reference's ``named`` and
    ``device_put`` in one)."""
    from torch.distributed.tensor import distribute_tensor
    flat = {}

    def note(path, spec):
        flat[path] = spec
        return spec

    _map_specs(note, specs)
    return map_with_path(
        lambda path, t: distribute_tensor(t, mesh,
                                          placements(mesh, flat[path])),
        tree)


def _map_specs(fn, specs: Any, prefix: Tuple[str, ...] = ()) -> Any:
    """``map_with_path`` over a spec tree, whose leaves are tuples."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, prefix + (str(k),))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v, prefix + (str(i),))
                for i, v in enumerate(specs)]
    return fn(prefix, specs)
