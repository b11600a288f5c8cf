"""What the model code needs to run on ``DTensor``s (the dry-run of
``launch/dryrun.py`` and sharded execution over a ``DeviceMesh``).

On plain tensors, every function here returns its input or calls its
function as it is: serving and training on one device never reach a
``DTensor`` branch.  On a ``DTensor`` each one either redistributes to the
placement GSPMD would reach where DTensor's sharding propagation refuses a
split, or runs an operation that has no sharding strategy on each rank's
local shard.  Neither changes what is computed; each costs the collectives
its docstring names, which the dry-run counts.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch


def is_dtensor(x: Any) -> bool:
    return hasattr(x, "placements") and hasattr(x, "device_mesh")


def evenly(x: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """``x`` ready for a reshape that splits its dim ``dim`` into ``n``
    leading parts (heads), or merges a dim of ``n`` heads ``dim`` into the
    next: a ``DTensor`` whose mesh dims shard that dim over a count that
    does not divide ``n`` is gathered over them (an all-gather each), as
    GSPMD reshards a head split that is not a multiple of the model axis.
    (DTensor refuses to unflatten or flatten such a shard.)"""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    d = dim % x.dim()
    mesh = x.device_mesh
    ways = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == d:
            ways *= mesh.size(i)
    if n % ways == 0:
        return x
    return x.redistribute(mesh, [Replicate() if isinstance(p, Shard)
                                 and p.dim == d else p
                                 for p in x.placements])


def _mesh_of(*args: Any):
    for a in args:
        if is_dtensor(a):
            return a.device_mesh
    return None


def _replicate(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's whole copy of ``x`` (an all-gather or all-reduce per
    mesh dim that shards it or holds it partial)."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x):
        return x
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def replicated(fn, *args: Any) -> Any:
    """``fn(*args)``; where any argument is a ``DTensor``, every rank runs
    ``fn`` on whole copies of the arguments (each gathered or reduced to
    ``Replicate`` first) and the tensors it returns are replicated
    ``DTensor``s.  For operations with no sharding strategy
    (``searchsorted``) on data small enough to hold whole, as GSPMD
    replicates an operand it cannot partition."""
    mesh = _mesh_of(*args)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate
    out = fn(*(_replicate(a, mesh) for a in args))

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def shard_ranges(x: torch.Tensor):
    """(offsets, sizes) per dim of this rank's shard of the ``DTensor``
    ``x``: ``torch.chunk``'s split, mesh dims in order (the shard of a dim
    that two mesh dims split is split again by the second)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    off, size = [0] * x.dim(), list(x.shape)
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            d, n, c = p.dim, mesh.size(i), mesh.get_local_rank(i)
            step = -(-size[d] // n)
            start = min(c * step, size[d])
            off[d] += start
            size[d] = min(start + step, size[d]) - start
    if tuple(size) != tuple(x.to_local().shape):
        raise RuntimeError(f"shard of {tuple(x.shape)} under {x.placements}: "
                           f"reckoned {size}, held "
                           f"{tuple(x.to_local().shape)}")
    return off, size


def _placed_as(x: torch.Tensor, dst: torch.Tensor, drop: int
               ) -> torch.Tensor:
    """This rank's shard of ``x``, placed as ``dst`` with ``dst``'s dim
    ``drop`` replicated and, where ``x`` lacks that dim (``x.dim() <
    dst.dim()``), the later dims moved down by one."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = dst.device_mesh
    gone = x.dim() < dst.dim()
    target = []
    for p in dst.placements:
        if isinstance(p, Shard) and p.dim == drop:
            target.append(Replicate())
        elif isinstance(p, Shard) and gone and p.dim > drop:
            target.append(Shard(p.dim - 1))
        else:
            target.append(p if isinstance(p, Shard) else Replicate())
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, target).to_local()


def put_slots(dst: torch.Tensor, rows: torch.Tensor, slot: torch.Tensor,
              values: torch.Tensor) -> None:
    """``dst[rows[b], slot[b]] = values[b]`` in place, ``rows`` every row
    of ``dst`` (a decode step's cache write).  On a ``DTensor`` cache each
    rank writes its own shard: rows and slots are moved to the shard's
    offsets and a slot outside a sequence-sharded shard is left as it is,
    as GSPMD partitions the reference's scatter; ``values`` are only
    sliced to the cache's placement (no collective from a replicated
    dim)."""
    if not is_dtensor(dst):
        dst.index_put_((rows, slot), values)
        return
    off, size = shard_ranges(dst)
    mesh = dst.device_mesh
    v = _placed_as(values, dst, 1).to(dst.dtype)
    s = _replicate(slot, mesh)[off[0]:off[0] + size[0]] - off[1]
    r = torch.arange(size[0], device=s.device)
    local = dst.to_local()
    if size[1] == dst.shape[1]:
        local.index_put_((r, s), v)
        return
    inside = (s >= 0) & (s < size[1])
    s = s.clamp(0, size[1] - 1)
    keep = local[r, s]
    local.index_put_((r, s), torch.where(
        inside.view(-1, *[1] * (v.dim() - 1)), v, keep))


def ring_fill(dst: torch.Tensor, kv: torch.Tensor, S: int, W: int) -> None:
    """Write one layer's prefill K/V (B,S,Hkv,hd) into its cache (B,W,...)
    in place; a ring of width W < S keeps the last W positions at slot
    ``pos mod W``.  On a ``DTensor`` cache each rank writes the slots of
    its own shard from the positions that land there (``kv`` is gathered
    over the mesh dims that shard the cache's slots: an all-gather each)."""
    if not is_dtensor(dst):
        if S >= W:
            slots = torch.arange(S - W, S, device=dst.device) % W
            dst[:, slots] = kv[:, S - W:].to(dst.dtype)
        else:
            dst[:, :S] = kv.to(dst.dtype)
        return
    off, size = shard_ranges(dst)
    o, n = off[1], size[1]
    k = _placed_as(kv, dst, 1)
    local = dst.to_local()
    if S >= W:
        # local slot o + m holds position S - W + ((o + m - r) mod W)
        r = (S - W) % W
        pos = (torch.arange(o, o + n, device=k.device) - r) % W + (S - W)
        local.copy_(k.index_select(1, pos).to(local.dtype))
    else:
        m = max(0, min(S - o, n))
        if m:
            local[:, :m] = k[:, o:o + m].to(local.dtype)


def shard_as(x: torch.Tensor, dim: int, like: torch.Tensor,
             like_dim: int) -> torch.Tensor:
    """``x`` with its dim ``dim`` sharded over each mesh dim that shards
    ``like``'s dim ``like_dim`` and replicates ``x`` (each rank keeps its
    slice: no collective).  The MoE dispatch buffer's capacity slots split
    over the data axes as the tokens do."""
    if not (is_dtensor(x) and is_dtensor(like)):
        return x
    from torch.distributed.tensor import Replicate, Shard
    target = [Shard(dim) if isinstance(q, Shard) and q.dim == like_dim
              and isinstance(p, Replicate) else p
              for p, q in zip(x.placements, like.placements)]
    return x.redistribute(x.device_mesh, target)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: DTensor wraps a
    local tensor's gradient with the strides of a contiguous global tensor,
    and a plain backward can hand it a transposed one."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def rows_and_heads(fn, args: Sequence[Optional[torch.Tensor]],
                   dims: Sequence[Tuple[Optional[int], Optional[int]]],
                   out_dims: Sequence[Tuple[Optional[int], Optional[int]]],
                   out_shapes, n_heads: Sequence[int], **kw: Any):
    """``fn(*args, **kw)`` for a computation independent across rows and
    heads (attention, the SSD scan and its step).  ``dims`` gives each
    argument's (row dim, head dim), either ``None``; ``out_dims`` and
    ``out_shapes`` each output's dims and global shape; ``n_heads`` the
    head counts a head split must divide (the KV heads of grouped
    attention).

    On plain tensors ``fn`` runs as it is.  On ``DTensor``s each rank runs
    ``fn`` on its own rows and heads: a mesh dim that shards the first
    argument's rows shards every argument's rows; one that shards its heads
    shards every argument's heads where the head counts divide; any other
    dim (a split of the sequence, of the head dim, a pending sum) is
    gathered, as GSPMD partitions the reference's batched attention and
    scan.  The kernel wrappers then take local tensors, so that no DTensor
    sharding rule runs inside them."""
    lead = args[0]
    if not is_dtensor(lead):
        return fn(*args, **kw)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = lead.device_mesh
    row, head = dims[0]
    roles, ways = [], 1
    for i, p in enumerate(lead.placements):
        n = mesh.size(i)
        if isinstance(p, Shard) and p.dim == row:
            roles.append(0)
        elif isinstance(p, Shard) and p.dim == head and all(
                h % (ways * n) == 0 for h in n_heads):
            roles.append(1)
            ways *= n
        else:
            roles.append(None)

    def placed(d):
        return [Shard(d[r]) if r is not None and d[r] is not None
                else Replicate() for r in roles]

    def local(t, d):
        if t is None:
            return None
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return _ContiguousGrad.apply(t.redistribute(mesh, placed(d))
                                     .to_local())

    out = fn(*(local(t, d) for t, d in zip(args, dims)), **kw)
    single = not isinstance(out, tuple)
    outs = [DTensor.from_local(
        t.contiguous(), mesh, placed(d), run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())
        for t, d, shape in zip((out,) if single else out, out_dims,
                               out_shapes)]
    return outs[0] if single else tuple(outs)


def per_row(fn, x: torch.Tensor, out_shape) -> torch.Tensor:
    """``fn(x)`` for a computation independent across the rows of ``x``
    (dim 0) whose result has global shape ``out_shape``: each rank's rows
    on their own (:func:`rows_and_heads`).  (DTensor's rule for
    ``F.pad`` fails on some versions.)"""
    return rows_and_heads(fn, (x,), ((0, None),), ((0, None),),
                          (torch.Size(out_shape),), ())


def per_head(fn, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             init_state: Optional[torch.Tensor] = None, **kw: Any):
    """The SSD scan ``fn(x, dt, A, Bm, Cm, init_state=..., **kw) -> (y,
    state)`` (x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N), state
    (B,H,P,N)) per rank's rows and heads (:func:`rows_and_heads`; B and C
    whole on each rank)."""
    Bsz, _, H, P = x.shape
    return rows_and_heads(
        lambda *a: fn(*a[:5], init_state=a[5], **kw),
        (x, dt, A, Bm, Cm, init_state),
        ((0, 2), (0, 2), (None, 0), (0, None), (0, None), (0, 1)),
        ((0, 2), (0, 1)),
        (x.shape, torch.Size((Bsz, H, P, Bm.shape[-1]))), (H,))


DATA_AXES = ("pod", "data")


def gather_data(w: torch.Tensor) -> torch.Tensor:
    """A weight as a layer uses it: a ``DTensor`` sharded over the data
    axes (FSDP's 2D weight sharding, ``models/sharding.py``) is all-gathered
    over them, as GSPMD gathers FSDP weights per layer (its gradient is
    reduce-scattered back).  DTensor would otherwise reshard the
    activations onto the weight's split and repeat the product's whole
    batch on every rank."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard
    names = w.device_mesh.mesh_dim_names or ()
    target = [Replicate() if isinstance(p, Shard) and n in DATA_AXES else p
              for p, n in zip(w.placements, names)]
    if target == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, target)


def whole(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x`` with its dim ``dim`` whole on every rank (an all-gather per
    mesh dim that splits it): ahead of a split of that dim at boundaries
    the shards do not share (Mamba2's in_proj output into z, xBC, dt)."""
    return evenly(x, 1, dim)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On a ``DTensor`` table split by rows (the vocab
    over the model axis) each rank looks up the tokens its rows hold and
    zeros the rest, and one all-reduce over those mesh dims sums the rows
    (the vocab-parallel embedding); the tokens keep their row split.
    (DTensor's own rule for this gather fails in its backward on some
    versions.)"""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    off, size = shard_ranges(table)
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    # tokens keep a split of their own dims; the table's row split becomes
    # a pending sum, and anything else is gathered
    tok_pl = [p if isinstance(p, Shard) and not (
        isinstance(q, Shard) and q.dim == 0) else Replicate()
        for p, q in zip(tokens.placements, table.placements)]
    ids = tokens.redistribute(mesh, tok_pl).to_local() - off[0]
    inside = (ids >= 0) & (ids < size[0])
    rows = table.redistribute(mesh, [
        q if isinstance(q, Shard) and q.dim == 0 else Replicate()
        for q in table.placements]).to_local()
    out = rows[ids.clamp(0, size[0] - 1)] * inside[..., None].to(rows.dtype)
    pl = [Partial() if isinstance(q, Shard) and q.dim == 0 else p
          for p, q in zip(tok_pl, table.placements)]
    shape = torch.Size((*tokens.shape, table.shape[1]))
    out = DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                             stride=torch.empty(shape, device="meta").stride())
    return out.redistribute(mesh, tok_pl)


def settled(x: torch.Tensor) -> torch.Tensor:
    """``x`` with no pending sum: a row-parallel product's partial sums
    are all-reduced where they are made, as GSPMD (and Megatron) reduce
    them.  Left pending, DTensor carries the sum into the residual stream
    and reduces it again at every use."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def pick(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x.gather(-1, index)``.  On a ``DTensor`` ``x`` split on its last
    dim (logits over the vocab) each rank picks the entries its shard
    holds and zeros the rest, and one all-reduce over those mesh dims sums
    them (the vocab-parallel cross-entropy's picked logit); ``index``
    takes ``x``'s split of the leading dims.  (DTensor's own masked gather
    fails on meta tensors when two mesh dims split the vocab.)"""
    if not is_dtensor(x):
        return x.gather(-1, index)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x = settled(x)
    mesh, last = x.device_mesh, x.dim() - 1
    off, size = shard_ranges(x)
    if not is_dtensor(index):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    keep = [p if isinstance(p, Shard) and p.dim != last else Replicate()
            for p in x.placements]
    i = index.redistribute(mesh, keep).to_local() - off[last]
    inside = (i >= 0) & (i < size[last])
    out = x.to_local().gather(-1, i.clamp(0, size[last] - 1)) \
        * inside.to(x.dtype)
    pl = [Partial() if isinstance(p, Shard) and p.dim == last else q
          for p, q in zip(x.placements, keep)]
    out = DTensor.from_local(out, mesh, pl, run_check=False,
                             shape=index.shape,
                             stride=torch.empty(index.shape,
                                                device="meta").stride())
    return settled(out)
