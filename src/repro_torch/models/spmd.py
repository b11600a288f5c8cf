"""What the model code needs to run on ``DTensor``s (the dry-run of
``launch/dryrun.py`` and sharded execution over a ``DeviceMesh``).

On plain tensors, every function here returns its input or calls its
function as it is: serving and training on one device never reach a
``DTensor`` branch.  On a ``DTensor`` each one either redistributes to the
placement GSPMD would reach where DTensor's sharding propagation refuses a
split, or runs the operation on each rank's local shards with its
collectives explicit.  Neither changes what is computed; each costs the
collectives its docstring names, which the dry-run counts.

The products (``products``) and the mixture of experts (``sharded_moe``)
run on local shards in both passes (as does the optimizer's global norm,
``train/optim.py``):
where DTensor picks the strategy, torch 2.11 and 2.13 pick different ones
and the dry-run's counts differ.  Every gradient leaves such a place with
its input's placement, or with a pending sum that its input's gather (or
the train step) settles.
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
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
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
        # an argument without the rows (or heads) a mesh dim splits is
        # used by each rank for its own: its gradient is a pending sum
        grad = [Partial() if r is not None and d[r] is None else q
                for r, q in zip(roles, placed(d))]
        return _ContiguousGrad.apply(t.redistribute(mesh, placed(d))
                                     .to_local(grad_placements=grad))

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


def _contiguous_stride(shape) -> Tuple[int, ...]:
    return torch.empty(shape, device="meta").stride()


def _product_plan(x: torch.Tensor, ws: Sequence[torch.Tensor]):
    """Per mesh dim, the role of a product ``x @ w`` (x (..., K), w (K,
    N)), as Megatron and GSPMD partition a linear layer:

    * rows: x split on a leading dim; w whole (gathered if split), the
      output split like x, w's gradient a pending sum over the rows;
    * k: the contraction split (x on K, w on its rows): the output a
      pending sum;
    * n: w split on its columns, x whole: the output split on N, x's
      gradient a pending sum;
    * none: everything whole.

    Every weight must take the same role on each mesh dim.  Returns the
    placements of x, of w, of the output, of the output's gradient, of
    w's gradient and of x's gradient, one list each."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = x.dim() - 1
    roles = None
    for w in ws:
        rw = []
        for a, b in zip(x.placements, w.placements):
            xs = a.dim if isinstance(a, Shard) else None
            wd = b.dim if isinstance(b, Shard) else None
            rw.append(xs if xs is not None and xs != last
                      else "k" if (xs == last and wd != 1) or wd == 0
                      else "n" if wd == 1 else None)
        if roles is not None and rw != roles:
            raise ValueError(f"products: the weights take the roles {roles} "
                             f"and {rw} on {x.device_mesh}")
        roles = rw
    R, P = Replicate(), Partial()
    table = {"k": (Shard(last), Shard(0), P, R, Shard(0), Shard(last)),
             "n": (R, Shard(1), Shard(last), Shard(last), Shard(1), P),
             None: (R,) * 6}
    per_dim = [table[r] if r in table else
               (Shard(r), R, Shard(r), Shard(r), P, Shard(r)) for r in roles]
    return tuple([d[i] for d in per_dim] for i in range(6))


class _Products(torch.autograd.Function):
    """``x @ w`` for each weight on each rank's shards (``products``); the
    backward multiplies the local shards too, and its collectives are the
    redistributions named there, so that no sharding strategy of DTensor's
    is chosen in either pass."""

    @staticmethod
    def forward(ctx, plan, x, *ws):
        from torch.distributed.tensor import DTensor
        mesh = x.device_mesh
        px, pw, po = plan[:3]
        x_l = x.redistribute(mesh, px).to_local()
        outs, w_ls = [], []
        for w in ws:
            w_l = w.redistribute(mesh, pw).to_local()
            shape = torch.Size((*x.shape[:-1], w.shape[-1]))
            outs.append(DTensor.from_local(
                x_l @ w_l, mesh, po, run_check=False, shape=shape,
                stride=_contiguous_stride(shape)))
            w_ls.append(w_l)
        ctx.mesh, ctx.plan = mesh, plan
        ctx.x_meta = (x.shape, x.placements)
        ctx.w_meta = [(w.shape, w.placements) for w in ws]
        ctx.save_for_backward(x_l, *w_ls)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        from torch.distributed.tensor import DTensor, Shard
        mesh = ctx.mesh
        _, _, _, pg, pgw, pgx = ctx.plan
        x_l, *w_ls = ctx.saved_tensors
        x_shape, x_pl = ctx.x_meta
        gx_l, gws = None, []
        for g, w_l, (w_shape, w_pl) in zip(gs, w_ls, ctx.w_meta):
            if g is None:
                gws.append(None)
                continue
            g_l = g.redistribute(mesh, pg).to_local()
            part = g_l @ w_l.transpose(-1, -2)
            gx_l = part if gx_l is None else gx_l + part
            gw_l = (x_l.reshape(-1, x_l.shape[-1]).transpose(0, 1)
                    @ g_l.reshape(-1, g_l.shape[-1]))
            gw = DTensor.from_local(gw_l, mesh, pgw, run_check=False,
                                    shape=w_shape,
                                    stride=_contiguous_stride(w_shape))
            # a pending sum over the rows stays pending where w is whole
            # (the gather that made it, or the train step, settles it)
            keep = [q if q.is_partial() and not isinstance(p, Shard) else p
                    for p, q in zip(w_pl, pgw)]
            gws.append(gw.redistribute(mesh, keep))
        gx = None
        if gx_l is not None:
            gx = DTensor.from_local(gx_l, mesh, pgx, run_check=False,
                                    shape=x_shape,
                                    stride=_contiguous_stride(x_shape))
            gx = gx.redistribute(mesh, x_pl)
        return (None, gx, *gws)


def products(x: torch.Tensor, *ws: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``tuple(x @ w for w in ws)`` (x (..., K), each w (K, N)).  On
    ``DTensor``s each rank multiplies its own shards, placed by
    :func:`_product_plan`, in both passes: x's gradient leaves with x's
    placement (a pending sum over the column split all-reduced once for
    all the weights), each weight's with the weight's (a pending sum over
    the rows reduce-scattered onto a split, left pending on a whole
    weight).  DTensor's own rules pick other strategies on other torch
    versions, and so other counts in the dry-run."""
    if not any(is_dtensor(t) for t in (x, *ws)):
        return tuple(x @ w for w in ws)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = _mesh_of(x, *ws)

    def dt(t):
        return t if is_dtensor(t) else DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    x = settled(dt(x))
    ws = tuple(dt(w) for w in ws)
    return _Products.apply(_product_plan(x, ws), x, *ws)


def product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (:func:`products`)."""
    return products(x, w)[0]


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of a local tensor over ``group``, in equal
    parts along dim 0; its gradient takes the same exchange back."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol
        ctx.group = group
        return funcol.wait_tensor(funcol.all_to_all_single(
            x.contiguous(), None, None, group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_to_all_single(
            g.contiguous(), None, None, ctx.group)), None


class _SumOver(torch.autograd.Function):
    """The sum of a local tensor over ``group``'s ranks (an all-reduce);
    each rank's part gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGradOver(torch.autograd.Function):
    """The identity on a local tensor, whose gradient is summed over
    ``group``'s ranks (an all-reduce)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(g, "sum", ctx.group)), \
            None


def _sum_over(x: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    for i in dims:
        x = _SumOver.apply(x, mesh.get_group(i))
    return x


def sharded_moe(x: torch.Tensor, p, *, E: int, k: int, C: int, router,
                route, experts):
    """A mixture-of-experts block (``layers.moe_block``) on a ``DTensor``
    ``x`` (B,S,d), with the experts split over the mesh dims that split
    the expert weights, run on each rank's local tensors with its
    collectives explicit (the counts of the dry-run then depend on no
    sharding strategy of DTensor's):

    * each rank routes its own tokens (``router(xt, w) -> (probs, gates,
      ids)``); the expert ids are all-gathered over the token split and
      ``route(ids, T, E, C)`` plans every slot on every rank;
    * dispatch: the capacity of every local expert is split over the
      token split as the tokens are, each rank sends every other the rows
      of its tokens that fill that rank's slots, zeros elsewhere, in one
      ``all_to_all_single`` per mesh dim of the token split, and the
      contributions are summed (one token fills a slot);
    * ``experts(h, w_gate, w_up, w_down)`` on the local slots; a pending
      sum over a split of the experts' hidden dim is all-reduced;
    * combine: the slots' outputs go back through the same exchanges in
      reverse, each rank sending every other the rows of the other's
      tokens, zeros elsewhere; each rank gathers its tokens' outputs from
      its local experts and weights them by its gates, and one all-reduce
      over the expert split sums them.

    Both exchanges carry capacity-padded buffers of a rank's whole slot
    block: about capacity factor x G times the rows a variable-size
    all-to-all of the routed tokens alone would move (G the ranks of the
    token split).

    Returns (y, aux) as ``moe_block``, y placed as x."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x = settled(x)
    mesh = x.device_mesh
    B, S, d = x.shape
    T = B * S
    rows = [i for i, q in enumerate(x.placements)
            if isinstance(q, Shard) and q.dim == 0]
    xpl = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    x = x.redistribute(mesh, xpl)
    G, b = 1, 0
    for i in rows:
        G, b = G * mesh.size(i), b * mesh.size(i) + mesh.get_local_rank(i)
    if B % G:
        raise ValueError(f"sharded_moe: a batch of {B} over {G} ranks")
    Tl = T // G

    # the expert weights, gathered over the token split; a pending sum
    # over it is their gradient's
    ws, ex_dims, ep_dims = [], set(), []
    for name in ("w_gate", "w_up", "w_down"):
        w = p.get(name)
        if w is None:
            ws.append(None)
            continue
        w = w.redistribute(mesh, [Replicate() if i in rows else q
                                  for i, q in enumerate(w.placements)])
        ex_dims |= {i for i, q in enumerate(w.placements) if q.is_shard()}
        if name == "w_up":
            ep_dims = [i for i, q in enumerate(w.placements)
                       if isinstance(q, Shard) and q.dim == 0]
        ws.append(w.to_local(grad_placements=[
            Partial() if i in rows else q
            for i, q in enumerate(w.placements)]))
    E_l, e0 = E, 0
    for i in ep_dims:
        E_l //= mesh.size(i)
        e0 = e0 * mesh.size(i) + mesh.get_local_rank(i)
    e0 *= E_l
    tp_dims = sorted(ex_dims - set(ep_dims))

    # routing: each rank its own tokens; the plan of every slot everywhere
    xl = x.to_local().reshape(Tl, d)
    w_r = p["router"]
    w_r = w_r.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if i in rows else Replicate()
                         for i in range(mesh.ndim)])
    probs, gates, eidx = router(xl, w_r)
    ids = DTensor.from_local(eidx, mesh, xpl, run_check=False,
                             shape=torch.Size((T, k)),
                             stride=(k, 1)).full_tensor()
    dest, slot_src, inv = route(ids, T, E, C)

    # dispatch
    Cl = -(-C // G)
    Cp = Cl * G
    src = torch.cat([slot_src[:E * C].reshape(E, C),
                     slot_src.new_full((E, Cp - C), T)], dim=1)[e0:e0 + E_l]
    # each rank feeds its own experts (or its share of their hidden dim):
    # the dispatch's gradient is summed over that split
    xd = xl
    for i in sorted(ex_dims):
        xd = _SumGradOver.apply(xd, mesh.get_group(i))
    mine = (src >= b * Tl) & (src < (b + 1) * Tl)
    h = xd[(src - b * Tl).clamp(0, Tl - 1)] * mine[..., None].to(xd.dtype)
    # (destination coordinate per mesh dim of the split, E_l, Cl, d): one
    # exchange per dim, each summing what its sources sent
    h = h.reshape(E_l, G, Cl, d).transpose(0, 1).reshape(
        *(mesh.size(i) for i in rows), E_l, Cl, d)
    for i in rows:
        g, rest = h.shape[0], h.shape[1:]
        h = _AllToAll.apply(h.reshape(g, -1), mesh.get_group(i)).reshape(
            g, *rest).sum(dim=0)
    out = experts(h, *ws)
    out = _sum_over(out, mesh, tp_dims)

    # combine: the exchanges in reverse order, each rank sending every
    # other the rows of the slots that the other's tokens filled (the
    # owner's coordinate on that mesh dim), zeros elsewhere
    owner = (src // Tl).reshape(E_l, G, Cl).transpose(0, 1).reshape(
        *(mesh.size(i) for i in rows), E_l, Cl)
    coords = [mesh.get_local_rank(i) for i in rows]
    stride = 1
    for n, i in reversed(list(enumerate(rows))):
        g, shape = mesh.size(i), out.shape
        held = owner[tuple(coords[:n + 1])]
        to = torch.arange(g, device=held.device).view(g, *[1] * held.ndim)
        keep = (held < G) & ((held // stride) % g == to)
        out = _AllToAll.apply((out * keep[..., None].to(out.dtype))
                              .reshape(g, -1), mesh.get_group(i))
        out = out.reshape(g, *shape)
        stride *= g
    out = out.reshape(G, E_l, Cl, d).transpose(0, 1).reshape(E_l * Cp, d)
    out = torch.cat([out, out.new_zeros((1, d))])
    dk = dest[inv].reshape(T, k)[b * Tl:(b + 1) * Tl]
    e, c = dk // C, dk % C
    local = (dk < E * C) & (e >= e0) & (e < e0 + E_l)
    idx = torch.where(local, (e - e0) * Cp + c,
                      torch.full_like(dk, E_l * Cp))
    # each rank's gates meet its own experts' outputs alone: their
    # gradient is summed over the expert split
    for i in ep_dims:
        gates = _SumGradOver.apply(gates, mesh.get_group(i))
    y = (out[idx] * gates.to(xd.dtype)[..., None]).sum(dim=1)
    y = _sum_over(y, mesh, ep_dims).reshape(B // G, S, d)
    y = DTensor.from_local(y, mesh, xpl, run_check=False,
                           shape=torch.Size((B, S, d)),
                           stride=_contiguous_stride((B, S, d)))

    # the Switch load-balance term over every token
    me = _sum_over(probs.sum(dim=0), mesh, rows) / T
    ce = _sum_over(torch.nn.functional.one_hot(eidx[:, 0], E).to(
        probs.dtype).sum(dim=0), mesh, rows) / T
    aux = DTensor.from_local(E * torch.sum(me * ce), mesh,
                             [Replicate()] * mesh.ndim, run_check=False)
    return y, aux


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
    held = [q if isinstance(q, Shard) and q.dim == 0 else Replicate()
            for q in table.placements]
    # a rank looks up only its own tokens: the rows' gradient is a pending
    # sum over the mesh dims that split the tokens
    rows = table.redistribute(mesh, held).to_local(grad_placements=[
        Partial() if isinstance(t, Shard) else q
        for t, q in zip(tok_pl, held)])
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
