"""Collectives over the mesh's process groups, and the batch reductions
a loss needs to be the global batch's.

The JAX package computes one loss over the global array; here each rank
computes its share. The engine averages every gradient that crosses
ranks over the world size, dense and sparse alike (as DDP does).
``global_sum`` closes the gap for losses normalised over the batch: its
forward all-reduces a rank's partial sum, and its backward scales the
gradient by the world size, so that the engine's average gives back the
gradient of the global sum. A loss written with it (LM1B's and NMT's
``sum(l * w) / sum(w)``, ``global_mean``) has JAX's value on every rank
and JAX's gradients, whatever each rank's share of ``w``; a plain
per-rank mean over equal shares also gets JAX's gradients.

Every function is the identity where there is no process group (one
process) or the group has one rank, so a model written with them runs
unchanged on one card. The names used exist in torch 2.11 and 2.13:
``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``.
Every rank calls every collective, in one order.

Where a model's ``batch_specs`` put the batch on ``'repl'`` alone (the
tensor-parallel models: ``'shard'`` is the tensor-parallel axis, so the
ranks of a shard group hold the same rows), the batch is split over the
repl group only: ``global_sum`` then all-reduces over the repl group and
scales its backward by the repl size, and the engine averages over the
repl group (``mesh_scope(..., batch_on_repl=True)``).

The tensor-parallel operators (Megatron's f and g, and the
sequence-parallel gathers and scatters) are ``torch.autograd.Function``s
over a group of the mesh: ``copy_to`` (identity forward, all-reduce
backward), ``reduce_from`` (all-reduce forward, identity backward),
``gather_along`` (all-gather a dim forward; backward this member's chunk,
or the reduce-scatter of the gradient), ``split_along`` (this member's
chunk forward, all-gather backward) and ``reduce_scatter_along``
(reduce-scatter forward, all-gather backward). On meta tensors every
collective gives the shape it would and moves nothing, and
``count_scope`` counts the collectives issued inside it.

``ring_shift`` is the ring attention's K/V rotation over the shard group
(``lax.ppermute`` with the ``(i, (i + 1) % n)`` pairs,
``parallax_tpu/ops/ring_attention.py:174-179``): each member sends its
tensors to the next member and receives the previous member's, by
non-blocking point-to-point sends and receives that are all posted
before any is waited on, so no member blocks on a send its neighbour has
not yet received. Its backward shifts the gradients the other way. All
the tensors of one rotation go in one autograd node, in one order, so
every member's backward posts its sends and receives in the same order
as its neighbours' (one node per rotation also chains the rotations,
which fixes the order of their backwards). On a shard axis of 1 it is
the identity and moves nothing.

``all_to_all`` is the tiled exchange of the expert-parallel MoE
(``jax.lax.all_to_all(x, 'shard', split_axis=0, concat_axis=0,
tiled=True)``, ``parallax_tpu/ops/moe.py:120-122``): member ``i`` sends
its ``j``-th dim-0 chunk to member ``j`` and receives member ``j``'s
``i``-th chunk into its ``j``-th, through ``all_to_all_single``. The
exchange is its own adjoint, so its backward is the same exchange of
the gradients. On a group of one rank it is the identity.

The sequence layout (``Model.batch_specs`` of ``P('repl', 'shard')``:
the batch over 'repl', the sequence over 'shard') splits the batch's
tokens over the world, as the default layout does, so ``global_sum``
reduces over the world there too; each rank of a shard group is fed its
repl row's whole rows and takes its own block of the sequence
(``shard_index``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

# the dense gradients' flat buckets (LM1B's 37.8 MB is one)
BUCKET_BYTES = 64 << 20

_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "parallax_collectives_mesh", default=(None, False))
# {collective name: count} of the innermost count_scope, or None
_COUNTS: contextvars.ContextVar = contextvars.ContextVar(
    "parallax_collectives_counts", default=None)


@contextlib.contextmanager
def mesh_scope(mesh, batch_on_repl: bool = False):
    """Make ``mesh`` the current mesh for the collectives inside (the
    engine installs it around the step's loss and updates);
    ``batch_on_repl``: the batch rides 'repl' alone (see the module
    doc)."""
    token = _MESH.set((mesh, bool(batch_on_repl)))
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh the engine installed for the running step (None outside
    one, e.g. a single-process reference run)."""
    return _MESH.get()[0]


def batch_on_repl() -> bool:
    """True inside a scope whose batch rides 'repl' alone: the ranks of a
    shard group hold the same rows."""
    return _MESH.get()[1]


def batch_group(mesh):
    """The group the batch is split over: the repl group when the batch
    rides 'repl' alone, else the world."""
    return mesh.repl_group if batch_on_repl() else mesh.world


@contextlib.contextmanager
def count_scope():
    """Count the collectives issued inside (groups of one rank issue
    none): yields ``{"all_reduce", "all_gather", "reduce_scatter",
    "collective_permute", "all_to_all"}`` -> count, filled as they run
    (one ``collective_permute`` a tensor ``ring_shift`` moves)."""
    counts = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
              "collective_permute": 0, "all_to_all": 0}
    token = _COUNTS.set(counts)
    try:
        yield counts
    finally:
        _COUNTS.reset(token)


def _count(name: str) -> None:
    counts = _COUNTS.get()
    if counts is not None:
        counts[name] += 1


def _pg(group):
    return None if group is None or group.size == 1 else group.pg


def all_reduce_(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """Sum ``x`` over ``group`` (or reduce it with ``op``, a
    ``torch.distributed.ReduceOp``), in place."""
    pg = _pg(group)
    if pg is not None and x.device.type != "meta":
        _count("all_reduce")
        torch.distributed.all_reduce(
            x, op=torch.distributed.ReduceOp.SUM if op is None else op,
            group=pg)
    return x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The members' ``x`` concatenated on dim 0, in rank order."""
    pg = _pg(group)
    if pg is None:
        return x
    x = x.contiguous()
    out = x.new_empty((group.size * x.shape[0],) + tuple(x.shape[1:]))
    if x.device.type != "meta":
        _count("all_gather")
        torch.distributed.all_gather_into_tensor(out, x, group=pg)
    return out


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, member ``i`` keeping the ``i``-th of
    its equal dim-0 blocks."""
    pg = _pg(group)
    if pg is None:
        return x
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // group.size,) + tuple(x.shape[1:]))
    if x.device.type != "meta":
        _count("reduce_scatter")
        torch.distributed.reduce_scatter_tensor(out, x, group=pg)
    return out


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.device.type != "meta":
        _count("all_to_all")
        torch.distributed.all_to_all_single(out, x, group=group.pg)
    return out


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The tiled all-to-all over ``group`` on dim 0 (see the module doc):
    ``x`` splits into ``group.size`` equal dim-0 chunks; chunk ``j`` of
    the result is member ``j``'s chunk for this member. The gradient is
    the same exchange of the gradient."""
    if _pg(group) is None:
        return x
    if x.shape[0] % group.size:
        raise ValueError(
            f"all_to_all: dim 0 ({x.shape[0]}) does not split over the "
            f"{group.size} members")
    return _AllToAll.apply(x, group)


def shard_index(mesh=None) -> int:
    """This rank's place on the shard axis (0 without a mesh): the
    block of the sequence it holds under the sequence layout."""
    mesh = mesh if mesh is not None else current_mesh()
    return 0 if mesh is None else mesh.coords[1]


def _shift(tensors, group, index: int, step: int):
    """Each of ``tensors`` sent to member ``index + step`` of ``group``
    and the same-shaped tensors of member ``index - step`` received, one
    rotation; every send and receive posted before any is waited on."""
    n = group.size
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in tensors]
    if tensors[0].device.type == "meta":
        return outs
    dst = group.ranks[(index + step) % n]
    src = group.ranks[(index - step) % n]
    dist = torch.distributed
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group.pg)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, src, group.pg) for o in outs]
    for _ in tensors:
        _count("collective_permute")
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingShift(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, index, *tensors):
        ctx.cfg = (group, index)
        return tuple(_shift(tensors, group, index, 1))

    @staticmethod
    def backward(ctx, *grads):
        group, index = ctx.cfg
        return (None, None) + tuple(_shift(grads, group, index, -1))


def ring_shift(tensors, group, index: int):
    """The members' ``tensors`` rotated one place around ``group``: member
    ``index`` gets member ``index - 1``'s (mod the group size); the
    gradients rotate back. One rotation is one autograd node (see the
    module doc). The identity on a group of one rank."""
    tensors = tuple(tensors)
    if _pg(group) is None:
        return tensors
    return _RingShift.apply(group, index, *tensors)


class _Anchor(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, *tensors):
        ctx.specs = [(t.shape, t.dtype, t.device) for t in tensors]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=v)
                            for s, d, v in ctx.specs)


def anchor(x: torch.Tensor, *tensors) -> torch.Tensor:
    """``x`` as it is, with ``tensors`` given zero gradients through it:
    puts a ring's last rotated blocks on the loss's path on every member,
    so every member runs every rotation's backward (a member that used
    no rotated block would otherwise skip the backwards its neighbours
    wait for)."""
    if not torch.is_grad_enabled() or not any(
            t.requires_grad for t in tensors):
        return x
    return _Anchor.apply(x, *tensors)


def _on_dim(fn, x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``fn`` (a dim-0 collective) applied along ``dim``."""
    if dim % x.dim() == 0:
        return fn(x, group)
    return fn(x.movedim(dim, 0), group).movedim(0, dim)


def _chunk(x: torch.Tensor, group, index: int, dim: int) -> torch.Tensor:
    """Member ``index``'s chunk of ``x`` along ``dim`` (of ``group.size``
    equal chunks)."""
    if group is None or group.size == 1:
        return x
    n = x.shape[dim] // group.size
    return x.narrow(dim, index * n, n).contiguous()


def _fresh(g: torch.Tensor) -> torch.Tensor:
    return g.clone(memory_format=torch.contiguous_format)


class _CopyTo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(_fresh(g), ctx.group), None


class _ReduceFrom(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(_fresh(x), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, index, dim, grad_sums):
        ctx.cfg = (group, index, dim, grad_sums)
        return _on_dim(all_gather, x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, index, dim, grad_sums = ctx.cfg
        if grad_sums:
            g = _on_dim(reduce_scatter, g, group, dim)
        else:
            g = _chunk(g, group, index, dim)
        return g, None, None, None, None


class _SplitAlong(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, index, dim):
        ctx.cfg = (group, dim)
        return _chunk(x, group, index, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.cfg
        return _on_dim(all_gather, g, group, dim), None, None, None


class _ReduceScatterAlong(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.cfg = (group, dim)
        return _on_dim(reduce_scatter, x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.cfg
        return _on_dim(all_gather, g, group, dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: ``x`` as it is; its gradient all-reduced over
    ``group`` (each member's use of ``x`` contributes a part)."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: ``x`` summed over ``group``; the gradient as it is
    (the sum is used alike on every member)."""
    return _ReduceFrom.apply(x, group)


def gather_along(x: torch.Tensor, group, index: int, dim: int,
                 grad_sums: bool = False) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim``; member ``index``'s
    gradient is its chunk of the whole one (used alike on every
    member), or with ``grad_sums`` the chunk of the members' gradients
    summed (each member used the whole differently)."""
    return _GatherAlong.apply(x, group, index, dim, grad_sums)


def split_along(x: torch.Tensor, group, index: int, dim: int
                ) -> torch.Tensor:
    """Member ``index``'s chunk of ``x`` (alike on every member) along
    ``dim``; the gradient is the members' chunks' gradients gathered."""
    return _SplitAlong.apply(x, group, index, dim)


def reduce_scatter_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` summed over ``group``, each member keeping its chunk along
    ``dim``; the gradient is the members' chunks' gradients gathered."""
    return _ReduceScatterAlong.apply(x, group, dim)


class _GlobalSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = group.size
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a rank's partial sum) summed over the ranks the batch is
    split over (``batch_group``); the gradient is scaled by their count
    (see the module doc)."""
    mesh = current_mesh()
    if mesh is None or mesh.world is None:
        return x
    return _GlobalSum.apply(x, batch_group(mesh))


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over every entry of every rank's share (equal
    shares); ``torch.mean(x)`` where there is one rank."""
    mesh = current_mesh()
    if mesh is None or mesh.world is None:
        return torch.mean(x)
    return global_sum(x.sum()) / (x.numel() * batch_group(mesh).size)


class _GatherRows(torch.autograd.Function):
    """A row-sharded variable's shards gathered for use; the gradient is
    reduce-scattered back onto the shards over 'shard' (or, where the
    batch rides 'repl' alone and the shard group's gradients are alike,
    each rank's own rows taken) and summed over 'repl'."""

    @staticmethod
    def forward(ctx, shard, mesh, alike):
        ctx.mesh, ctx.alike = mesh, alike
        return all_gather(shard, mesh.shard_group)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = _chunk(g, mesh.shard_group, mesh.coords[1], 0) if ctx.alike \
            else reduce_scatter(g, mesh.shard_group)
        return all_reduce_(g, mesh.repl_group), None, None


def gather_rows(shard: torch.Tensor, mesh) -> torch.Tensor:
    """The whole variable from this rank's row shard (every rank of the
    shard group calls it together)."""
    return _GatherRows.apply(shard, mesh, batch_on_repl())


def flat_all_reduce_(tensors, group, scale: Optional[float] = None
                     ) -> None:
    """Sum every tensor of ``tensors`` over ``group`` in place, in flat
    buckets of at most ``BUCKET_BYTES`` per dtype (one collective a
    bucket), then multiply by ``scale`` when given. The collective runs
    on a group of one rank as well (where it is the identity), so a
    one-rank process group runs the same step as a larger one; a group
    of one rank that has no process group of its own (a row or column
    of one) moves nothing."""
    if group is None:
        return
    if group.pg is None:
        tensors = list(tensors)
        if scale is not None and tensors:
            torch._foreach_mul_(tensors, scale)
        return
    buckets = {}
    for t in tensors:
        bs = buckets.setdefault(t.dtype, [[]])
        if bs[-1] and sum(x.numel() for x in bs[-1]) * t.element_size() \
                + t.numel() * t.element_size() > BUCKET_BYTES:
            bs.append([])
        bs[-1].append(t)
    for bs in buckets.values():
        for bucket in bs:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            _count("all_reduce")
            torch.distributed.all_reduce(flat, group=group.pg)
            if scale is not None:
                flat.mul_(scale)
            torch._foreach_copy_(bucket, [
                v.view_as(t) for v, t in zip(torch.split(
                    flat, [t.numel() for t in bucket]), bucket)])
            del flat
