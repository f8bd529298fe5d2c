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
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

# the dense gradients' flat buckets (LM1B's 37.8 MB is one)
BUCKET_BYTES = 64 << 20

_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "parallax_collectives_mesh", default=None)


@contextlib.contextmanager
def mesh_scope(mesh):
    """Make ``mesh`` the current mesh for the collectives inside (the
    engine installs it around the step's loss and updates)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh the engine installed for the running step (None outside
    one, e.g. a single-process reference run)."""
    return _MESH.get()


def _pg(group):
    return None if group is None or group.size == 1 else group.pg


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group``, in place."""
    pg = _pg(group)
    if pg is not None:
        torch.distributed.all_reduce(x, group=pg)
    return x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The members' ``x`` concatenated on dim 0, in rank order."""
    pg = _pg(group)
    if pg is None:
        return x
    x = x.contiguous()
    out = x.new_empty((group.size * x.shape[0],) + tuple(x.shape[1:]))
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
    torch.distributed.reduce_scatter_tensor(out, x, group=pg)
    return out


class _GlobalSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = group.size
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a rank's partial sum) summed over every rank of the current
    mesh; the gradient is scaled by the world size (see the module
    doc)."""
    mesh = current_mesh()
    if mesh is None or mesh.world is None:
        return x
    return _GlobalSum.apply(x, mesh.world)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over every entry of every rank's share (equal
    shares); ``torch.mean(x)`` where there is one rank."""
    mesh = current_mesh()
    if mesh is None or mesh.world is None:
        return torch.mean(x)
    return global_sum(x.sum()) / (x.numel() * mesh.world.size)


class _GatherRows(torch.autograd.Function):
    """A row-sharded variable's shards gathered for use; the gradient is
    reduce-scattered back onto the shards over 'shard' and summed over
    'repl'."""

    @staticmethod
    def forward(ctx, shard, mesh):
        ctx.mesh = mesh
        return all_gather(shard, mesh.shard_group)

    @staticmethod
    def backward(ctx, g):
        g = reduce_scatter(g, ctx.mesh.shard_group)
        return all_reduce_(g, ctx.mesh.repl_group), None


def gather_rows(shard: torch.Tensor, mesh) -> torch.Tensor:
    """The whole variable from this rank's row shard (every rank of the
    shard group calls it together)."""
    return _GatherRows.apply(shard, mesh)


def flat_all_reduce_(tensors, group, scale: Optional[float] = None
                     ) -> None:
    """Sum every tensor of ``tensors`` over ``group`` in place, in flat
    buckets of at most ``BUCKET_BYTES`` per dtype (one collective a
    bucket), then multiply by ``scale`` when given. The collective runs
    on a group of one rank as well (where it is the identity), so a
    one-rank process group runs the same step as a larger one."""
    if group is None:
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
            torch.distributed.all_reduce(flat, group=group.pg)
            if scale is not None:
                flat.mul_(scale)
            torch._foreach_copy_(bucket, [
                v.view_as(t) for v, t in zip(torch.split(
                    flat, [t.numel() for t in bucket]), bucket)])
            del flat
