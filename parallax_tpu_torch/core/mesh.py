"""The ``('repl', 'shard')`` mesh over ``torch.distributed`` ranks, and
its third axis ``'pipe'`` (``parallax_tpu/core/mesh.py``).

Each rank is one process on one card (on the CPU, one process). Ranks
form ``repl`` rows of ``shard`` columns with ``'shard'`` innermost, so
rank ``r * shard + s`` holds the JAX mesh's device ``(r, s)`` and that
device's slice of the batch (``batch_spec``: dim 0 over both axes).
Dense variables are replicated on every rank; sparse tables are
row-sharded over ``'shard'`` and replicated over ``'repl'``.

``P`` specs follow the JAX package's ``PartitionSpec``; ``TPSpec``
marks a tensor-parallel weight (``ops.tensor_parallel``) and
``ExpertSpec`` an expert weight (``ops.moe``), whose rank keeps and uses
its part, and ``resolve_spec`` maps a spec onto this mesh's axes as
JAX's does.

``build_mesh(shape=(dp, tp, pp))`` grows the pipeline axis: ``pp``
stages nested inside each shard column, axes ``('repl', 'shard',
'pipe')``, the stage ring innermost, so rank ``(r * shard + s) * pipe +
q`` holds the JAX mesh's device ``(r, s, q)``. ``pp = 1`` builds the
two-axis mesh exactly. The pipeline schedules (``ops/pipeline.py``) run
their ring over ``pipeline_group``: the pipe group on a three-axis mesh,
else the shard group (stages over 'shard', as the JAX package places
them on a mesh without a pipe axis).

Every rank builds one process group per repl row (the shard group, the
ranks a table's rows are spread over), one per shard column (the repl
group) and, on a three-axis mesh, one per (repl, shard) pair (the pipe
group), in one order, beside the world group. A group of one rank is
not built: collectives over it are the identity and are skipped.
Without a process group (one process, ``torch.distributed`` not
initialised) the mesh is one rank with no groups at all.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from parallax_tpu_torch.common.lib import parallax_log

AXIS_REPL = "repl"
AXIS_SHARD = "shard"
# the pipeline axis of a three-axis mesh; resolve_spec maps it onto
# 'shard' on a mesh without one, as the JAX package does
AXIS_PIPE = "pipe"
BATCH_AXES = (AXIS_REPL, AXIS_SHARD)


class P(tuple):
    """A PartitionSpec: one entry per dim, each an axis name, a tuple of
    axis names or None (``P()`` is replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


class TPSpec(P):
    """A tensor-parallel spec (``ops.tensor_parallel``'s param specs):
    the variable is split over 'shard' on the dim that names it, and
    each rank computes with its own part, never gathered for use. A
    column spec (the last dim over 'shard') splits output features, a
    row spec (dim 0 over 'shard') input features; a plain ``P('shard',
    None)`` keeps its meaning of a row-sharded variable gathered for
    use. ``groups`` > 1 splits each of that many equal blocks of the
    dim (a fused ``[q | k | v]``): a rank holds its part of every
    block, in block order."""

    def __new__(cls, *entries, groups: int = 1):
        self = super().__new__(cls, *entries)
        self.groups = int(groups)
        return self

    def __repr__(self):
        g = f", groups={self.groups}" if self.groups != 1 else ""
        return f"TPSpec{tuple(self)!r}"[:-1] + g + ")"


class ExpertSpec(P):
    """An expert-parallel spec (``ops.moe``'s expert weights ``[E, ...]``):
    dim 0, the experts, over 'shard'. Each rank holds E/n experts and
    computes with them as they are, never gathered; the all-to-all of
    the dispatch brings their gradient summed over the shard group. A
    plain ``P('shard', None, ...)`` keeps its meaning of a row-sharded
    variable (a table looked up through ``embedding_lookup``, or a dense
    variable gathered for use)."""

    def __repr__(self):
        return f"ExpertSpec{tuple(self)!r}"


def resolve_spec(spec: P, mesh: "Mesh" = None) -> P:
    """``spec`` on this mesh's axes (``parallax_tpu/core/mesh.py``'s
    ``resolve_spec``): a 'pipe' entry becomes 'shard', the
    stages-over-shard placement of a mesh without a pipe axis; other
    entries pass through. A ``TPSpec`` keeps its kind and groups, an
    ``ExpertSpec`` its kind."""

    def one(entry):
        if entry == AXIS_PIPE:
            return AXIS_SHARD
        if isinstance(entry, (tuple, list)):
            return tuple(one(e) for e in entry)
        return entry

    entries = tuple(one(e) for e in spec)
    if isinstance(spec, TPSpec):
        return TPSpec(*entries, groups=spec.groups)
    if isinstance(spec, ExpertSpec):
        return ExpertSpec(*entries)
    return P(*entries)


def dim0_axes(spec: P) -> tuple:
    """The mesh axes dim 0 of ``spec`` is split over (``()``: none)."""
    if len(spec) == 0 or spec[0] is None:
        return ()
    return (spec[0],) if isinstance(spec[0], str) else tuple(spec[0])


def batch_spec(ndim: int = 1) -> P:
    """Batch sharded over the flattened mesh on dim 0."""
    return P(BATCH_AXES, *([None] * (ndim - 1)))


def replicated_spec() -> P:
    return P()


def row_sharded_spec(ndim: int) -> P:
    """Row-sharded over 'shard', replicated over 'repl'."""
    return P(AXIS_SHARD, *([None] * (ndim - 1)))


def snap_to_divisor(p: int, n: int) -> int:
    """The shard-axis width used for a requested count ``p`` on ``n``
    ranks: clamped to [1, n], then the largest divisor of ``n`` not
    above the request (reference mesh.py:63)."""
    p = max(1, min(int(p), int(n)))
    if n % p != 0:
        p = max(d for d in range(1, p + 1) if n % d == 0)
    return p


@dataclasses.dataclass(frozen=True)
class Group:
    """One process group of the mesh: its ranks and the
    ``torch.distributed`` group (None for a group of one rank, whose
    collectives are skipped)."""

    ranks: tuple
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``repl`` x ``shard`` (x ``pipe``) ranks; this process is ``rank``.
    ``world``, ``shard_group``, ``repl_group`` and ``pipe_group`` are None
    without a process group (one rank, nothing to communicate);
    ``pipe_group`` is None on a two-axis mesh too."""

    device: torch.device
    repl: int = 1
    shard: int = 1
    rank: int = 0
    world: Optional[Group] = None
    shard_group: Optional[Group] = None
    repl_group: Optional[Group] = None
    pipe: int = 1
    pipe_group: Optional[Group] = None

    @property
    def axis_names(self) -> tuple:
        return (AXIS_REPL, AXIS_SHARD) + ((AXIS_PIPE,) if self.pipe > 1
                                          else ())

    @property
    def shape(self):
        out = {AXIS_REPL: self.repl, AXIS_SHARD: self.shard}
        if self.pipe > 1:
            out[AXIS_PIPE] = self.pipe
        return out

    @property
    def size(self) -> int:
        return self.repl * self.shard * self.pipe

    @property
    def coords(self):
        """This rank's (repl row, shard column)."""
        r, rest = divmod(self.rank, self.shard * self.pipe)
        return r, rest // self.pipe

    @property
    def pipe_index(self) -> int:
        """This rank's place on the pipe axis (0 on a two-axis mesh)."""
        return self.rank % self.pipe

    @property
    def distributed(self) -> bool:
        return self.world is not None


def build_mesh(device, num_partitions: Optional[int] = None,
               shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh of every rank of the initialised process group (one rank
    without one). ``shape=(dp, tp)`` pins both axes and must tile the
    rank count; ``shape=(dp, tp, pp)`` adds ``pp`` pipeline stages
    inside each shard column (``pp = 1`` is the two-axis mesh);
    ``num_partitions`` (exclusive with ``shape``) is the
    shard-axis width, snapped to a divisor of the rank count with a
    warning; neither gives one shard column per rank. Every rank must
    call this with the same arguments: it creates the row and column
    process groups collectively."""
    dist = torch.distributed
    on = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    if shape is not None:
        if num_partitions is not None:
            raise ValueError("build_mesh: pass shape=(dp, tp) OR "
                             "num_partitions, not both")
        if len(shape) not in (2, 3):
            raise ValueError(f"build_mesh shape {tuple(shape)} must be "
                             f"(dp, tp) or (dp, tp, pp)")
        r, p = int(shape[0]), int(shape[1])
        q = int(shape[2]) if len(shape) == 3 else 1
        if r < 1 or p < 1 or q < 1 or r * p * q != n:
            raise ValueError(
                f"build_mesh shape {tuple(shape)} does not tile the {n} "
                f"rank(s); dp*tp*pp must equal the rank count")
    else:
        want = num_partitions if num_partitions else n
        p = snap_to_divisor(want, n)
        if p != max(1, min(want, n)):
            parallax_log.warning(
                "num_partitions=%d does not divide device count %d; "
                "snapping to %d", want, n, p)
        r, q = n // p, 1
    if not on:
        return Mesh(torch.device(device), r, p, rank, pipe=q)
    world = Group(tuple(range(n)), dist.group.WORLD)

    def group(ranks):
        # one call per group on every rank, in one order, members or not
        if len(ranks) == 1:
            return Group(tuple(ranks))
        if len(ranks) == n:
            return world
        return Group(tuple(ranks), dist.new_group(list(ranks)))

    # rank (i * p + j) * q + k is device (i, j, k)
    rows = {(i, k): group([(i * p + j) * q + k for j in range(p)])
            for i in range(r) for k in range(q)}
    cols = {(j, k): group([(i * p + j) * q + k for i in range(r)])
            for j in range(p) for k in range(q)}
    pipes = {(i, j): group([(i * p + j) * q + k for k in range(q)])
             for i in range(r) for j in range(p)} if q > 1 else {}
    i, rest = divmod(rank, p * q)
    j, k = divmod(rest, q)
    return Mesh(torch.device(device), r, p, rank, world, rows[(i, k)],
                cols[(j, k)], q, pipes.get((i, j)))


def num_shards(mesh: Mesh) -> int:
    return mesh.shard


def num_devices(mesh: Mesh) -> int:
    return mesh.size


def pipeline_axis(mesh: Mesh) -> str:
    """The axis the pipeline stages ride: 'pipe' on a three-axis mesh,
    else 'shard'."""
    return AXIS_PIPE if mesh.pipe > 1 else AXIS_SHARD


def pipeline_stage_count(mesh: Mesh) -> int:
    return mesh.pipe if mesh.pipe > 1 else mesh.shard


def pipeline_group(mesh: Mesh) -> Optional[Group]:
    """The ranks of this rank's stage ring (``pipeline_axis``)."""
    return mesh.pipe_group if mesh.pipe > 1 else mesh.shard_group


def pipeline_index(mesh: Mesh) -> int:
    """This rank's stage on the ring."""
    return mesh.pipe_index if mesh.pipe > 1 else mesh.coords[1]
