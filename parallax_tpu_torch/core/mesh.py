"""The ``('repl', 'shard')`` mesh over ``torch.distributed`` ranks
(``parallax_tpu/core/mesh.py`` without the ``'pipe'`` axis).

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

Every rank builds one process group per repl row (the shard group, the
ranks a table's rows are spread over) and one per shard column (the
repl group), in one order, beside the world group. A group of one rank
is not built: collectives over it are the identity and are skipped.
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
# the JAX mesh's pipeline axis: this mesh has none, and resolve_spec
# maps it onto 'shard' as the JAX package does on a mesh without one
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
    """``repl`` x ``shard`` ranks; this process is ``rank``. ``world``,
    ``shard_group`` and ``repl_group`` are None without a process group
    (one rank, nothing to communicate)."""

    device: torch.device
    repl: int = 1
    shard: int = 1
    rank: int = 0
    world: Optional[Group] = None
    shard_group: Optional[Group] = None
    repl_group: Optional[Group] = None

    @property
    def shape(self):
        return {AXIS_REPL: self.repl, AXIS_SHARD: self.shard}

    @property
    def size(self) -> int:
        return self.repl * self.shard

    @property
    def coords(self):
        """This rank's (repl row, shard column)."""
        return divmod(self.rank, self.shard)

    @property
    def distributed(self) -> bool:
        return self.world is not None


def build_mesh(device, num_partitions: Optional[int] = None,
               shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh of every rank of the initialised process group (one rank
    without one). ``shape=(dp, tp)`` pins both axes and must tile the
    rank count; ``num_partitions`` (exclusive with ``shape``) is the
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
        if len(shape) == 3:
            raise NotImplementedError(
                f"build_mesh shape {tuple(shape)}: the 'pipe' axis "
                f"(pipeline parallelism) is not ported; pass (dp, tp)")
        if len(shape) != 2:
            raise ValueError(f"build_mesh shape {tuple(shape)} must be "
                             f"(dp, tp)")
        r, p = int(shape[0]), int(shape[1])
        if r < 1 or p < 1 or r * p != n:
            raise ValueError(
                f"build_mesh shape {tuple(shape)} does not tile the {n} "
                f"rank(s); dp*tp must equal the rank count")
    else:
        want = num_partitions if num_partitions else n
        p = snap_to_divisor(want, n)
        if p != max(1, min(want, n)):
            parallax_log.warning(
                "num_partitions=%d does not divide device count %d; "
                "snapping to %d", want, n, p)
        r = n // p
    if not on:
        return Mesh(torch.device(device), r, p, rank)
    world = Group(tuple(range(n)), dist.group.WORLD)

    def group(ranks):
        # one call per group on every rank, in one order, members or not
        if len(ranks) == 1:
            return Group(tuple(ranks))
        if len(ranks) == n:
            return world
        return Group(tuple(ranks), dist.new_group(list(ranks)))

    rows = [group(range(i * p, (i + 1) * p)) for i in range(r)]
    cols = [group(range(j, n, p)) for j in range(p)]
    i, j = divmod(rank, p)
    return Mesh(torch.device(device), r, p, rank, world, rows[i], cols[j])


def num_shards(mesh: Mesh) -> int:
    return mesh.shard


def num_devices(mesh: Mesh) -> int:
    return mesh.size
