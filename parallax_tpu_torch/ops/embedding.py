"""Embedding lookups: the plain gather, the slices-mode capture, and
the row-sharded lookup over the mesh (``parallax_tpu.ops.embedding``).

``SliceCapture`` is the counterpart of the JAX package's (ops/
embedding.py:63): while one is active, a lookup of a registered table
reads the rows from the table with no gradient path back to it and
hands them on as a fresh leaf tensor, recording ``(path, ids, rows)``.
The gradient of the loss with respect to ``rows`` is then exactly the
IndexedSlices pair ``(ids, per-occurrence row gradients)``, with no
[V, D] gradient. The engine applies it scatter-only
(ops/sparse_optim.py).

The sharded lookup (reference ops/embedding.py:111-584) is the
parameter server of the reference re-expressed as collectives. A
table the plan row-shards lives on each rank as its rows
``[s * V/p, (s + 1) * V/p)`` for shard column ``s``; inside the
engine's ``sharded_lookup_scope``, ``embedding_lookup`` of such a shard:

  forward:  all-gather the ids over 'shard'   (int32, O(batch))
            masked local gather               (each rank reads its rows)
            reduce-scatter the rows over 'shard'
  backward: all-gather the row gradients (and ids) over 'shard'
            masked scatter-add into the owned rows
            all-reduce over 'repl' (or, with the sparse cross-replica
            combine, the gathers span the whole mesh instead)

so the bytes on the wire are O(batch * dim), never O(vocab * dim).
Where the batch layout repeats rows over an axis
(``collectives.alike_axes()``: the batch on 'repl' alone, as the
tensor-parallel models have it, whose shard group holds the same rows;
on 'shard' alone; or whole on every rank), the ranks along those axes
hold the same ids: rank i of that group looks up chunk i of its ids
along dim 0 and the rows are all-gathered over the group after the
exchange (backward: each rank's chunk of the gradient), as the JAX
``shard_map`` takes the ids as ``P(('repl', 'shard'))``: every id
crosses the wire once, the backward counts each occurrence once, and
the lookup records and ``dedup_capacity`` count what the JAX ones
count.
``average_duplicates`` divides each row's gradient by its occurrence
count over the global batch (after the repl merge).
``local_aggregation`` first sums each rank's duplicate ids into unique
slots at the static capacity of ``_dedup_capacity`` (a sort-based
unique, no host sync); a declared ``dedup_capacity`` below the exact
bound is guarded: every rank counts its distinct ids, the flag is
all-reduced over the whole mesh, and a step on which any rank
overflows takes the uncompressed exchange. That choice is read on the
host once a lookup, so the engine runs such a configuration eagerly.
No id is ever dropped. On one shard the lookup is the plain gather.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from parallax_tpu_torch.ops import collectives
from parallax_tpu_torch.ops.collectives import current_mesh  # noqa: F401


def pad_vocab(vocab_size: int, multiple: int) -> int:
    """Round vocab up so rows split evenly over ``multiple`` shards."""
    return -(-vocab_size // multiple) * multiple


def padded_vocab_for(vocab_size: int, num_partitions: int = 1) -> int:
    """Shared padding policy for model configs: pad so the table splits
    evenly over ``num_partitions``. Unlike the JAX package, which falls
    back to the visible device count, the partition count is explicit
    here (None means 1)."""
    return pad_vocab(vocab_size, max(num_partitions or 1, 1))


def mask_padded_logits(logits: torch.Tensor, vocab_size: int,
                       first: int = 0) -> torch.Tensor:
    """Push the phantom classes introduced by vocab padding to -1e9 so
    they never win an argmax or receive probability mass (last-dim
    layout [..., padded_vocab]). ``first``: the class of column 0, for
    the logits of a row shard's classes (``row_shard_offset``)."""
    padded = logits.shape[-1]
    if first + padded <= vocab_size:
        return logits
    mask = torch.zeros((padded,), dtype=logits.dtype,
                       device=logits.device)
    mask[max(vocab_size - first, 0):] = -1e9
    return logits + mask


class SliceCapture:
    """Per-step state of the engine's "slices" sparse-gradient mode:
    ``table_paths`` maps ``id(table tensor)`` to its parameter path;
    ``captured`` collects ``(path, ids, rows)`` per lookup, in order."""

    def __init__(self, table_paths: Dict[int, str]):
        self.table_paths = dict(table_paths)
        self.captured = []

    def path_of(self, table) -> Optional[str]:
        return self.table_paths.get(id(table))


_CAPTURE: contextvars.ContextVar = contextvars.ContextVar(
    "parallax_slice_capture", default=None)


@contextlib.contextmanager
def slice_capture_scope(capture: SliceCapture):
    """Make ``capture`` the active slice capture for lookups inside."""
    token = _CAPTURE.set(capture)
    try:
        yield capture
    finally:
        _CAPTURE.reset(token)


@dataclasses.dataclass
class _MeshCtx:
    mesh: Any
    # id(row-shard tensor) -> (parameter path, the whole table's shape)
    sharded: Dict[int, Tuple[str, Tuple[int, ...]]]
    average_duplicates: bool = False
    local_aggregation: bool = True
    dedup_capacity_hint: Union[int, Dict[Any, int], None] = None
    cross_replica_sparse_hint: Optional[bool] = None
    # one record per sharded lookup: (table shape, ids on the wire,
    # counts on the wire, cross-replica bytes, sparse combine, elem bytes)
    records: Optional[list] = None
    # True once a guarded capacity was used (its steps run eagerly)
    guarded: list = dataclasses.field(default_factory=list)


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "parallax_embedding_mesh_ctx", default=None)


# True while the sharded lookup reads its table (the engine's check that
# no other op reads a row shard skips these reads)
_IN_LOOKUP: contextvars.ContextVar = contextvars.ContextVar(
    "parallax_in_sharded_lookup", default=False)


def in_sharded_lookup() -> bool:
    return _IN_LOOKUP.get()


@contextlib.contextmanager
def sharded_lookup_scope(mesh, sharded_tables,
                         average_duplicates: bool = False,
                         records: Optional[list] = None,
                         local_aggregation: bool = True,
                         dedup_capacity: Union[int, Dict[Any, int],
                                               None] = None,
                         cross_replica_sparse: Optional[bool] = None,
                         batch_axes: tuple = collectives.AXES):
    """Engine-installed scope: inside it, ``embedding_lookup`` of a row
    shard listed in ``sharded_tables`` (``[(shard tensor, whole table
    shape, path)]``) runs the collective lookup, and ``current_mesh()``
    is ``mesh``, the batch split over ``batch_axes`` (see
    ops/collectives.py). Returns the scope's context (its ``guarded``
    list)."""
    ctx = _MeshCtx(mesh, {id(t): (path, tuple(shape))
                          for t, shape, path in sharded_tables},
                   average_duplicates, local_aggregation, dedup_capacity,
                   cross_replica_sparse, records)
    token = _CTX.set(ctx)
    try:
        with collectives.mesh_scope(mesh, batch_axes):
            yield ctx
    finally:
        _CTX.reset(token)


def is_row_shard(table: torch.Tensor) -> bool:
    """Is ``table`` a row shard that ``embedding_lookup`` looks up over
    the mesh (registered with the active ``sharded_lookup_scope``, on a
    shard axis wider than 1)?"""
    ctx = _CTX.get()
    return (ctx is not None and id(table) in ctx.sharded
            and ctx.mesh.shard > 1)


def alias_row_shards(pairs) -> None:
    """Register with the active ``sharded_lookup_scope`` each copy of a
    registered row shard: ``pairs`` of (leaf, its copy), e.g. a serving
    program's compute-dtype cast of its params, whose lookups then run
    the collective lookup too. Nothing outside a scope."""
    ctx = _CTX.get()
    if ctx is None:
        return
    for leaf, copy in pairs:
        entry = ctx.sharded.get(id(leaf))
        if entry is not None and copy is not leaf:
            ctx.sharded[id(copy)] = entry


def row_shard_offset(table: torch.Tensor) -> int:
    """The global row of ``table``'s row 0: its shard column's first row
    for a row shard (``is_row_shard``), else 0."""
    if not is_row_shard(table):
        return 0
    return _CTX.get().mesh.coords[1] * table.shape[0]


def argmax_over_rows(logits: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """``argmax(logits, -1)`` where the last dim of ``logits`` [S, n]
    runs over the rows of ``table``: a plain argmax for a whole table;
    for a row shard, each rank's local (max, global id) pair all-gathered
    over 'shard' and the global argmax taken, ties to the lowest id as
    an argmax over the whole row gives them (the shard columns hold
    ascending rows). int64 ids."""
    local = torch.argmax(logits, dim=-1)
    if not is_row_shard(table):
        return local
    best = logits.gather(-1, local[..., None])[..., 0]
    ids = local + row_shard_offset(table)
    # one all-gather of the (max, id) pairs; float64 holds both exactly
    pairs = collectives.all_gather(
        torch.stack([best.double(), ids.double()]).reshape(1, 2, -1),
        _CTX.get().mesh.shard_group)                      # [p, 2, S]
    vals, gids = pairs[:, 0], pairs[:, 1]
    top = vals.max(dim=0).values
    # the first shard column holding the maximum has the lowest id
    first = torch.argmax((vals == top).to(torch.int32), dim=0)
    return gids.gather(0, first[None])[0].long().reshape(local.shape)


def embedding_lookup(table: torch.Tensor,
                     ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [V, D] at integer ``ids``: a plain gather (the
    replicated layout, where every rank holds the whole table), or the
    collective lookup for a row shard registered with the engine's
    ``sharded_lookup_scope``. A table registered with the active
    ``SliceCapture`` gets its rows as a leaf whose gradient is the
    step's slice for that lookup."""
    # the sparse path's profiler scope (obs/xprof.py joins kernels to it)
    with torch.profiler.record_function("embedding.py"):
        return _lookup(table, ids)


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    capture = _CAPTURE.get()
    path = capture.path_of(table) if capture is not None else None
    ctx = _CTX.get()
    entry = ctx.sharded.get(id(table)) if ctx is not None else None
    if entry is None or ctx.mesh.shard == 1:
        if path is None:
            return F.embedding(ids, table)
        rows = F.embedding(ids, table.detach()).requires_grad_()
    else:
        token = _IN_LOOKUP.set(True)
        try:
            rows = _sharded(ctx, table.detach() if path else table, ids,
                            entry, path)
        finally:
            _IN_LOOKUP.reset(token)
        if path is not None:
            rows = rows.detach().requires_grad_()
    if path is not None:
        capture.captured.append((path, ids, rows))
    return rows


def _sharded(ctx: _MeshCtx, table, ids, entry, slice_path):
    mesh = ctx.mesh
    alike = collectives.alike_axes()
    n_alike = collectives.axes_size(mesh, alike)
    if n_alike == 1:
        return _sharded_ids(ctx, table, ids, entry, slice_path)
    # the ranks along ``alike`` hold the same ids: each takes its chunk
    group = collectives.axis_group(mesh, alike)
    index = collectives.axes_index(mesh, alike)
    if ids.shape[0] % n_alike and not torch.is_grad_enabled():
        # a forward alone (serving a batch that does not split over the
        # alike ranks): every rank looks up all its ids; the exchange
        # gives each rank its own rows, whatever the others hold
        return _sharded_ids(ctx, table, ids, entry, slice_path)
    if ids.shape[0] % n_alike:
        raise ValueError(
            f"embedding_lookup: ids of batch {ids.shape[0]} are alike on "
            f"the {n_alike} ranks along {alike}, so they split over them; "
            f"the batch must divide by {n_alike}")
    n = ids.shape[0] // n_alike
    rows = _sharded_ids(ctx, table, ids[index * n:(index + 1) * n], entry,
                        slice_path)
    return collectives.gather_along(rows, group, index, 0)


def _sharded_ids(ctx: _MeshCtx, table, ids, entry, slice_path):
    mesh = ctx.mesh
    _, shape = entry
    hint = ctx.dedup_capacity_hint
    if (isinstance(hint, dict) and slice_path is not None
            and slice_path in hint):
        # per-parameter capacity (slices mode knows the table's path)
        hint = hint[slice_path]
    n_dev = int(ids.numel())
    cap, guarded = _dedup_capacity(shape, n_dev, ctx.local_aggregation,
                                   hint)
    cap_eff = cap if cap is not None else n_dev
    counts = ctx.average_duplicates and cap is not None
    elem = table.element_size()
    sparse_repl = _choose_sparse_repl(mesh, shape, cap_eff, counts,
                                      ctx.cross_replica_sparse_hint, elem)
    if ctx.records is not None:
        n_eff = cap_eff * mesh.size
        ctx.records.append((tuple(shape), n_eff, n_eff if counts else 0,
                            _cross_replica_bytes(mesh, shape, cap_eff,
                                                 counts, sparse_repl, elem),
                            sparse_repl, elem))
    if guarded:
        ctx.guarded.append(slice_path or entry[0])
    if table.device.type == "meta":
        return torch.empty(tuple(ids.shape) + tuple(shape[1:]),
                           dtype=table.dtype, device="meta")
    over = False
    if guarded:
        over = _overflows(ids.reshape(-1).long(), shape[0], cap, mesh)
    if over:
        cap = None
    return _ShardedLookup.apply(table, ids, mesh, shape[0], cap,
                                ctx.average_duplicates, sparse_repl)


def _cross_replica_bytes(mesh, table_shape, cap_eff: int, counts: bool,
                         sparse_repl: bool, elem_bytes: int = 4) -> int:
    """Mesh-total bytes the table-gradient combine moves across 'repl'
    per step (0 on one repl row): the dense [rows/shard, dim] ring
    all-reduce, or the other rows' deduplicated ids and gradients in
    the whole-mesh gather (reference embedding.py:272-296)."""
    r = mesh.repl
    if r <= 1:
        return 0
    p = mesh.shard
    n = r * p
    V = int(table_shape[0])
    D = int(np.prod(table_shape[1:])) if len(table_shape) > 1 else 1
    if sparse_repl:
        per_slot = D * elem_bytes + 4 + (4 if counts else 0)
        return n * (r - 1) * p * cap_eff * per_slot
    return int(n * 2 * (r - 1) / r * (V // p) * D * elem_bytes)


def _choose_sparse_repl(mesh, table_shape, cap_eff: int, counts: bool,
                        hint: Optional[bool],
                        elem_bytes: int = 4) -> bool:
    """The cross-replica combine, chosen statically by bytes unless the
    config forces it (reference embedding.py:299-313)."""
    if mesh.repl <= 1:
        return False
    if hint is not None:
        return bool(hint)
    return (_cross_replica_bytes(mesh, table_shape, cap_eff, counts,
                                 True, elem_bytes)
            < _cross_replica_bytes(mesh, table_shape, cap_eff, counts,
                                   False, elem_bytes))


def _dedup_capacity(table_shape, n_dev: int, local_aggregation: bool,
                    hint: Union[int, Dict[Any, int], None] = None
                    ) -> Tuple[Optional[int], bool]:
    """(per-rank unique-id slot count or None, guarded) for ``n_dev``
    ids on this rank (reference embedding.py:315-352): the exact bound
    min(ids, vocab + 1) when it compresses; a declared ``hint`` below it
    is guarded; a dict hint is keyed by table shape."""
    if not local_aggregation:
        return None, False
    bound = min(n_dev, int(table_shape[0]) + 1)
    if isinstance(hint, dict):
        hint = hint.get(tuple(table_shape))
    if hint is not None:
        cap = max(1, min(int(hint), bound))
        if cap >= n_dev:
            return None, False
        return cap, cap < bound
    return (bound, False) if bound < n_dev else (None, False)


def _collapse_out_of_range(flat: torch.Tensor, vocab: int) -> torch.Tensor:
    """Every id outside [0, vocab) onto the sentinel ``vocab``, which no
    shard owns."""
    return torch.where((flat >= 0) & (flat < vocab), flat, vocab)


def _sorted_segments(flat: torch.Tensor):
    """(sorted ids, their order, segment of each sorted id, distinct
    count as a 0-d tensor)."""
    s, perm = torch.sort(flat, stable=True)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    seg = torch.cumsum(first, 0) - 1
    return s, perm, seg, first.sum()


def _unique_static(flat: torch.Tensor, cap: int, fill: int):
    """``jnp.unique(flat, size=cap, fill_value=fill, return_inverse=
    True)`` for at most ``cap`` distinct values, sort-based and of static
    shape: (the distinct values ascending, then ``fill``; the slot of
    each entry of ``flat``)."""
    s, perm, seg, _ = _sorted_segments(flat)
    uids = torch.full((cap,), fill, dtype=flat.dtype, device=flat.device)
    uids.scatter_(0, seg, s)
    inv = torch.empty_like(seg).scatter_(0, perm, seg)
    return uids, inv


def _overflows(flat: torch.Tensor, vocab: int, cap: int, mesh) -> bool:
    """Does any rank hold more distinct ids than ``cap``? Summed over the
    whole mesh (both axes), so every rank takes the same branch; read on
    the host (reference embedding.py:367-377)."""
    n_unique = _sorted_segments(_collapse_out_of_range(flat, vocab))[3]
    over = (n_unique > cap).to(torch.int32).reshape(1)
    collectives.all_reduce_(over, mesh.world)
    return bool(over.item() > 0)


def _masked_local_gather(table_shard, ids_all, lo: int, rows_per_shard):
    """The rows this shard owns for the gathered id list; zeros for ids
    owned elsewhere (summed away by the reduce-scatter)."""
    local = ids_all - lo
    valid = (local >= 0) & (local < rows_per_shard)
    rows = F.embedding(torch.where(valid, local, 0), table_shard)
    return torch.where(valid[:, None], rows, 0)


class _ShardedLookup(torch.autograd.Function):
    """The sharded lookup's forward and backward (reference
    embedding.py:393-584): ``cap`` None is the uncompressed exchange."""

    @staticmethod
    def forward(ctx, table, ids, mesh, V, cap, average, sparse_repl):
        rows_per_shard = V // mesh.shard
        lo = mesh.coords[1] * rows_per_shard
        flat = ids.reshape(-1).long()
        D = table.shape[1]

        def exchange(fl):
            ids_all = collectives.all_gather(fl.int(),
                                             mesh.shard_group).long()
            rows = _masked_local_gather(table, ids_all, lo, rows_per_shard)
            return collectives.reduce_scatter(rows, mesh.shard_group)

        inv = None
        if cap is None:
            out = exchange(flat)
            ctx.save_for_backward(flat)
        else:
            uids, inv = _unique_static(_collapse_out_of_range(flat, V),
                                       cap, V)
            out = exchange(uids)[inv]
            ctx.save_for_backward(uids, inv)
        ctx.cfg = (mesh, rows_per_shard, lo, cap, average, sparse_repl)
        return out.reshape(tuple(ids.shape) + (D,))

    @staticmethod
    def backward(ctx, g):
        mesh, rows_per_shard, lo, cap, average, sparse_repl = ctx.cfg
        D = g.shape[-1]
        g_flat = g.reshape(-1, D)
        if cap is None:
            (ids_x,) = ctx.saved_tensors
            g_x, cnt_x = g_flat, None
        else:
            ids_x, inv = ctx.saved_tensors
            # stage 1: duplicates summed (and counted) before the wire
            g_x = g_flat.new_zeros((cap, D)).index_add_(0, inv, g_flat)
            cnt_x = (torch.zeros((cap,), dtype=torch.float32,
                                 device=g.device).index_add_(
                0, inv, torch.ones_like(inv, dtype=torch.float32))
                if average else None)
        whole = sparse_repl and mesh.repl > 1
        group = mesh.world if whole else mesh.shard_group
        g_all = collectives.all_gather(g_x, group)
        ids_all = collectives.all_gather(ids_x.int(), group).long()
        local = ids_all - lo
        valid = (local >= 0) & (local < rows_per_shard)
        safe = torch.where(valid, local, 0)
        contrib = g_all.new_zeros((rows_per_shard, D)).index_add_(
            0, safe, torch.where(valid[:, None], g_all, 0))
        if average:
            cnt = (valid.to(torch.float32) if cnt_x is None else
                   torch.where(valid, collectives.all_gather(cnt_x, group),
                               0.0))
            counts = torch.zeros((rows_per_shard,), dtype=torch.float32,
                                 device=g.device).index_add_(0, safe, cnt)
        if not whole:
            # merge the replica rows before dividing: the counter counts
            # every occurrence in the global batch
            collectives.all_reduce_(contrib, mesh.repl_group)
            if average:
                collectives.all_reduce_(counts, mesh.repl_group)
        if average:
            scale = torch.where(counts > 0,
                                1.0 / torch.clamp(counts, min=1.0), 0.0)
            contrib = contrib * scale[:, None].to(contrib.dtype)
        return contrib, None, None, None, None, None, None
