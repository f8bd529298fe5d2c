"""Scatter-only optimizer updates from gradient slices, and the
row-sparse Adagrad of dense table gradients
(``parallax_tpu.ops.sparse_optim``: ``SliceAdagrad``, ``SliceAdam``,
``_combine_slices``, ``row_sparse_adagrad``,
``collect_overflow_steps``).

The reference applies sparse gradients with scatter-only kernels
(``SparseApplyAdagrad``, reference graph_transform_lib.py:71-77): only
the rows a step touched are read and written, so a 793k-row table does
not pay a full [V, D] optimizer pass per step. The engine's "slices"
mode hands the updater ``(ids, per-occurrence row gradients)`` pairs —
TF's IndexedSlices — and the updater applies them here, in place on
the table and its accumulator (the JAX package returns new arrays; the
port updates in place so a step allocates nothing table-sized).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from parallax_tpu_torch.core import optim
from parallax_tpu_torch.ops import collectives


@dataclasses.dataclass(frozen=True)
class SliceAdagrad:
    """Adagrad over gradient slices: ``param[r] -= lr * G_r /
    sqrt(acc_r + eps)`` where ``G_r`` is the per-occurrence row gradients
    summed per row (or averaged by occurrence count with
    ``average=True``). Matches ``optax.adagrad`` on the rows that were
    touched; untouched rows are never read or written.

    ``grad_scale`` multiplies the incoming slices before the update (the
    reference LM1B scales its embedding IndexedSlices by batch size,
    language_model_graph.py:48-50)."""

    learning_rate: float
    initial_accumulator_value: float = 0.1
    eps: float = 1e-7
    grad_scale: float = 1.0

    def init(self, param: torch.Tensor) -> torch.Tensor:
        # fp32 accumulator even for bf16 tables: the sum of squares adds
        # tiny g^2 increments that bf16's 8 mantissa bits would drop
        return torch.full(param.shape, self.initial_accumulator_value,
                          dtype=torch.float32, device=param.device)

    @torch.no_grad()
    def update(self, param: torch.Tensor, acc: torch.Tensor,
               ids: torch.Tensor, drows: torch.Tensor,
               average: bool = False) -> None:
        """Apply slices (ids [N], drows [N, D]) to (param, acc) [V, D] in
        place. Duplicate ids are combined BEFORE squaring into the
        accumulator, as the dense scatter-add gradient would be; ids
        outside [0, V) are dropped.

        ``combine_slices`` returns N slots whatever the ids, the unused
        ones holding the sentinel V (the JAX ``mode="drop"`` rows). A
        sentinel slot is pointed at the first slot's row and writes the
        very value that slot writes (with no valid id at all, row V-1's
        own value back), so every row gets one value however the writes
        are ordered, and no row a valid id did not name changes."""
        V = param.shape[0]
        uids, gsum = combine_slices(ids, drows, V, average,
                                    self.grad_scale)
        if uids.numel() == 0:
            return
        tgt, valid, gsum = _targets(uids, gsum, V)
        acc_rows = acc.index_select(0, tgt) + gsum * gsum
        inv_rt = torch.where(acc_rows > 0,
                             torch.rsqrt(acc_rows + self.eps), 0.0)
        u_rows = (inv_rt * gsum) * -self.learning_rate
        p_rows = param.index_select(0, tgt) + u_rows.to(param.dtype)
        _write_rows(acc, tgt, valid, acc_rows)
        _write_rows(param, tgt, valid, p_rows)


def _targets(uids: torch.Tensor, gsum: torch.Tensor, V: int):
    """The rows ``combine_slices``' slots write: a sentinel slot (id V)
    is pointed at the first slot's row (row V-1 when no slot is valid),
    and its gradient zeroed."""
    valid = (uids < V)[:, None]
    tgt = torch.where(uids < V, uids, uids[:1].clamp(max=V - 1))
    return tgt, valid, torch.where(valid, gsum, 0.0)


def _write_rows(dst: torch.Tensor, tgt, valid, rows) -> None:
    """``dst[tgt] = rows`` where a sentinel slot writes the very value
    the first slot writes (or, with no valid slot, the row's own value
    back), so every row gets one value however the writes are ordered
    and no row a valid id did not name changes."""
    first = torch.where(valid[:1], rows[:1], dst.index_select(0, tgt[:1]))
    dst.index_copy_(0, tgt, torch.where(valid, rows, first))


class SliceAdamState(NamedTuple):
    m: torch.Tensor        # first moment, touched rows only
    v: torch.Tensor        # second moment, touched rows only
    count: torch.Tensor    # global step counter (bias correction), int32


@dataclasses.dataclass(frozen=True)
class SliceAdam:
    """Lazy Adam over gradient slices, TF ``LazyAdamOptimizer``
    semantics (reference sparse_optim.py:231-284): the moments of the
    touched rows alone are updated (untouched rows do not decay), and
    the bias correction uses the global step count. Moments are fp32,
    updated in place; the count lives on the device."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_scale: float = 1.0

    def init(self, param: torch.Tensor) -> SliceAdamState:
        z = torch.zeros(param.shape, dtype=torch.float32,
                        device=param.device)
        return SliceAdamState(z, z.clone(), torch.zeros(
            (), dtype=torch.int32, device=param.device))

    @torch.no_grad()
    def update(self, param: torch.Tensor, state: SliceAdamState,
               ids: torch.Tensor, drows: torch.Tensor,
               average: bool = False) -> None:
        V = param.shape[0]
        uids, gsum = combine_slices(ids, drows, V, average,
                                    self.grad_scale)
        state.count.add_(1)
        if uids.numel() == 0:
            return
        tgt, valid, gsum = _targets(uids, gsum, V)
        m_r = (self.b1 * state.m.index_select(0, tgt)
               + (1.0 - self.b1) * gsum)
        v_r = (self.b2 * state.v.index_select(0, tgt)
               + (1.0 - self.b2) * gsum * gsum)
        t = state.count.to(torch.float32)
        m_hat = m_r / (1.0 - torch.pow(torch.tensor(
            self.b1, dtype=torch.float32, device=t.device), t))
        v_hat = v_r / (1.0 - torch.pow(torch.tensor(
            self.b2, dtype=torch.float32, device=t.device), t))
        u_rows = -self.learning_rate * m_hat / (torch.sqrt(v_hat)
                                                + self.eps)
        p_rows = param.index_select(0, tgt) + u_rows.to(param.dtype)
        _write_rows(state.m, tgt, valid, m_r)
        _write_rows(state.v, tgt, valid, v_r)
        _write_rows(param, tgt, valid, p_rows)


def combine_slices(ids: torch.Tensor, drows: torch.Tensor, V: int,
                   average: bool = False, grad_scale: float = 1.0):
    """Flatten, scale, move ids outside [0, V) onto the sentinel V, then
    sum (or, with ``average``, take the occurrence mean of) the rows of
    each distinct id: the JAX ``_combine_slices``, with its static size.
    Returns (uids [N] int64, gsum [N, D] fp32) for the N = ``ids.numel()``
    slots: the distinct ids ascending (V, if any id was dropped, last
    among them, with the dropped rows' sum), then slots of the sentinel V
    with zero rows. Sort-based and of fixed shape, so it never waits for
    the card and can be captured in a CUDA graph (``torch.unique`` does
    both)."""
    ids = ids.reshape(-1).long()
    cap = ids.shape[0]
    drows = drows.reshape(cap, drows.shape[-1]).float()
    if grad_scale != 1.0:
        drows = drows * grad_scale
    ids = torch.where((ids >= 0) & (ids < V), ids, V)
    # stable: each slot sums its rows in their order, as a sequential
    # scatter-add does
    sorted_ids, perm = torch.sort(ids, stable=True)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(first, 0) - 1               # slot of each sorted id
    # duplicates write the same id into their slot
    uids = torch.full_like(ids, V).scatter_(0, seg, sorted_ids)
    counts = torch.zeros_like(seg).scatter_add_(0, seg,
                                                torch.ones_like(seg))
    # one sequential sum a slot (0 for the unused ones): deterministic on
    # the card as well, where a scatter-add's atomics are not
    gsum = torch.segment_reduce(drows[perm], "sum", lengths=counts, axis=0,
                                unsafe=True)
    if average:
        cnt = counts.to(torch.float32)
        gsum = gsum * torch.where(cnt > 0, 1.0 / cnt.clamp_min(1.0),
                                  0.0)[:, None]
    return uids, gsum


class RowSparseAdagradState(NamedTuple):
    sum_of_squares: dict
    # per leaf: the steps that touched more rows than max_touched_rows
    # (those steps skipped their lowest-activity rows), int32 on the device
    overflow_steps: dict


def row_sparse_adagrad(learning_rate: float, max_touched_rows: int,
                       eps: float = 1e-7,
                       initial_accumulator_value: float = 0.1
                       ) -> optim.GradientTransformation:
    """Adagrad that updates only the ``max_touched_rows`` most active
    rows of each [rows, dim] gradient (reference sparse_optim.py:40-118):
    ``optax.adagrad``'s trajectory whenever the bound holds (an
    untouched row's Adagrad update is zero). A step that touches more
    rows than the bound skips its lowest-activity rows and counts one
    ``overflow_steps``.

    On a row shard (the engine's ``optim.sharded_scope``) the activity
    of every row is gathered over 'shard', so the chosen rows and the
    overflow count are those of the whole table. The update is the
    masked dense form of the reference's scatter, with its arithmetic."""
    lr, K, init = learning_rate, int(max_touched_rows), \
        initial_accumulator_value

    def init_fn(params):
        return RowSparseAdagradState(
            {k: torch.full_like(p, init) for k, p in params.items()},
            {k: torch.zeros((), dtype=torch.int32, device=p.device)
             for k, p in params.items()})

    def update_fn(updates, state, params=None):
        out = {}
        for key, g in updates.items():
            if g.ndim != 2:
                raise ValueError(
                    f"row_sparse_adagrad expects [rows, dim] params, got "
                    f"shape {tuple(g.shape)} for {key}; use adagrad for "
                    f"non-tables")
            mesh = optim.shard_mesh(key)
            rows_here = g.shape[0]
            p = mesh.shard if mesh is not None else 1
            V = rows_here * p
            k = min(K, V)
            row_act = g.abs().sum(dim=1)
            if mesh is not None:
                row_act = collectives.all_gather(row_act, mesh.shard_group)
            acc = state.sum_of_squares[key]
            if k < V:
                n_touched = (row_act > 0).sum().to(torch.int32)
                state.overflow_steps[key].add_(
                    (n_touched > k).to(torch.int32))
            _, idx = torch.topk(row_act, k)
            lo = mesh.coords[1] * rows_here if mesh is not None else 0
            local = idx - lo
            ok = (local >= 0) & (local < rows_here)
            sel = torch.zeros((rows_here + 1,), dtype=torch.bool,
                              device=g.device).index_fill_(
                0, torch.where(ok, local, rows_here), True)[:rows_here]
            sel = sel[:, None]
            acc_rows = torch.where(sel, acc + g * g, acc)
            inv = torch.where(acc_rows > 0, torch.rsqrt(acc_rows + eps),
                              0.0)
            out[key] = torch.where(sel, (inv * g) * -lr, 0.0)
            acc.copy_(acc_rows)
        return out, state

    return optim.GradientTransformation(init_fn, update_fn)


def collect_overflow_steps(opt_state) -> int:
    """The ``row_sparse_adagrad`` overflow events in an optimizer state,
    summed over every ``RowSparseAdagradState`` in it (reference
    sparse_optim.py:177-207): nonzero means some steps touched more rows
    than ``max_touched_rows`` and skipped some; raise the bound."""
    total = 0

    def visit(node):
        nonlocal total
        if isinstance(node, RowSparseAdagradState):
            total += sum(int(v) for v in node.overflow_steps.values())
        elif isinstance(node, dict):
            for c in node.values():
                visit(c)
        elif isinstance(node, (list, tuple)):
            for c in node:
                visit(c)

    visit(opt_state)
    return total
