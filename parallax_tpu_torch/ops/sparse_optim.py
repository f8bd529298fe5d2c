"""Scatter-only optimizer updates from gradient slices
(``parallax_tpu.ops.sparse_optim``: ``SliceAdagrad`` and
``_combine_slices``).

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

import torch


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
        valid = (uids < V)[:, None]
        gsum = torch.where(valid, gsum, 0.0)
        tgt = torch.where(uids < V, uids, uids[:1].clamp(max=V - 1))
        acc_rows = acc.index_select(0, tgt) + gsum * gsum
        inv_rt = torch.where(acc_rows > 0,
                             torch.rsqrt(acc_rows + self.eps), 0.0)
        u_rows = (inv_rt * gsum) * -self.learning_rate
        p_rows = param.index_select(0, tgt) + u_rows.to(param.dtype)
        acc.index_copy_(0, tgt, torch.where(valid, acc_rows, acc_rows[:1]))
        param.index_copy_(0, tgt, torch.where(valid, p_rows, p_rows[:1]))


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
