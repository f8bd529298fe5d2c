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
        outside [0, V) are dropped."""
        uids, gsum = combine_slices(ids, drows, param.shape[0], average,
                                    self.grad_scale)
        acc_rows = acc.index_select(0, uids) + gsum * gsum
        inv_rt = torch.where(acc_rows > 0,
                             torch.rsqrt(acc_rows + self.eps),
                             torch.zeros_like(acc_rows))
        u_rows = (inv_rt * gsum) * -self.learning_rate
        acc.index_copy_(0, uids, acc_rows)
        param.index_add_(0, uids, u_rows.to(param.dtype))


def combine_slices(ids: torch.Tensor, drows: torch.Tensor, V: int,
                   average: bool = False, grad_scale: float = 1.0):
    """Flatten, scale, drop ids outside [0, V), then sum (or, with
    ``average``, take the occurrence mean of) the rows of each distinct
    id. Returns (uids [U] int64, gsum [U, D] fp32), uids sorted."""
    ids = ids.reshape(-1).long()
    drows = drows.reshape(ids.shape[0], -1).float()
    if grad_scale != 1.0:
        drows = drows * grad_scale
    ids = torch.where((ids >= 0) & (ids < V), ids, torch.full_like(ids, V))
    uids, inv = torch.unique(ids, return_inverse=True)
    gsum = torch.zeros((uids.shape[0], drows.shape[1]), dtype=drows.dtype,
                       device=drows.device).index_add_(0, inv, drows)
    if average:
        cnt = torch.zeros((uids.shape[0],), dtype=torch.float32,
                          device=drows.device).index_add_(
                              0, inv, torch.ones_like(inv,
                                                      dtype=torch.float32))
        gsum = gsum / cnt.clamp_min(1.0)[:, None]
    keep = uids < V          # the sentinel V collects the dropped ids
    return uids[keep], gsum[keep]
