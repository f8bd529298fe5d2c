"""Wire bytes of the sparse path and of its dense alternative (copies of
``parallax_tpu/tune/costmodel.py``'s ``lookup_wire_bytes`` and
``dense_alternative_bytes``, :299 and :314): one source of truth for
``Engine.sparse_wire_bytes_per_step`` and the BASELINE metric
"sparse-grad bytes on wire"."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def lookup_wire_bytes(table_shape: Sequence[int], n_ids: int,
                      n_cnt: int, repl_bytes: int,
                      elem_bytes: int) -> int:
    """Per-step wire bytes of one sharded lookup: the forward's id
    all-gather (4-byte ids, as the reference counts them) and row
    reduce-scatter, the backward's row-gradient all-gather in the
    table's dtype, the optional occurrence-count plane, and the recorded
    cross-replica combine bytes."""
    dim = int(np.prod(table_shape[1:])) if len(table_shape) > 1 else 1
    return int(n_ids * 4 + 2 * n_ids * dim * elem_bytes + n_cnt * 4
               + repl_bytes)


def dense_alternative_bytes(table_shape: Sequence[int],
                            elem_bytes: int) -> int:
    """Wire bytes of ring-all-reducing one table's whole [V, D] gradient
    (about 2 bytes moved per gradient byte)."""
    return int(2 * int(np.prod(table_shape)) * elem_bytes)
