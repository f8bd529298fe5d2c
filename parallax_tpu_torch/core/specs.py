"""Per-variable specs: the `GradientsInfo` replacement (a copy of
``parallax_tpu/core/specs.py``).

The reference fork records (variable, gradient) pairs plus a
TENSOR/INDEXED_SLICES tag into the MetaGraphDef (`GradientsInfoDef`,
reference runner.py:40-60) so the master can route each variable to the
AllReduce or the PS path.  Here the same decision is a `VariableSpec` per
parameter leaf, derived from one recorded forward (see classify.py) with
user override, and the "routing" is a placement choice (see
core/engine.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

DENSE = "dense"
SPARSE = "sparse"


@dataclasses.dataclass(frozen=True)
class VariableSpec:
    """Classification + shape record for one parameter leaf.

    ``kind``: DENSE -> replicated storage, gradient all-reduced
    (reference: hvd.allreduce, mpi/graph_transform.py:35-61).
    SPARSE -> row-sharded storage over the 'shard' mesh axis, gradient
    exchanged as row updates (reference: SparseConditionalAccumulator on PS,
    graph_transform_lib.py:1041-1211). On one card both keep the whole
    tensor; the class still picks the update path.

    ``reason`` records why the classifier chose the kind, for logging parity
    with the reference's transform logs.
    """

    path: str
    shape: Tuple[int, ...]
    dtype: Any
    kind: str = DENSE
    reason: str = ""

    @property
    def is_sparse(self) -> bool:
        return self.kind == SPARSE


def summarize(specs: Dict[str, VariableSpec]) -> str:
    n_sparse = sum(1 for s in specs.values() if s.is_sparse)
    return (f"{len(specs)} variables: {len(specs) - n_sparse} dense, "
            f"{n_sparse} sparse "
            f"({[p for p, s in specs.items() if s.is_sparse]})")
