"""Wire bytes of the sparse path and of its dense alternative (copies of
``parallax_tpu/tune/costmodel.py``'s ``lookup_wire_bytes`` and
``dense_alternative_bytes``, :299 and :314): one source of truth for
``Engine.sparse_wire_bytes_per_step`` and the BASELINE metric
"sparse-grad bytes on wire"; and the pipeline schedules' bubble and
inter-stage bytes (``pipeline_bubble`` and ``pipeline_wire_bytes``,
:340-395), the one owner of their tick math, priced on the rounded
microbatch count that ``ops/pipeline.py`` runs."""

from __future__ import annotations

from typing import Dict, Sequence

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


def pipeline_bubble(microbatches: int, stages: int,
                    virtual_stages: int = 1) -> Dict[str, float]:
    """Bubble accounting of ``ops/pipeline.py``'s schedules. The
    interleaved schedule rounds M up to whole rounds of S
    (``ops.pipeline._rounded_microbatches``), and the padding runs masked
    bubble entries, so the rounded M is priced. Ticks = V*M_sched + S - 1,
    ideal = V*M:

        bubble_fraction = (S - 1) / (V*M_sched + S - 1)
        on_chip_scale   = (V*M_sched + S - 1) / (V*M)"""
    from parallax_tpu_torch.ops.pipeline import _rounded_microbatches
    M, S, V = int(microbatches), int(stages), int(virtual_stages)
    if M < 1 or S < 1 or V < 1:
        raise ValueError(
            f"pipeline_bubble needs M, S, V >= 1; got M={M} S={S} "
            f"V={V}")
    m_sched = _rounded_microbatches(M, S, V)
    ticks = V * m_sched + S - 1
    return {
        "bubble_fraction": (S - 1) / ticks,
        "on_chip_scale": ticks / (V * M),
        "microbatches_scheduled": m_sched,
        "ticks": ticks,
    }


def pipeline_wire_bytes(act_bytes: float, microbatches: int,
                        stages: int, virtual_stages: int = 1,
                        schedule: str = "gpipe", dp: int = 1,
                        tp: int = 1) -> Dict[str, float]:
    """Inter-stage bytes. ``act_bytes`` is the global batch's activation
    at one stage boundary; one hop carries one microbatch of one repl
    row, ``per_hop_bytes = act_bytes / (M * dp)``. Every rank hops every
    tick (a masked tick sends zeros), so the mesh's activation bytes are
    ``per_hop * dp * tp * S * ticks``; under 1F1B the cotangents double
    them."""
    M = int(microbatches)
    bub = pipeline_bubble(M, stages, virtual_stages)
    per_hop = float(act_bytes) / (M * max(int(dp), 1))
    sends_per_tick = max(int(dp), 1) * max(int(tp), 1) * int(stages)
    activation = per_hop * sends_per_tick * bub["ticks"]
    cotangent = activation if str(schedule) == "1f1b" else 0.0
    return {
        "per_hop_bytes": per_hop,
        "ticks": bub["ticks"],
        "bubble_fraction": bub["bubble_fraction"],
        "microbatches_scheduled": bub["microbatches_scheduled"],
        "activation_bytes": activation,
        "cotangent_bytes": cotangent,
        "total_bytes": activation + cotangent,
    }
