"""Embedding partition-count auto-search (``parallax_tpu/parallel/
partitions.py``).

The reference's ``PartitionStatCollector`` + ``get_partitioner``
(reference: common/partitions.py:35-170), with its outer loop and its
cost model, on the ranks' mesh:

  * the tunable is the size of the ``'shard'`` axis (how many ranks a
    row-sharded table is split over);
  * candidates double from ``min_partitions`` while the step time
    improves (partitions.py:74-138), snapped to divisors of the rank
    count;
  * the final pick fits  t(p) = b/p + a·(p-1) + c  by least squares and
    takes the argmin (partitions.py:140-170);
  * trying the next candidate is an in-place replan of the session (a
    new engine from its cache and the state resharded), not the
    reference's relaunch of the cluster.

``get_partitioner`` keeps the reference's environment override
(PARALLAX_PARTITIONS / PARALLAX_MIN_PARTITIONS, partitions.py:29-51).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from parallax_tpu_torch.common import consts
from parallax_tpu_torch.common.lib import parallax_log


def get_partitioner(min_partitions: Optional[int] = None) -> int:
    """The embedding partition count a model should build with: the
    PARALLAX_PARTITIONS override (set by a search) wins, then
    ``min_partitions``, then every rank of the process group (one without
    a group). Models pad their vocabulary to it (``ops.embedding.
    pad_vocab``), so the tables split evenly for any divisor of the rank
    count."""
    env = os.environ.get(consts.PARALLAX_PARTITIONS)
    if env:
        return int(env)
    if min_partitions:
        return int(min_partitions)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


class PartitionSearch:
    """Doubling search + curve-fit chooser over shard-axis sizes."""

    def __init__(self, min_partitions: int, num_devices: int):
        self.num_devices = num_devices
        self._divs = divisors(num_devices)
        self.min_p = self._snap(max(1, min_partitions))
        self.results: List[Tuple[int, float]] = []
        self._best: Optional[int] = None

    def _snap(self, p: int) -> int:
        return max(d for d in self._divs if d <= max(p, 1))

    def first_candidate(self) -> int:
        return self.min_p

    def report(self, p: int, mean_step_time: float) -> Optional[int]:
        """Record a timing; return the next candidate or None when done."""
        self.results.append((p, mean_step_time))
        parallax_log.info("partition search: p=%d mean step %.4fs", p,
                          mean_step_time)
        if len(self.results) >= 2 and (self.results[-1][1]
                                       > self.results[-2][1]):
            self._fit()
            return None
        nxt = self._snap(p * 2)
        if nxt <= p:  # no larger divisor: the space is exhausted
            self._fit()
            return None
        return nxt

    def _fit(self) -> None:
        pts = sorted(set(self.results))
        if len(pts) < 3:
            self._best = min(self.results, key=lambda r: r[1])[0]
            return
        ps = np.array([p for p, _ in pts], dtype=np.float64)
        ts = np.array([t for _, t in pts], dtype=np.float64)
        basis = np.stack([1.0 / ps, ps - 1.0, np.ones_like(ps)], axis=1)
        coef, *_ = np.linalg.lstsq(basis, ts, rcond=None)
        lo, hi = int(ps.min()), self.num_devices
        cands = [d for d in self._divs if lo <= d <= hi]
        pred = [coef[0] / d + coef[1] * (d - 1) + coef[2] for d in cands]
        self._best = cands[int(np.argmin(pred))]

    def tried_partitions(self) -> List[int]:
        """Distinct candidate sizes measured so far; the session keeps
        one built engine for each in its engine cache, so settling on
        any of them (the winner included) reuses its captured step."""
        return sorted({p for p, _ in self.results})

    def best_partitions(self) -> int:
        if self._best is None:
            self._fit()
        return self._best

    @property
    def done(self) -> bool:
        return self._best is not None


__all__ = ["PartitionSearch", "divisors", "get_partitioner"]
