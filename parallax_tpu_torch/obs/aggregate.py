"""Cross-process aggregation: name the slow host, don't infer it.

Per-process metrics cannot see a straggler — every host's own numbers
look locally plausible while one of them drags the whole synchronous
step. The fix is attribution: gather
each host's step-time statistics in one place and *name* the outlier.

``aggregate_host_step_times`` is a **collective**: every process calls
it with its local timeline stats (``StepTimeline.local_stats()``) and
every process receives the full per-host table plus the straggler
verdict, over the default ``torch.distributed`` process group
(``all_gather_object``: gloo or NCCL, whichever the run initialised —
no extra socket protocol). A process without a group reports only
itself.

The signal compared is the *host-side* dispatch wall time. Under the
async pipeline each host dispatches as fast as its own host work
allows (the device-side collective barrier does not back-propagate
into dispatch until the queue fills), so a host stalled on input,
page cache, or a sick daemon shows a higher dispatch wall than its
peers — exactly the class of straggler per-process metrics miss.

``find_stragglers`` (pure, unit-testable) flags hosts whose mean
exceeds ``factor`` × the across-host median.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def find_stragglers(means: Sequence[float],
                    factor: float = 1.25) -> List[int]:
    """Indices of hosts whose mean step time exceeds ``factor`` × the
    median of all hosts' means (empty when nothing lags)."""
    arr = np.asarray(list(means), dtype=np.float64)
    if arr.size < 2:
        return []
    med = float(np.median(arr))
    if med <= 0:
        return []
    return [int(i) for i in np.nonzero(arr > factor * med)[0]]


def build_report(rows: np.ndarray, factor: float = 1.25) -> Dict:
    """The aggregated report from a [num_hosts, 3] array of
    (mean_ms, p95_ms, steps) per host. Pure — the collective and the
    unit tests share this exact code path."""
    rows = np.asarray(rows, dtype=np.float64).reshape(-1, 3)
    means = rows[:, 0]
    stragglers = find_stragglers(means, factor)
    med = float(np.median(means)) if rows.size else 0.0
    return {
        "num_hosts": int(rows.shape[0]),
        "factor": float(factor),
        "median_mean_ms": round(med, 4),
        "hosts": [
            {"process_index": i,
             "mean_ms": round(float(m), 4),
             "p95_ms": round(float(p), 4),
             "steps": int(n),
             "vs_median": (round(float(m) / med, 4) if med > 0
                           else None),
             "straggler": i in stragglers}
            for i, (m, p, n) in enumerate(rows)],
        "stragglers": stragglers,
        "slowest": (int(np.argmax(means)) if rows.size else None),
    }


def aggregate_host_step_times(local_stats: Dict[str, float],
                              factor: float = 1.25) -> Dict:
    """COLLECTIVE: gather every process's (mean, p95, steps) and return
    the named-straggler report on all of them. All processes of the
    default process group must call it (it is an all-gather); a process
    without a group (or a group of one) skips the collective."""
    row = np.asarray([float(local_stats.get("mean_ms", 0.0)),
                      float(local_stats.get("p95_ms", 0.0)),
                      float(local_stats.get("steps", 0))],
                     dtype=np.float64)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, row.tolist())
        rows = np.asarray(gathered, dtype=np.float64)
    else:
        rows = row[None, :]
    return build_report(rows, factor)


def straggler_summary(report: Dict) -> Optional[str]:
    """One human line naming the lagging host(s), or None when clean."""
    if not report.get("stragglers"):
        return None
    parts = []
    for i in report["stragglers"]:
        h = report["hosts"][i]
        parts.append(f"process {i} at {h['mean_ms']:.1f}ms/step "
                     f"({h['vs_median']:.2f}x the median)")
    return "straggler host(s): " + "; ".join(parts)
