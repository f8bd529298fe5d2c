"""Step-time attribution: where did each training step's wall time go?

The registry's metrics say *how fast* the run is (steps/sec, dispatch gap);
this module says *why*. Each step's dispatch-to-dispatch wall time is
decomposed into the phases the session/engine actually measure on the
dispatch thread:

  * ``data_wait_ms``  — blocked waiting on the feed pipeline (the
    prefetcher queue in ``run_iter``, or the user iterator) — the
    "input stall" signal;
  * ``convert_ms``    — host feed conversion (``_convert_feed``) when it
    ran on the dispatch thread (prefetch-thread conversions overlap
    device compute and are *not* on the critical path);
  * ``h2d_ms``        — host→device placement on the dispatch thread
    (``Engine.place``); 0 for staged batches, whose copy to the card
    overlapped on the prefetch thread;
  * ``dispatch_ms``   — host time inside the engine's step call net of
    the H2D and fetch-block shares (argument checks, the static input
    copies, the graph replay's launch, and any device-queue
    backpressure);
  * ``fetch_block_ms`` — host time materializing fetched outputs
    (eager, or the lazy ``Fetch`` reads attributed back to their step);
  * ``device_est_ms`` — the residual: wall time in none of the host
    phases above. In a healthy async pipeline this is device-bound
    waiting (plus user code between steps); it is an *estimate* — under
    lazy fetches a step's fetch-block can land inside the next step's
    wall, shifting attribution by up to one step. A graph replay
    returns before the card finishes, so the device's time shows up
    here and in the fetch block, not in dispatch.

With the step's FLOPs (``ParallaxSession.step_flops``: the matmuls of
one step counted once per signature) and the card's published peak
(``common/flops.py``) attached via :meth:`set_flops`, each row also
carries per-step **MFU** and :meth:`goodput` returns the account the
flight recorder stamps: the fraction of wall time each phase consumed
over the rolling window.

The ring doubles as the flight recorder's step log (obs/flightrec.py):
the last ``capacity`` rows are always available for a post-mortem dump.
Per-step cost is one lock + one dict + one deque append (~1 µs); with
the obs layer disabled (``PARALLAX_OBS=0`` / ``obs.disable()``)
recording is a no-op.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional

from parallax_tpu_torch.obs import _state
from parallax_tpu_torch.obs.metrics import MetricsRegistry, summarize_window

# the attributed host phases, in presentation order
COMPONENTS = ("data_wait_ms", "convert_ms", "h2d_ms", "dispatch_ms",
              "fetch_block_ms")

DEFAULT_CAPACITY = 256


class StepTimeline:
    """Bounded ring of per-step attribution rows + registry gauges.

    The registry gets one ``timeline.<component>`` gauge per phase
    (sampled lazily at snapshot time — no per-step histogram cost) and
    ``timeline.mfu`` / ``timeline.steps`` alongside, so one
    ``registry.snapshot()`` carries the whole account.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 capacity: int = DEFAULT_CAPACITY):
        if int(capacity) < 1:
            raise ValueError(f"timeline capacity must be >= 1, got "
                             f"{capacity}")
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._lock = threading.Lock()
        self._capacity = int(capacity)
        self._rows: collections.deque = collections.deque()
        self._by_step: Dict[int, dict] = {}
        self._total = 0
        self._flops_per_step: Optional[float] = None
        self._peak_flops_total: Optional[float] = None
        # memoized completed-row view: a registry snapshot samples ~9
        # timeline gauges, and each would otherwise copy + annotate
        # the whole ring; the cache invalidates on any mutation
        self._version = 0
        self._view_version = -1
        self._view: List[dict] = []
        for comp in COMPONENTS + ("wall_ms", "device_est_ms"):
            self.registry.gauge("timeline." + comp).set_fn(
                self._column_summary_fn(comp))
        self.registry.gauge("timeline.steps").set_fn(lambda: self._total)
        self.registry.gauge("timeline.mfu").set_fn(self._mfu_mean)

    # -- producer (dispatch thread) ---------------------------------------

    def record_step(self, step: int, ts: float, wall_s: float,
                    data_wait_s: float = 0.0, convert_s: float = 0.0,
                    h2d_s: float = 0.0, dispatch_s: float = 0.0,
                    fetch_block_s: float = 0.0,
                    h2d_pre_s: float = 0.0) -> Optional[dict]:
        """Append one step's attribution row (seconds in, ms stored).

        ``dispatch_s`` is the RAW host time inside the step call; the
        ``h2d_s`` and ``fetch_block_s`` shares measured INSIDE it are
        subtracted here so the stored components are disjoint.
        ``h2d_pre_s`` is placement paid on this thread BEFORE the step
        call (the place-batch-then-step pattern) — part of the step's
        H2D total, never subtracted from dispatch."""
        if not _state.enabled:
            return None
        row = {
            "step": int(step),
            "ts": ts,
            "wall_ms": wall_s * 1e3,
            "data_wait_ms": data_wait_s * 1e3,
            "convert_ms": convert_s * 1e3,
            "h2d_ms": (h2d_s + h2d_pre_s) * 1e3,
            "dispatch_ms": max(0.0, dispatch_s - h2d_s
                               - fetch_block_s) * 1e3,
            "fetch_block_ms": fetch_block_s * 1e3,
        }
        with self._lock:
            self._rows.append(row)
            self._by_step[row["step"]] = row
            self._total += 1
            self._version += 1
            if len(self._rows) > self._capacity:
                old = self._rows.popleft()
                # only drop the index entry if it still points at the
                # evicted row (a re-run step id must not orphan the
                # newer row)
                if self._by_step.get(old["step"]) is old:
                    del self._by_step[old["step"]]
        return row

    def add_fetch_block(self, step: int, seconds: float) -> None:
        """Attribute a lazy ``Fetch`` materialization back to the step
        that produced the value (no-op if that row already fell off
        the ring)."""
        if not _state.enabled:
            return
        with self._lock:
            row = self._by_step.get(int(step))
            if row is not None:
                row["fetch_block_ms"] += seconds * 1e3
                self._version += 1

    # -- FLOPs / MFU -------------------------------------------------------

    def set_flops(self, flops_per_step: Optional[float],
                  peak_flops_total: Optional[float]) -> None:
        """Attach the compiled step's cost-analysis FLOPs and the
        mesh-total peak FLOP/s; per-step ``mfu`` appears in rows and
        summaries once both are known. Never fabricates: either side
        None keeps MFU null."""
        with self._lock:
            self._flops_per_step = (float(flops_per_step)
                                    if flops_per_step else None)
            self._peak_flops_total = (float(peak_flops_total)
                                      if peak_flops_total else None)
            self._version += 1  # row mfu values depend on these

    def _row_mfu(self, row: dict) -> Optional[float]:
        f, p = self._flops_per_step, self._peak_flops_total
        if not f or not p or row["wall_ms"] <= 0:
            return None
        return f / (row["wall_ms"] * 1e-3) / p

    def _mfu_mean(self) -> Optional[float]:
        vals = [r["mfu"] for r in self.rows() if r["mfu"] is not None]
        if not vals:
            return None
        return round(sum(vals) / len(vals), 4)

    # -- consumers ---------------------------------------------------------

    @property
    def total_rows(self) -> int:
        """Lifetime rows recorded (the per-step timeline cost is
        priced from this)."""
        with self._lock:
            return self._total

    def rows(self, last: Optional[int] = None) -> List[dict]:
        """Copies of the most recent ``last`` rows (all by default),
        oldest first, each completed with ``device_est_ms`` and
        ``mfu``. The full view is memoized per mutation, so the ~9
        gauges sampled by one registry snapshot share one ring pass."""
        with self._lock:
            if self._view_version != self._version:
                out = []
                for r in self._rows:
                    r = dict(r)
                    attributed = sum(r[c] for c in COMPONENTS)
                    r["device_est_ms"] = max(0.0,
                                             r["wall_ms"] - attributed)
                    r["mfu"] = self._row_mfu(r)
                    out.append(r)
                self._view = out
                self._view_version = self._version
            view = self._view
        return view[-last:] if last else list(view)

    def _column_summary_fn(self, comp: str):
        def sample() -> Optional[Dict[str, float]]:
            rows = self.rows()
            if not rows:
                return None
            return summarize_window(sorted(r[comp] for r in rows),
                                    self._total)
        return sample

    def local_stats(self) -> Dict[str, float]:
        """{mean_ms, p95_ms, steps} of the window's wall times — the
        per-host row the straggler aggregation gathers
        (obs/aggregate.py)."""
        rows = self.rows()
        walls = sorted(r["wall_ms"] for r in rows)
        if not walls:
            return {"mean_ms": 0.0, "p95_ms": 0.0, "steps": 0}
        s = summarize_window(walls, len(walls))
        return {"mean_ms": s["mean"], "p95_ms": s["p95"],
                "steps": len(walls)}

    def goodput(self) -> Dict:
        """The goodput account over the rolling window: per-phase
        mean milliseconds and fraction of mean wall time, plus MFU.
        JSON-ready (flight dumps). Thin delegate: the math
        lives in obs/goodput.py (:func:`~parallax_tpu_torch.obs.goodput.
        step_goodput`), the single owner of goodput arithmetic, so the
        per-step window and the run-lifetime ledger can never
        disagree; the keys here keep their historical meaning."""
        from parallax_tpu_torch.obs.goodput import step_goodput
        return step_goodput(self)
