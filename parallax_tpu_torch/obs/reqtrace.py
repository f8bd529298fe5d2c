"""Request-scoped tracing: one serving request's wall time, decomposed.

Continuous batching makes request latency attribution structurally
hard — queue wait, prefill, page-pool slot waits, batched decode steps
and fleet failover hops all interleave on shared threads — so the
attribution is carried BY the request.

* :class:`RequestRecord` — one request's lifecycle as a phase state
  machine. The record opens in ``admission`` and every ``mark(phase)``
  closes the current phase into an accumulated per-phase total (and a
  bounded segment list for the chrome lanes). Because phases partition
  the record's wall clock by construction, the TTFT decomposition
  snapshotted at :meth:`first_token` sums EXACTLY to the client-side
  TTFT. The record travels with the request across fleet failover hops
  (one record, many replica sub-requests), so a retried request's
  decomposition covers its whole client-visible window: the aborted
  hop's work plus the ``failover`` gap plus the winning hop.

  Phases: ``admission`` (submit-side validation/padding),
  ``queue_wait`` (enqueue -> popped by the scheduler), ``prefill``
  (pop -> slot activation; per-chunk durations in
  ``prefill_chunks_ms``), ``kv_transfer`` (disaggregated serving's
  inter-pool hop: prefill state exported, moved as wire bytes and
  imported into the decode replicas), ``prefix_replay`` (the
  prefix-cache hit's substitute for prefill: cached tokens and pages
  mapped instead of computed), ``slot_wait`` (page-pool-exhausted
  refill deferrals), ``decode`` (activation -> retire), ``service``
  (the one-shot batcher's dispatch, device step and split),
  ``failover`` (replica death -> re-placement). Alongside: the replica
  hop trail, retries consumed, KV pages held, decode-step count, token
  count, and the prefix-reuse pair
  ``prefix_hit_pages`` / ``prefill_tokens_skipped`` (cached KV pages
  this request did not write / prompt tokens whose prefill it
  skipped).

* :class:`RequestTraceRing` — a bounded ring of completed records,
  exported at ~zero per-request cost (collection is a deque append;
  ALL summarization is lazy):

  - ``serve.timeline.*`` registry gauges (per-phase window summaries,
    TTFT/total, decode steps, KV pages, hops) sampled only at
    ``registry.snapshot()`` time;
  - ``serve.slo.*`` gauges computed from the records (deadline-miss
    rate and budget consumed, worst p99-vs-deadline margin, shed rate);
  - chrome://tracing lanes KEYED BY REQUEST ID
    (:meth:`RequestTraceRing.export_chrome_trace`): one viewer row per
    request, its phase segments laid end to end.

With the obs layer disabled (``PARALLAX_OBS=0`` / ``obs.disable()``)
no records are created at all (the serving paths guard on a None
``request.rec``).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from parallax_tpu_torch.obs import _state
from parallax_tpu_torch.obs.metrics import (MetricsRegistry, nearest_rank,
                                            summarize_window)

# the attributed request phases, in lifecycle order (bare names; the
# registry gauges and ttft_decomp keys carry the _ms suffix).
# ``prefix_replay`` is the prefix-cache hit's substitute for ``prefill``:
# the window between pop and activation when cached tokens and pages
# were mapped instead of computed — near zero by design, and its explicit
# presence in the TTFT decomposition (next to the record's
# ``prefill_tokens_skipped``) attributes the skipped prefill.
# ``kv_transfer`` is the disaggregated hop between pools: prefill
# finished on a prefill replica -> request state exported, moved as wire
# bytes and imported into the decode replicas' prefix caches. It sits
# between ``prefill`` and the decode pool's ``queue_wait``, so a
# disaggregated request's phases still partition its wall clock.
PHASES = ("admission", "queue_wait", "prefill", "kv_transfer",
          "prefix_replay", "slot_wait", "decode", "service", "failover")

DEFAULT_CAPACITY = 512

# terminal outcomes that count as a deadline miss for the SLO gauges
_MISS_OUTCOMES = ("deadline_exceeded",)


class RequestRecord:
    """One request's lifecycle: accumulated per-phase milliseconds plus
    the failover trail. Thread-safe (marks come from the client,
    scheduler, batcher and fleet-callback threads, though never
    concurrently by construction); every mutator is a no-op while the
    obs layer is disabled."""

    MAX_SEGMENTS = 64

    __slots__ = ("key", "t0", "deadline_ms", "fleet_owned",
                 "phases", "segments", "prefill_chunks_ms", "hops",
                 "retries", "kv_pages", "decode_steps", "tokens",
                 "prefix_hit_pages", "prefill_tokens_skipped",
                 "ttft_ms", "ttft_decomp", "total_ms", "outcome",
                 "n_marks", "_phase", "_t", "_ring", "_lock", "_done")

    def __init__(self, key, t0: Optional[float] = None,
                 deadline: Optional[float] = None, ring=None,
                 fleet_owned: bool = False):
        self.key = key
        self.t0 = time.perf_counter() if t0 is None else float(t0)
        self.deadline_ms = ((deadline - self.t0) * 1e3
                            if deadline is not None else None)
        self.fleet_owned = bool(fleet_owned)
        self.phases: Dict[str, float] = {}
        self.segments: List[tuple] = []     # (phase, t_start, t_end)
        self.prefill_chunks_ms: List[float] = []
        self.hops: List[Any] = []           # replica ids, in order
        self.retries = 0
        self.kv_pages = 0
        self.decode_steps = 0
        self.tokens = 0
        # prefix-cache reuse: pool pages of cached KV this request did
        # not have to write, and prompt tokens whose prefill it skipped
        # (0/0 on a miss or with the cache off)
        self.prefix_hit_pages = 0
        self.prefill_tokens_skipped = 0
        self.ttft_ms: Optional[float] = None
        self.ttft_decomp: Optional[Dict[str, float]] = None
        self.total_ms: Optional[float] = None
        self.outcome: Optional[str] = None
        self.n_marks = 0
        self._phase = "admission"
        self._t = self.t0
        self._ring = ring
        self._lock = threading.Lock()
        self._done = False

    # -- phase machine -----------------------------------------------------

    def _close_segment_locked(self, now: float) -> None:
        dur_ms = max(0.0, (now - self._t) * 1e3)
        self.phases[self._phase] = self.phases.get(self._phase,
                                                   0.0) + dur_ms
        if len(self.segments) < self.MAX_SEGMENTS:
            self.segments.append((self._phase, self._t, now))
        self._t = now

    def mark(self, phase: str, now: Optional[float] = None) -> None:
        """Close the current phase into its accumulated total and open
        ``phase``. Accumulative: a phase re-entered later (a deferred
        refill going back to the queue head, a later failover hop) adds
        to the same bucket."""
        if not _state.enabled:
            return
        now = time.perf_counter() if now is None else now
        with self._lock:
            if self._done:
                return
            self._close_segment_locked(now)
            self._phase = phase
            self.n_marks += 1

    def note_prefill_chunk(self, ms: float) -> None:
        if not _state.enabled:
            return
        with self._lock:
            if len(self.prefill_chunks_ms) < self.MAX_SEGMENTS:
                self.prefill_chunks_ms.append(float(ms))

    def first_token(self, now: Optional[float] = None) -> None:
        """Snapshot the TTFT decomposition. The in-progress phase's
        elapsed share is included WITHOUT closing it, so the snapshot
        partitions [t0, now] exactly: sum(ttft_decomp) == ttft_ms.
        Overwrites on a later call — after a failover only the
        delivering hop's first token is client-visible."""
        if not _state.enabled:
            return
        now = time.perf_counter() if now is None else now
        with self._lock:
            if self._done:
                return
            self.ttft_ms = (now - self.t0) * 1e3
            decomp = {k + "_ms": round(v, 4)
                      for k, v in self.phases.items()}
            open_key = self._phase + "_ms"
            decomp[open_key] = round(
                decomp.get(open_key, 0.0)
                + max(0.0, (now - self._t) * 1e3), 4)
            self.ttft_decomp = decomp

    # -- completion --------------------------------------------------------

    def note_hop(self, replica) -> None:
        if not _state.enabled:
            return
        with self._lock:
            self.hops.append(replica)

    def drop_hop(self) -> None:
        """Retract the most recent hop: the placement it announced was
        refused at admission (queue shed or closed), so the replica
        never held this request and must not appear in its trail."""
        if not _state.enabled:
            return
        with self._lock:
            if self.hops:
                self.hops.pop()

    def note_retry(self) -> None:
        if not _state.enabled:
            return
        with self._lock:
            self.retries += 1

    @property
    def done(self) -> bool:
        return self._done

    def complete(self, now: Optional[float] = None,
                 outcome: str = "completed") -> None:
        """Finalize: close the open phase, stamp the total, publish to
        the owning ring. Idempotent — the first completion wins (fleet
        and replica layers may both report a terminal outcome)."""
        if not _state.enabled:
            return
        now = time.perf_counter() if now is None else now
        with self._lock:
            if self._done:
                return
            self._close_segment_locked(now)
            self.total_ms = (now - self.t0) * 1e3
            self.outcome = outcome
            self._done = True
            ring = self._ring
        if ring is not None:
            ring.add(self)

    def attempt_failed(self, outcome: str,
                       now: Optional[float] = None) -> None:
        """One replica attempt failed. Standalone requests finalize
        (the attempt WAS the request); fleet-owned records stay open —
        the fleet decides between a ``failover`` mark and a final
        :meth:`complete`."""
        if not self.fleet_owned:
            self.complete(now, outcome=outcome)

    # -- introspection -----------------------------------------------------

    def missed_deadline(self) -> Optional[bool]:
        if self.deadline_ms is None:
            return None
        if self.outcome in _MISS_OUTCOMES:
            return True
        return (self.total_ms is not None
                and self.total_ms > self.deadline_ms)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready view; works mid-flight (the in-flight request
        table of a fleet; an open record reports its current phase and
        elapsed time)."""
        with self._lock:
            out: Dict[str, Any] = {
                "id": self.key,
                "outcome": self.outcome,
                "phases_ms": {k + "_ms": round(v, 4)
                              for k, v in self.phases.items()},
                "hops": list(self.hops),
                "retries": self.retries,
                "kv_pages": self.kv_pages,
                "decode_steps": self.decode_steps,
                "tokens": self.tokens,
                "prefix_hit_pages": self.prefix_hit_pages,
                "prefill_tokens_skipped": self.prefill_tokens_skipped,
                "ttft_ms": (round(self.ttft_ms, 4)
                            if self.ttft_ms is not None else None),
                "ttft_decomp": (dict(self.ttft_decomp)
                                if self.ttft_decomp else None),
                "total_ms": (round(self.total_ms, 4)
                             if self.total_ms is not None else None),
                "deadline_ms": (round(self.deadline_ms, 4)
                                if self.deadline_ms is not None
                                else None),
                "n_marks": self.n_marks,
                "prefill_chunks_ms": [round(v, 4) for v in
                                      self.prefill_chunks_ms],
            }
            if not self._done:
                out["open_phase"] = self._phase
                out["elapsed_ms"] = round(
                    (time.perf_counter() - self.t0) * 1e3, 4)
        return out


class RequestTraceRing:
    """Bounded ring of completed :class:`RequestRecord`\\s + lazy
    registry gauges + chrome lane export.

    The registry gets ``<prefix>.<phase>_ms`` / ``.ttft_ms`` /
    ``.total_ms`` / ``.decode_steps`` / ``.kv_pages`` / ``.hops`` /
    ``.requests``
    gauges (window summaries sampled at snapshot time) and the SLO
    family under ``serve.slo.*``: ``deadline_miss_rate``,
    ``deadline_miss_budget_consumed`` (that rate over ``slo_budget``),
    ``p99_deadline_margin_ms`` and ``shed_rate``.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 capacity: int = DEFAULT_CAPACITY,
                 prefix: str = "serve.timeline",
                 slo_budget: float = 0.01):
        if int(capacity) < 1:
            raise ValueError(
                f"reqtrace capacity must be >= 1, got {capacity}")
        if not (0.0 < float(slo_budget) <= 1.0):
            raise ValueError(
                f"slo_budget must be in (0, 1], got {slo_budget}")
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.prefix = prefix
        self.slo_budget = float(slo_budget)
        self._lock = threading.Lock()
        self._records: collections.deque = collections.deque(
            maxlen=int(capacity))
        self._total = 0
        g = self.registry.gauge
        for phase in PHASES:
            g(f"{prefix}.{phase}_ms").set_fn(
                self._column_fn(lambda r, p=phase: r.phases.get(p)))
        g(f"{prefix}.ttft_ms").set_fn(
            self._column_fn(lambda r: r.ttft_ms))
        g(f"{prefix}.total_ms").set_fn(
            self._column_fn(lambda r: r.total_ms))
        g(f"{prefix}.decode_steps").set_fn(
            self._column_fn(lambda r: float(r.decode_steps) or None))
        g(f"{prefix}.kv_pages").set_fn(
            self._column_fn(lambda r: float(r.kv_pages) or None))
        g(f"{prefix}.hops").set_fn(
            self._column_fn(lambda r: float(len(r.hops)) or None))
        g(f"{prefix}.prefix_hit_pages").set_fn(
            self._column_fn(
                lambda r: float(r.prefix_hit_pages) or None))
        g(f"{prefix}.prefill_tokens_skipped").set_fn(
            self._column_fn(
                lambda r: float(r.prefill_tokens_skipped) or None))
        g(f"{prefix}.requests").set_fn(lambda: self._total)
        g("serve.slo.deadline_miss_rate").set_fn(self.deadline_miss_rate)
        g("serve.slo.deadline_miss_budget_consumed").set_fn(
            self.deadline_miss_budget_consumed)
        g("serve.slo.p99_deadline_margin_ms").set_fn(
            self.p99_deadline_margin_ms)
        g("serve.slo.shed_rate").set_fn(self.shed_rate)

    # -- collection --------------------------------------------------------

    def add(self, rec: RequestRecord) -> None:
        if not _state.enabled:
            return
        with self._lock:
            self._records.append(rec)
            self._total += 1

    @property
    def total(self) -> int:
        with self._lock:
            return self._total

    def _window(self) -> List[RequestRecord]:
        with self._lock:
            return list(self._records)

    def records(self, last: Optional[int] = None) -> List[Dict]:
        """Snapshots of the most recent ``last`` completed records
        (all by default), oldest first."""
        recs = self._window()
        if last:
            recs = recs[-last:]
        return [r.snapshot() for r in recs]

    # -- lazy gauges -------------------------------------------------------

    def _column_fn(self, getter):
        def sample() -> Optional[Dict[str, float]]:
            vals = sorted(v for r in self._window()
                          if (v := getter(r)) is not None)
            return summarize_window(vals, len(vals)) if vals else None
        return sample

    def deadline_miss_rate(self) -> Optional[float]:
        flags = [m for r in self._window()
                 if (m := r.missed_deadline()) is not None]
        if not flags:
            return None
        return round(sum(flags) / len(flags), 4)

    def deadline_miss_budget_consumed(self) -> Optional[float]:
        rate = self.deadline_miss_rate()
        if rate is None:
            return None
        return round(rate / self.slo_budget, 4)

    def p99_deadline_margin_ms(self) -> Optional[float]:
        margins = sorted(r.deadline_ms - r.total_ms
                         for r in self._window()
                         if r.deadline_ms is not None
                         and r.total_ms is not None)
        if not margins:
            return None
        # ~1st-percentile-WORST margin: the headroom the p99 request
        # had left (negative = the budget is being blown at p99)
        return round(nearest_rank(margins, 0.01), 4)

    def shed_rate(self) -> Optional[float]:
        recs = self._window()
        if not recs:
            return None
        return round(sum(1 for r in recs if r.outcome == "shed")
                     / len(recs), 4)

    # -- chrome lanes keyed by request id ----------------------------------

    def to_chrome_trace(self) -> Dict:
        """Trace-event JSON with ONE LANE PER REQUEST: each record's
        phase segments render end to end on a viewer row labeled by
        request id — mergeable with the thread-lane export
        (obs/trace.py) since both share the perf_counter epoch."""
        from parallax_tpu_torch.obs import trace as trace_mod
        pid = os.getpid()
        events, meta = [], []
        for lane, rec in enumerate(self._window(), start=1):
            with rec._lock:
                segments = list(rec.segments)
                key, outcome = rec.key, rec.outcome
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": lane,
                         "args": {"name": f"req {key} "
                                          f"({outcome or 'open'})"}})
            for phase, t_start, t_end in segments:
                events.append({
                    "name": phase, "ph": "X", "pid": pid, "tid": lane,
                    "ts": round((t_start - trace_mod._EPOCH) * 1e6, 3),
                    "dur": round((t_end - t_start) * 1e6, 3),
                    "args": {"request": key}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, default=str)
        return path


__all__ = ["RequestRecord", "RequestTraceRing", "PHASES"]
