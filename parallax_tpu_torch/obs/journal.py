"""Unified event journal: one causally-ordered stream of run events.

The repo's forensics are windowed by subsystem — timeline rows, health
readings, anomaly events, request records — but "what happened to this
run" is a SEQUENCE question spanning all of them: an anomaly fired, so
the ledger rolled back, so a checkpoint was discarded, so the resume
replayed three steps. This module gives every run-lifecycle emitter one
append-only, causally-ordered structured stream:

  * every event carries a process-monotonic ``seq`` (causal order even
    when two events land in the same ``time.time()`` tick), a wall
    clock ``ts``, the emitting ``subsystem`` (``anomaly`` / ``ckpt`` /
    ``recovery`` / ``preempt`` / ``fleet`` / ``tune`` / ``numerics`` /
    ``flight`` / ``alert`` / ...), an event ``kind``, a ``severity``,
    and optional correlation ids — the flight recorder's
    ``incident_id`` and serving request ids — so an incident
    artifact, a Prometheus alert and a journal line can all be joined;
  * a bounded in-memory ring (default 512 events — the recent causal
    history, always available) whose tail every flight dump embeds, so
    an incident artifact carries its own history;
  * an optional rotating JSONL sink (``Config(journal_path=...)``) —
    each event appended as one JSON line; when the file would cross
    ``journal_max_bytes`` it rotates to ``<path>.1`` like the metrics
    sink, bounding disk for long-lived fleets;
  * chrome lanes: each event also lands as a zero-width span
    (``journal.<subsystem>``) in the trace collector, so the
    chrome://tracing view shows lifecycle events against the
    dispatch/prefetch timeline.

Emit cost is one lock + one dict + one deque append (plus one write()
when a sink is configured).
Events are RARE (lifecycle, not per-step); nothing in the hot step path
emits unconditionally. The kill switch is structural: the session only
constructs a journal when the obs layer is enabled, and ``emit`` is
additionally a no-op under ``obs.disable()``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.obs import _state, trace
from parallax_tpu_torch.obs.metrics import MetricsRegistry

DEFAULT_CAPACITY = 512

SEVERITIES = ("debug", "info", "warning", "error")


class EventJournal:
    """Append-only run-event stream: bounded ring + optional JSONL sink.

    Thread-safe: the dispatch thread, the preemption helper thread, a
    fleet health-checker and the alert engine may all emit
    concurrently; ``seq`` is assigned under the lock so readers can
    totally order events regardless of wall-clock resolution.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 path: Optional[str] = None,
                 max_bytes: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None):
        if int(capacity) < 1:
            raise ValueError(
                f"journal capacity must be >= 1, got {capacity}")
        if max_bytes is not None and int(max_bytes) <= 0:
            raise ValueError(
                f"journal_max_bytes must be > 0 or None, got "
                f"{max_bytes}")
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=int(capacity))
        self._seq = 0
        self._path = path
        self._max_bytes = int(max_bytes) if max_bytes else None
        self._registry = registry if registry is not None \
            else MetricsRegistry()
        self._events = self._registry.counter("journal.events")
        self._drops = self._registry.counter("journal.sink_errors")

    # -- producer ----------------------------------------------------------

    def emit(self, subsystem: str, kind: str, /,
             severity: str = "info",
             incident_id: Optional[str] = None,
             request_id: Optional[str] = None,
             **fields) -> Optional[dict]:
        """Append one event; returns it (or None when obs is disabled).

        ``subsystem`` and ``kind`` are positional-only so an emitter
        may carry a ``kind=...`` payload field (anomaly kinds,
        non-finite kinds) without colliding with the event envelope.
        ``fields`` must be JSON-serializable-ish (the sink stringifies
        what json can't take, so an np scalar degrades rather than
        kills the run).
        """
        if not _state.enabled:
            return None
        ts = time.time()
        event: Dict = {
            "seq": 0,  # assigned under the lock below
            "ts": ts,
            "subsystem": str(subsystem),
            "kind": str(kind),
            "severity": (severity if severity in SEVERITIES
                         else "info"),
        }
        if incident_id is not None:
            event["incident_id"] = incident_id
        if request_id is not None:
            event["request_id"] = request_id
        if fields:
            event["fields"] = fields
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._ring.append(event)
        self._events.inc()
        self._registry.counter("journal.events." + event["subsystem"]) \
            .inc()
        if self._path:
            self._write_line(event)
        # zero-width chrome lane: lifecycle events against the
        # dispatch/prefetch span timeline
        now = time.perf_counter()
        trace.record_span("journal." + event["subsystem"], now, now,
                          kind=event["kind"],
                          severity=event["severity"])
        return event

    def _write_line(self, event: dict) -> None:
        try:
            line = json.dumps(event, default=str) + "\n"
            self._maybe_rotate(len(line))
            with open(self._path, "a") as f:
                f.write(line)
        except OSError:
            # the journal must never make an incident worse
            self._drops.inc()

    def _maybe_rotate(self, incoming: int) -> None:
        if self._max_bytes is None:
            return
        try:
            size = os.path.getsize(self._path)
        except OSError:
            return  # no file yet
        if size == 0 or size + incoming <= self._max_bytes:
            return
        rotated = self._path + ".1"
        os.replace(self._path, rotated)
        parallax_log.warning(
            "event journal rotated %s (%d bytes >= journal_max_bytes="
            "%d) to %s; older events discarded", self._path, size,
            self._max_bytes, rotated)

    # -- consumers ---------------------------------------------------------

    @property
    def seq(self) -> int:
        """Lifetime events emitted."""
        with self._lock:
            return self._seq

    def tail(self, n: int = 64) -> List[dict]:
        """Copies of the most recent ``n`` ring events, oldest first —
        the causal history every flight dump embeds."""
        with self._lock:
            events = list(self._ring)
        return [dict(e) for e in events[-int(n):]]

    def events(self) -> List[dict]:
        """The whole ring, oldest first."""
        with self._lock:
            return [dict(e) for e in self._ring]


def read_journal(path: str) -> List[dict]:
    """Parse a journal JSONL file (ops reports); unparseable
    lines are skipped. Order is wall-clock first, then ``seq``: a
    resumed attempt appends to the same file with its own seq
    numbering, so ts orders across attempts while seq breaks ties
    within one process's clock tick."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        return []
    out.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    return out


__all__ = ["EventJournal", "read_journal", "DEFAULT_CAPACITY"]
