"""Span tracing: host-side timeline of the serving threads.

A thread-safe ``span("name", **attrs)`` context manager appends (name,
start, duration, thread) records to a process-wide ring buffer, and
``export_chrome_trace(path)`` writes them as Chrome trace-event JSON
(`chrome://tracing` / Perfetto "complete" events), so the host timeline
of the client threads and the scheduler thread lands in one view.

Design constraints:
  * **low overhead** — a span is two ``perf_counter()`` calls, one tuple
    and one deque append (~µs); with the layer disabled
    (`obs.disable()` / env ``PARALLAX_OBS=0``) ``span()`` returns a
    shared no-op and costs one attribute load.
  * **bounded memory** — the collector is a ring buffer
    (``TraceCollector(capacity)``, default 65536 events ≈ a few MB);
    old events fall off, recent history is always exportable.
  * **nesting for free** — Chrome "X" (complete) events nest by interval
    containment per thread id, so no parent bookkeeping is needed.

Timestamps are ``time.perf_counter()`` relative to module load (one
monotonic clock shared by every thread in the process), exported in
microseconds as the chrome format requires.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from parallax_tpu_torch.obs import _state

# one origin for every thread: chrome wants comparable microsecond ts
_EPOCH = time.perf_counter()

DEFAULT_CAPACITY = 65536


class TraceEvent(NamedTuple):
    name: str
    ts: float           # seconds since _EPOCH (span start)
    dur: float          # seconds
    tid: int            # thread ident
    thread_name: str
    args: Optional[dict]


class TraceCollector:
    """Thread-safe ring buffer of TraceEvents + chrome export."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=int(capacity))
        self._total = 0

    @property
    def capacity(self) -> int:
        return self._events.maxlen

    def set_capacity(self, capacity: int) -> None:
        """Resize the ring, keeping the most recent events.

        The swap is not synchronized with the lock-free ``record()``
        hot path: a span retiring on another thread during the swap can
        land in the discarded deque and vanish. Deliberate trade-off —
        resizes happen once per session construction, and taking the
        lock on every record() would spend the overhead budget on an
        event-loss window of microseconds per process lifetime."""
        capacity = int(capacity)
        with self._lock:
            if capacity == self._events.maxlen:
                return
            self._events = collections.deque(self._events,
                                             maxlen=capacity)

    def record(self, event: TraceEvent) -> None:
        # lock-free hot path: deque.append with maxlen is atomic under
        # the GIL (eviction included); the lock only guards the
        # swap-style operations (clear / snapshot). The
        # _total counter may lose rare cross-thread increments — it only
        # feeds the `dropped` diagnostic.
        self._events.append(event)
        self._total += 1

    def events(self) -> List[TraceEvent]:
        """Snapshot (oldest first)."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._total = 0

    @property
    def dropped(self) -> int:
        """Events pushed out of the ring so far (0 = full history)."""
        with self._lock:
            return max(0, self._total - len(self._events))

    # -- chrome trace-event export ----------------------------------------

    def to_chrome_trace(self) -> Dict:
        """The trace-event JSON object (``{"traceEvents": [...]}``)."""
        pid = os.getpid()
        events = self.events()
        out = []
        # track key is (ident, name), not bare ident: the OS recycles
        # thread idents, and two sequential prefetch threads sharing one
        # would otherwise interleave on a single mislabeled viewer row
        display_tids: Dict[tuple, int] = {}
        for ev in events:
            tid = display_tids.setdefault((ev.tid, ev.thread_name),
                                          len(display_tids) + 1)
            rec = {"name": ev.name, "ph": "X", "pid": pid, "tid": tid,
                   "ts": round(ev.ts * 1e6, 3),
                   "dur": round(ev.dur * 1e6, 3)}
            if ev.args:
                rec["args"] = ev.args
            out.append(rec)
        # thread-name metadata rows so the viewer labels each track
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": tname}}
                for (_ident, tname), tid in sorted(display_tids.items(),
                                                   key=lambda kv: kv[1])]
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        """Write the chrome trace JSON file; returns the path."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            # default=str: span attrs are arbitrary user values (np
            # scalars, paths, ...) — stringify rather than fail the
            # whole export over one arg
            json.dump(self.to_chrome_trace(), f, default=str)
        return path


# the process-wide collector every span() writes to (swappable for tests)
_collector = TraceCollector()


def get_collector() -> TraceCollector:
    return _collector


def set_collector(collector: TraceCollector) -> TraceCollector:
    """Install a collector (returns the previous one)."""
    global _collector
    prev, _collector = _collector, collector
    return prev


# per-thread name cache: threading.get_ident() is a cheap C call where
# current_thread() is a dict lookup + object attr walk. threading.local
# (not a dict keyed by ident) so a recycled ident from a dead thread
# can never label a new thread's spans with the old thread's name, and
# entries die with their threads instead of accumulating.
_thread_name_cache = threading.local()


class _Span:
    """One timed region; records on exit. Exceptions propagate (and are
    flagged in args so a failed region is visible on the timeline)."""

    __slots__ = ("_name", "_args", "_t0")

    def __init__(self, name: str, args: Optional[dict]):
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = time.perf_counter()
        args = self._args
        if exc_type is not None:
            args = dict(args or {}, error=exc_type.__name__)
        tid = threading.get_ident()
        name = getattr(_thread_name_cache, "name", None)
        if name is None:
            name = threading.current_thread().name
            _thread_name_cache.name = name
        _collector.record(TraceEvent(self._name, self._t0 - _EPOCH,
                                     end - self._t0, tid, name, args))
        # returning None: never swallow the exception


class _NullSpan:
    """Shared no-op for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


def span(name: str, **attrs):
    """Context manager timing one region::

        with trace.span("session.dispatch", step=12):
            ...

    Thread-safe; nests naturally (chrome renders containment per
    thread). With observability disabled, returns a shared no-op.
    """
    if not _state.enabled:
        return _NULL_SPAN
    return _Span(name, attrs or None)


def record_span(name: str, start: float, end: float, **attrs) -> None:
    """Record an already-timed region (``perf_counter()`` endpoints).

    The context-manager form can only time a region that opens and
    closes on one thread; a serving request's lifetime spans the client
    thread (enqueue) and the batcher/scheduler thread (completion), so
    the completing thread records the whole interval after the fact.
    """
    if not _state.enabled:
        return
    tid = threading.get_ident()
    tname = getattr(_thread_name_cache, "name", None)
    if tname is None:
        tname = threading.current_thread().name
        _thread_name_cache.name = tname
    _collector.record(TraceEvent(name, start - _EPOCH,
                                 max(0.0, end - start), tid, tname,
                                 attrs or None))


def export_chrome_trace(path: str) -> str:
    """Export the process-wide collector to ``path``."""
    return _collector.export_chrome_trace(path)
