"""Metrics registry: named counters / gauges / histograms.

One registry per session gathers every runtime signal — the async
pipeline's dispatch gap, H2D bytes and blocked-on-device
(``PipelineStats``), steps/sec, engine recompiles, health and numerics
outputs, serving counters — behind a single ``snapshot()`` that is
JSON-ready, and an optional periodic JSONL sink (``JsonlSink``,
``Config.metrics_path`` / ``metrics_interval_s``) for scraping live
runs.

Instruments are created get-or-create by name (``registry.counter(n)``,
``.gauge(n)``, ``.histogram(n)``), are individually thread-safe (the
client threads and the scheduler thread write concurrently), and
become no-ops when the observability layer is disabled
(`obs.disable()` / env ``PARALLAX_OBS=0``).

Histograms keep lifetime count/sum/max plus a bounded rolling window
(default 512 samples) for p50/p95 — memory stays O(window) however long
the run.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Dict, Optional

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.obs import _state


class Counter:
    """Monotonic named count."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if not _state.enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Gauge:
    """Last-written value; ``set_fn`` installs a callable sampled at
    snapshot time instead (for values derived from live state, e.g.
    tokens/sec)."""

    __slots__ = ("name", "_lock", "_value", "_fn")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = None
        self._fn = None

    def set(self, value) -> None:
        if not _state.enabled:
            return
        with self._lock:
            self._value = value

    def set_fn(self, fn) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self):
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return fn()
        except Exception:
            return None

    def snapshot(self):
        return self.value


def nearest_rank(window, q: float):
    """The q-quantile of a SORTED window by the nearest-rank method
    (None when empty). A truncating index would report p95 BELOW p50
    on tiny windows (n=2 -> index 0, the minimum). THE quantile rule
    of this package — histogram summaries and the request-trace ring
    share it, so the same data can never summarize two ways."""
    n = len(window)
    if n == 0:
        return None
    return window[min(n - 1, max(0, math.ceil(q * n) - 1))]


def summarize_window(window, count: int) -> Optional[Dict[str, float]]:
    """{count, mean, p50, p95, max} for a SORTED sample window (None
    when empty). Shared by Histogram.snapshot and the request-trace
    ring, so every summary has one shape."""
    n = len(window)
    if n == 0:
        return None

    return {
        "count": count,
        "mean": sum(window) / n,
        "p50": nearest_rank(window, 0.50),
        "p95": nearest_rank(window, 0.95),
        "max": window[-1],
    }


class Histogram:
    """Lifetime count + bounded rolling window for the statistics.

    mean/p50/p95/max all describe the WINDOW (most recent ``window``
    samples): the job of these histograms is trend/regression
    visibility — a step-time regression after 50k steps must show up in
    the next snapshot, not be diluted by 50k healthy earlier samples,
    and the warmup step must not pin ``max`` forever.
    ``count`` alone is lifetime (how many samples ever flowed).
    """

    __slots__ = ("name", "_lock", "_window", "_count")

    def __init__(self, name: str, window: int = 512):
        self.name = name
        self._lock = threading.Lock()
        self._window: collections.deque = collections.deque(
            maxlen=int(window))
        self._count = 0

    def record(self, value: float) -> None:
        if not _state.enabled:
            return
        with self._lock:
            self._window.append(float(value))
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> Optional[Dict[str, float]]:
        """{count (lifetime), mean, p50, p95, max (rolling window)};
        None when empty."""
        with self._lock:
            if self._count == 0:
                return None
            window = sorted(self._window)
        return summarize_window(window, self._count)


class MetricsRegistry:
    """Get-or-create instruments by name; one JSON-ready snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 512) -> Histogram:
        """``window`` applies only when this call CREATES the
        instrument; a later get-or-create with a different window
        returns the existing histogram unchanged (the first creator
        owns the sizing)."""
        return self._get(name, Histogram, window)

    def names(self):
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> Dict:
        """{name: value | histogram-dict}, JSON-serializable, sorted."""
        with self._lock:
            items = sorted(self._instruments.items())
        return {name: inst.snapshot() for name, inst in items}


class JsonlSink:
    """Background thread appending one ``registry.snapshot()`` JSON line
    to ``path`` every ``interval_s`` seconds (plus a final line at
    ``stop()``, so short runs still leave a record). Each line carries a
    wall-clock ``ts`` so scrapers can align runs.

    ``max_bytes`` bounds the file for long-lived processes (a serving
    fleet scraping every 10s fills a disk in weeks): when appending
    would exceed it, the current file rotates to ``<path>.1``
    (replacing any previous rotation — at most 2x ``max_bytes`` on
    disk) with a loud log line. Default None keeps the historical
    grow-forever behavior."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 interval_s: float = 10.0,
                 snapshot_fn: Optional[callable] = None,
                 max_bytes: Optional[int] = None):
        if interval_s <= 0:
            raise ValueError(
                f"metrics_interval_s must be > 0, got {interval_s}")
        if max_bytes is not None and int(max_bytes) <= 0:
            raise ValueError(
                f"metrics_max_bytes must be > 0 or None, got "
                f"{max_bytes}")
        self._registry = registry
        self._path = path
        self._interval = float(interval_s)
        self._max_bytes = int(max_bytes) if max_bytes else None
        # richer snapshot (the session's metrics_snapshot refreshes
        # polled gauges first); may touch live device state, so any
        # failure — e.g. racing a donated buffer — falls back to the
        # plain registry: the sink must never kill or corrupt a run
        self._snapshot_fn = snapshot_fn
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="parallax-metrics-sink",
                                        daemon=True)
        self._thread.start()

    def _write_line(self) -> None:
        snap = None
        if self._snapshot_fn is not None:
            try:
                snap = self._snapshot_fn()
            except Exception:
                snap = None
        if snap is None:
            snap = self._registry.snapshot()
        try:
            # default=str: user gauges can hold np/torch scalars; a
            # TypeError here would kill the sink thread for the
            # rest of the run
            line = json.dumps({"ts": time.time(), "metrics": snap},
                              default=str) + "\n"
            self._maybe_rotate(len(line))
            with open(self._path, "a") as f:
                f.write(line)
        except OSError:
            pass

    def _maybe_rotate(self, incoming: int) -> None:
        """Size-bounded rotation: roll ``path`` -> ``path.1`` when the
        next line would cross ``max_bytes``. LOUD by design — a
        rotation means history is being discarded."""
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
            "metrics sink rotated %s (%d bytes >= metrics_max_bytes="
            "%d) to %s; older history discarded", self._path, size,
            self._max_bytes, rotated)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self._write_line()

    def stop(self) -> None:
        """Idempotent; writes one final line (the end-of-run state)."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._write_line()


class PipelineStats:
    """The async step pipeline's rolling observability on the metrics
    registry: three overlap signals — **dispatch gap** (host idle between dispatches: the bubble
    the prefetcher closes), **H2D bytes** (feed bytes placed per step),
    **blocked-on-device** (host time inside fetch materialization) —
    plus steps and steps/sec, now named registry instruments
    (``pipeline.*``) so one ``registry.snapshot()`` carries them next to
    engine / health metrics.

    ``summary()`` gives the JAX package's shape, with p50/p95.
    """

    STEPS_PER_SEC_WINDOW = 20

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 window: int = 200):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._gap = self.registry.histogram("pipeline.dispatch_gap_ms",
                                            window)
        self._dispatch = self.registry.histogram("pipeline.dispatch_ms",
                                                 window)
        self._blocked = self.registry.histogram(
            "pipeline.blocked_on_device_ms", window)
        self._h2d = self.registry.histogram("pipeline.h2d_bytes", window)
        self._steps = self.registry.counter("pipeline.steps")
        self._lock = threading.Lock()
        self._times: collections.deque = collections.deque(
            maxlen=self.STEPS_PER_SEC_WINDOW)
        self.registry.gauge("pipeline.steps_per_sec").set_fn(
            self.steps_per_sec)

    def record_dispatch(self, gap_s: Optional[float],
                        dispatch_s: float) -> None:
        if not _state.enabled:
            return
        if gap_s is not None:
            self._gap.record(gap_s * 1e3)
        self._dispatch.record(dispatch_s * 1e3)
        self._steps.inc()
        with self._lock:
            self._times.append(time.perf_counter())

    def record_h2d(self, nbytes: int) -> None:
        self._h2d.record(int(nbytes))

    def record_blocked(self, seconds: float) -> None:
        self._blocked.record(seconds * 1e3)

    def steps_per_sec(self) -> Optional[float]:
        """Rolling dispatch throughput over the last <=20 steps (the
        framework-side metric the reference left to user programs)."""
        with self._lock:
            window = list(self._times)
        if len(window) < 2:
            return None
        dt = window[-1] - window[0]
        return (len(window) - 1) / dt if dt > 0 else None

    @staticmethod
    def _ms(hist: Histogram) -> Optional[Dict[str, float]]:
        snap = hist.snapshot()
        if snap is None:
            return None
        return {"mean_ms": round(snap["mean"], 3),
                "p50_ms": round(snap["p50"], 3),
                "p95_ms": round(snap["p95"], 3),
                "max_ms": round(snap["max"], 3)}

    def summary(self) -> Dict:
        """Snapshot over the rolling window, JSON-ready (bench.py)."""
        h2d = self._h2d.snapshot()
        sps = self.steps_per_sec()
        return {
            "steps": self._steps.value,
            "steps_per_sec": round(sps, 3) if sps else None,
            "dispatch_gap": self._ms(self._gap),
            "dispatch": self._ms(self._dispatch),
            "blocked_on_device": self._ms(self._blocked),
            "h2d_bytes_per_step": (round(h2d["mean"])
                                   if h2d else None),
        }
