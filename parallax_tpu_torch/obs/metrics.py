"""Metrics registry: named counters / gauges / histograms.

One registry per serve session gathers every runtime signal behind a
single ``snapshot()`` that is JSON-ready.

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
import math
import threading
from typing import Dict, Optional

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
