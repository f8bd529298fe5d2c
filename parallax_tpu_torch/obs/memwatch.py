"""Device-memory watch: the graphs' pools and a live per-step ring (the
live part of the JAX package's ``obs/memwatch.py``).

Two memory truths, one owner:

* **Captured-step memory** — the counterpart of the JAX package's
  compiled peak (``memory_analysis()`` of one step executable): the
  bytes the captured CUDA graphs' private pools hold
  (:func:`graph_pool_bytes`, :func:`compiled_step_memory` on a live
  engine: every captured step graph, the numerics graphs included).
* **Live memory** — a bounded ring of ``device_memory_stats`` samples
  taken after each step's dispatch (:meth:`MemWatch.sample`):
  bytes-in-use / peak / limit per card from the caching allocator's
  counters, exported as lazy ``device.*`` registry gauges the
  Prometheus exporter (obs/export.py) serves, and an ``oom_risk``
  flight incident the moment a card crosses the risk fraction of its
  memory — the page-in-the-night BEFORE the OOM, with the ring in the
  artifact showing the climb.

Samples come from the allocator's host-side counters, never from
``cudaMemGetInfo``: a graph capture runs in ``thread_local`` error mode
(compile/graphs.py), and a CUDA call on the capturing thread would
break it. The session samples from the step thread after the dispatch,
never during a capture.

CPU honesty: the CPU reports no device memory, so on a CPU run the live
ring stays empty and the gauges are absent — never fabricated.
Killswitch: with the obs layer disabled (``PARALLAX_OBS=0`` /
``obs.disable()``) ``sample()`` is a structural no-op — no stats call,
no ring append, no gauges.

The tuner's OOM preflight (tune/search.py) judges a candidate plan's
captured-step peak against ``hbm_budget_bytes``: ``TuneConfig.
hbm_budget_gb`` when set, else the card's memory
(``torch.cuda.mem_get_info``), else (the CPU) None, and the preflight is
skipped. The JAX package compiles a candidate to read its peak and runs
nothing; the port's counterpart of that peak is the pool bytes of the
candidate's captured step, so the session's probe
(``ParallaxSession._preflight_peak``) captures it, which its trial would
pay anyway, on a state the capture leaves bitwise as it was.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, Optional

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.obs import _state
from parallax_tpu_torch.obs.health import device_memory_stats
from parallax_tpu_torch.obs.metrics import MetricsRegistry

# bytes-in-use / bytes-limit fraction above which a card is flagged as
# at OOM risk (one flight incident per process, flightrec dedups)
DEFAULT_OOM_RISK_FRAC = 0.92


def graph_pool_bytes(graphs) -> Optional[int]:
    """Bytes of the memory segments the private pools of ``graphs``
    (``torch.cuda.CUDAGraph``) hold, from the allocator's snapshot; None
    where the snapshot carries no pool ids. Reads every segment: call it
    after a capture, not per step."""
    import torch
    try:
        pools = {tuple(g.pool()) for g in graphs}
        if not pools:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)
    except Exception:
        return None


def compiled_step_memory(engine) -> Optional[Dict[str, Any]]:
    """Captured-step memory account of a live engine: the pool bytes of
    its captured step graphs (the numerics graphs counted apart), or None
    when it holds none (the CPU, eager steps). ``peak_bytes`` is the
    pools' total: the working set the captured steps hold beyond the
    state and their static inputs."""
    graphs = [g.graph for g in engine.captured_graphs()]
    if not graphs:
        return None
    numerics = [g.graph for g in engine.captured_graphs(numerics=True)]
    total = graph_pool_bytes(graphs + numerics)
    if total is None:
        return None
    return {"peak_bytes": total, "basis": "graph_pools",
            "graphs": len(graphs), "numerics_graphs": len(numerics),
            "numerics_pool_bytes": graph_pool_bytes(numerics)}


def card_memory_bytes() -> Optional[int]:
    """Total bytes of the current card (``torch.cuda.mem_get_info``), or
    None without one. A CUDA call: never from inside a capture."""
    import torch
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info()[1])


def hbm_budget_bytes(tune_config=None,
                     total_fn: Callable[[], Optional[int]] =
                     card_memory_bytes) -> Optional[int]:
    """The per-card memory budget the preflight judges captured-step
    peaks against (its limit is this times ``hbm_headroom``): an explicit
    ``TuneConfig.hbm_budget_gb`` wins; otherwise the card's memory. None
    when neither exists (the CPU without an override): the preflight then
    records itself as skipped rather than guessing."""
    if tune_config is not None \
            and getattr(tune_config, "hbm_budget_gb", None):
        return int(float(tune_config.hbm_budget_gb) * 1e9)
    try:
        total = total_fn()
    except Exception:
        return None
    return int(total) if total else None


class MemWatch:
    """Bounded live-HBM ring + compiled peaks + oom_risk incidents.

    One instance per session; ``sample()`` runs post-dispatch on the
    dispatch thread (cost: one read of the allocator's counters for the
    current card). ``stats_fn`` is injectable so tests run without a
    card.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 flight=None, capacity: int = 256, every: int = 1,
                 oom_risk_frac: float = DEFAULT_OOM_RISK_FRAC,
                 stats_fn: Callable[[], Dict] = device_memory_stats):
        if int(capacity) < 1:
            raise ValueError(
                f"memwatch capacity must be >= 1, got {capacity}")
        if int(every) < 1:
            raise ValueError(
                f"memwatch every must be >= 1, got {every}")
        if not (0.0 < float(oom_risk_frac) <= 1.0):
            raise ValueError(
                f"oom_risk_frac must be in (0, 1], got "
                f"{oom_risk_frac}")
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._flight = flight
        self._every = int(every)
        self._frac = float(oom_risk_frac)
        self._stats_fn = stats_fn
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=int(capacity))
        self._last: Dict[str, Dict[str, int]] = {}
        self._gauged: set = set()
        self._calls = 0
        self._total = 0
        # stats-less-backend latch: the CPU answers with nothing,
        # forever — after a few empty polls the per-step sample
        # collapses to one attribute check (the 2% obs budget matters)
        self._empty_polls = 0
        self._unavailable = False
        self._samples = self.registry.counter("memwatch.samples")
        self._risk_events = self.registry.counter(
            "memwatch.oom_risk_events")
        self._compiled: Optional[Dict[str, Any]] = None
        self._live_peak = 0

    @property
    def total_samples(self) -> int:
        """Lifetime ring appends (0 under the killswitch). Plain int,
        not the registry counter: the killswitch makes counters no-op,
        and the structural claim is that the ring itself never grew."""
        with self._lock:
            return self._total

    def sample(self, step: Optional[int] = None) -> Optional[Dict]:
        """Poll device memory once (respecting ``every``) and append
        to the ring; fires the ``oom_risk`` incident when any device
        crosses the risk fraction of its limit. Structural no-op when
        the obs layer is disabled (no stats call, no ring) or the
        backend reports nothing (CPU)."""
        if not _state.enabled or self._unavailable:
            return None
        self._calls += 1
        if (self._calls - 1) % self._every:
            return None
        try:
            stats = self._stats_fn() or {}
        except Exception:
            return None
        if not stats:
            self._empty_polls += 1
            if self._empty_polls >= 3:
                self._unavailable = True
            return None
        self._empty_polls = 0
        row = {"step": step, "ts": time.time(),
               "devices": {d: {k: int(v) for k, v in s.items()
                               if k in ("bytes_in_use",
                                        "peak_bytes_in_use",
                                        "bytes_limit")}
                           for d, s in stats.items()}}
        at_risk = []
        with self._lock:
            self._ring.append(row)
            self._total += 1
            self._last = row["devices"]
            for dev, s in row["devices"].items():
                in_use = s.get("bytes_in_use", 0)
                self._live_peak = max(self._live_peak,
                                      s.get("peak_bytes_in_use",
                                            in_use))
                limit = s.get("bytes_limit")
                if limit and in_use / limit >= self._frac:
                    at_risk.append({"device": dev,
                                    "bytes_in_use": in_use,
                                    "bytes_limit": limit,
                                    "frac": round(in_use / limit,
                                                  4)})
        self._samples.inc()
        self._register_gauges(row["devices"])
        if at_risk:
            self._risk_events.inc(len(at_risk))
            parallax_log.warning(
                "memwatch: %d device(s) above %.0f%% of HBM limit: "
                "%s", len(at_risk), self._frac * 100, at_risk)
            if self._flight is not None:
                self._flight.trigger(
                    "oom_risk", {"step": step, "devices": at_risk,
                                 "risk_frac": self._frac})
        return row

    def _register_gauges(self, devices: Dict[str, Dict]) -> None:
        """Lazy per-device gauges (``device.<dev>.bytes_in_use`` /
        ``peak_bytes`` / ``bytes_limit``) reading the latest sample —
        one registration per device ever seen, zero extra device
        polls at scrape time, served by the Prometheus exporter like
        any other gauge."""
        for dev in devices:
            if dev in self._gauged:
                continue
            self._gauged.add(dev)
            for key, field in (("bytes_in_use", "bytes_in_use"),
                               ("peak_bytes", "peak_bytes_in_use"),
                               ("bytes_limit", "bytes_limit")):
                self.registry.gauge(
                    f"device.{dev}.{key}").set_fn(
                    lambda d=dev, f=field: self._last.get(
                        d, {}).get(f))

    def capture_compiled(self, engine) -> Optional[Dict[str, Any]]:
        """Record the engine's captured-step memory account (call after
        warmup, when the graphs exist); exported as the
        ``memwatch.compiled_peak_bytes`` gauge and the flight artifact's
        ``compiled`` section."""
        m = compiled_step_memory(engine)
        if m:
            self._compiled = m
            self.registry.gauge("memwatch.compiled_peak_bytes").set(
                m["peak_bytes"])
        return m

    def live_peak_bytes(self) -> Optional[int]:
        """High-water bytes-in-use across every sample so far; None
        when the backend never reported."""
        with self._lock:
            return self._live_peak or None

    def stats(self) -> Dict[str, Any]:
        """JSON-ready flight-recorder section: the ring, the compiled
        account, the live high-water mark and the risk counter."""
        with self._lock:
            ring = list(self._ring)
            peak = self._live_peak
        return {
            "samples": self._samples.value,
            "oom_risk_events": self._risk_events.value,
            "live_peak_bytes": peak or None,
            "compiled": self._compiled,
            "ring": ring[-32:],
        }


__all__ = ["MemWatch", "DEFAULT_OOM_RISK_FRAC", "graph_pool_bytes",
           "compiled_step_memory", "card_memory_bytes",
           "hbm_budget_bytes"]
