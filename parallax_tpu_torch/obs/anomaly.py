"""Online anomaly detection: step-time and loss/grad-norm change points.

A long run's worst failures are the quiet ones: step time creeping up
2× after a data-pipeline change, a grad-norm spike hours before the
loss diverges, a loss explosion at step 40k nobody is watching. This
module watches the per-step signals the session already produces and
raises ``anomaly.*`` counters (plus a flight-recorder dump via the
session's callback) the step an incident happens — not at the end of
the run.

Two detectors per signal, both robust (median/MAD, not mean/std — one
outlier must not poison the baseline it is judged against):

* **spike** — a single observation far above the rolling baseline:
  ``value > median * spike_min_ratio`` AND
  ``value - median > spike_mads * 1.4826 * MAD`` (the MAD gate keeps a
  naturally noisy signal from firing on the ratio alone; the ratio
  gate keeps a near-constant signal — MAD ≈ 0 — from firing on
  microscopic jitter).
* **shift** — a sustained level change (the change-point case: a
  regression, not a blip): the mean of the last ``shift_window``
  observations exceeds ``shift_ratio`` × the median of the older part
  of the window. After a shift fires the window is reset, so the new
  level becomes the baseline instead of re-firing forever.

Detection arms after ``min_samples`` observations (compiles and warmup
steps land in the baseline before anything can fire) and re-arms after
``cooldown`` further observations per signal. Per-observation cost is
a deque append + two compares against a cached baseline (refreshed
every ``refresh`` observations); disabled (``obs.disable()``) it is a
no-op.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, NamedTuple, Optional

from parallax_tpu_torch.obs import _state
from parallax_tpu_torch.obs.metrics import MetricsRegistry

# consistency constant: MAD of a normal sample estimates sigma / 1.4826
_MAD_SIGMA = 1.4826


class AnomalyEvent(NamedTuple):
    signal: str          # e.g. "step_time_ms", "grad_norm", "loss"
    kind: str            # "spike" | "shift"
    step: int
    value: float
    baseline: float      # the rolling median the value was judged against
    ratio: float         # value / baseline (shift: recent mean / baseline)


class _SignalDetector:
    """Spike + shift detection for one named signal."""

    def __init__(self, cfg):
        self.window: collections.deque = collections.deque(
            maxlen=int(cfg.window))
        self.cfg = cfg
        self._n = 0
        self._cooldown_until = 0
        # cached baseline, refreshed every REFRESH observations
        self._median = 0.0
        self._mad = 0.0
        self._stale = 0
        # running recent-mean window for the shift test (O(1) per
        # observation — re-sorting the window every step would spend
        # the obs overhead budget)
        self._recent: collections.deque = collections.deque(
            maxlen=max(2, int(cfg.shift_window)))
        self._recent_sum = 0.0

    def _refresh(self) -> None:
        vals = sorted(self.window)
        n = len(vals)
        self._median = vals[n // 2]
        self._mad = sorted(abs(v - self._median) for v in vals)[n // 2]
        self._stale = 0

    # baseline refresh cadence: the cached median/MAD may be up to this
    # many observations old — a deliberate trade (sorting the window
    # every step would spend the obs overhead budget on freshness a
    # rolling baseline doesn't need)
    REFRESH = 8

    def snapshot(self) -> dict:
        """JSON-able baseline state (checkpoint extras): the rolling
        window, observation counters and cooldown — everything a
        resumed run needs so detectors re-arm exactly where the
        interrupted run left them instead of re-learning (and possibly
        firing on) warmup noise."""
        return {
            "window": [float(v) for v in self.window],
            "recent": [float(v) for v in self._recent],
            "n": self._n,
            "cooldown_until": self._cooldown_until,
        }

    def restore(self, snap: dict) -> None:
        """Inverse of :meth:`snapshot`; tolerates truncated dicts."""
        self.window.clear()
        self.window.extend(float(v) for v in snap.get("window", []))
        self._recent.clear()
        self._recent.extend(float(v) for v in snap.get("recent", []))
        self._recent_sum = float(sum(self._recent))
        self._n = int(snap.get("n", len(self.window)))
        self._cooldown_until = int(snap.get("cooldown_until", 0))
        self._stale = 0  # recompute the cached median/MAD on next use

    def rebaseline(self) -> None:
        """Forget the baseline and hold fire for ``cooldown`` further
        observations — the new level becomes the new normal. Called on
        a detected shift, and externally for DELIBERATE level changes
        (a fleet scale event, a weight hot-swap): planned operations
        must not read as change-point anomalies."""
        self.window.clear()
        self._recent.clear()
        self._recent_sum = 0.0
        self._stale = 0
        self._cooldown_until = self._n + int(self.cfg.cooldown)

    def observe(self, step: int, value: float) -> Optional[AnomalyEvent]:
        cfg = self.cfg
        self._n += 1
        armed = (self._n > int(cfg.min_samples)
                 and self._n >= self._cooldown_until
                 and len(self.window) >= int(cfg.min_samples))
        event = None
        if armed:
            if self._stale <= 0:
                self._refresh()
                self._stale = self.REFRESH
            med, mad = self._median, self._mad
            # spike: this one observation is an outlier above baseline
            if (med > 0 and value > med * float(cfg.spike_min_ratio)
                    and value - med > float(cfg.spike_mads)
                    * _MAD_SIGMA * max(mad, 1e-12)):
                event = AnomalyEvent("", "spike", step, float(value),
                                     med, float(value) / med)
            else:
                # shift: the recent level moved, not just one sample —
                # running recent mean vs the cached window median (the
                # median trails a sustained move long enough to expose
                # it before absorbing it)
                sw = self._recent.maxlen
                if (len(self._recent) == sw
                        and len(self.window)
                        >= int(cfg.min_samples) + sw):
                    mean = (self._recent_sum - self._recent[0]
                            + value) / sw
                    if med > 0 and mean > med * float(cfg.shift_ratio):
                        event = AnomalyEvent("", "shift", step, mean,
                                             med, mean / med)
        if event is not None:
            self._cooldown_until = self._n + int(cfg.cooldown)
            if event.kind == "shift":
                # rebaseline: the new level is the new normal
                self.window.clear()
                self._recent.clear()
                self._recent_sum = 0.0
                self._stale = 0
        self.window.append(float(value))
        if len(self._recent) == self._recent.maxlen:
            self._recent_sum -= self._recent[0]
        self._recent.append(float(value))
        self._recent_sum += float(value)
        self._stale -= 1
        return event


class AnomalyMonitor:
    """Per-signal detectors behind one ``observe(signal, step, value)``.

    Events count into the registry (``anomaly.<signal>.spikes`` /
    ``.shifts``), land in a bounded event ring (the flight recorder
    dumps it), and invoke ``on_event`` (the session triggers a flight
    dump and logs a warning there — this module stays I/O-free).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 config=None,
                 on_event: Optional[Callable[[AnomalyEvent], None]]
                 = None,
                 event_capacity: int = 64):
        from parallax_tpu_torch.common.config import AnomalyConfig
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.config = config if config is not None else AnomalyConfig()
        self._on_event = on_event
        self._lock = threading.Lock()
        self._detectors: Dict[str, _SignalDetector] = {}
        self._events: collections.deque = collections.deque(
            maxlen=int(event_capacity))
        self._total_observed = 0

    @property
    def total_observed(self) -> int:
        """Lifetime observations (the per-observation cost is priced
        from this)."""
        with self._lock:
            return self._total_observed

    def observe(self, signal: str, step: int,
                value: float) -> Optional[AnomalyEvent]:
        """Feed one observation; returns the event if one fired."""
        if not _state.enabled or not self.config.enabled:
            return None
        with self._lock:
            det = self._detectors.get(signal)
            if det is None:
                det = self._detectors[signal] = _SignalDetector(
                    self.config)
            self._total_observed += 1
            event = det.observe(step, value)
            if event is not None:
                event = event._replace(signal=signal)
                self._events.append(event)
        if event is not None:
            self.registry.counter(
                f"anomaly.{signal}.{event.kind}s").inc()
            # per-CLASS totals next to the per-signal counters: the
            # scrape surface (obs/export.py) needs a bounded-cardinality
            # incident count — per-signal names explode with the
            # numerics feeds (one pair per layer), per-class does not
            self.registry.counter(f"anomaly.events.{event.kind}").inc()
            self.registry.counter("anomaly.events.total").inc()
            if self._on_event is not None:
                try:
                    self._on_event(event)
                except Exception:
                    # a broken callback must never fail the step that
                    # happened to trip the detector
                    pass
        return event

    def notify_deliberate_change(self, reason: str = "",
                                 signals: Optional[List[str]] = None
                                 ) -> None:
        """A DELIBERATE level change is about to happen (or just did):
        a fleet scale-up/down, a replica ejection's failover surge, a
        weight hot-swap. Rebaseline the named signals' detectors (all
        of them by default) — the post-event level becomes the new
        normal after ``cooldown`` observations instead of firing a
        false change-point the step the operation lands
        (the serving fleet calls this on every scale/swap/ejection
        event). Counted in ``anomaly.deliberate_changes``."""
        with self._lock:
            for name, det in self._detectors.items():
                if signals is None or name in signals:
                    det.rebaseline()
        self.registry.counter("anomaly.deliberate_changes").inc()
        if reason:
            from parallax_tpu_torch.common.lib import parallax_log
            parallax_log.info(
                "anomaly: rebaselined for deliberate change: %s",
                reason)

    def snapshot(self) -> Dict[str, dict]:
        """Per-signal baseline snapshots (exact-resume checkpoint
        extras; see _SignalDetector.snapshot)."""
        with self._lock:
            return {name: det.snapshot()
                    for name, det in self._detectors.items()}

    def restore_snapshot(self, snap: Optional[Dict[str, dict]]) -> None:
        """Recreate detectors from checkpointed baselines. Unknown or
        malformed entries are skipped — resuming must never fail on
        forensics state."""
        if not isinstance(snap, dict):
            return
        with self._lock:
            for name, det_snap in snap.items():
                try:
                    det = self._detectors.get(name)
                    if det is None:
                        det = self._detectors[name] = _SignalDetector(
                            self.config)
                    det.restore(det_snap)
                except Exception:
                    continue

    def events(self) -> List[dict]:
        """JSON-ready copies of the recent events (flight dumps)."""
        with self._lock:
            evs = list(self._events)
        return [{"signal": e.signal, "kind": e.kind, "step": e.step,
                 "value": round(e.value, 6),
                 "baseline": round(e.baseline, 6),
                 "ratio": round(e.ratio, 4)} for e in evs]
