"""Declarative alerting over the metrics registry.

The Prometheus exporter (obs/export.py) serves raw gauges; nothing in
the repo ever LOOKED at them. This module closes that loop in-process:
declarative :class:`AlertRule`\\ s are evaluated over
``MetricsRegistry`` snapshots on a cadence, walk a
pending → firing → resolved lifecycle with dedup and cooldown, and
every transition lands in the event journal, a flight dump, and the
``parallax_alerts`` Prometheus section — so an operator can learn
"this run is burning its SLO budget" from the scrape, the artifact, or
the journal, all carrying the same rule name.

Rule kinds:

  * ``threshold`` — fire while ``value <op> threshold`` (e.g.
    ``health.instability > 0.8``);
  * ``burn_rate`` — fire while the metric's rate of increase over the
    last ``window_s`` exceeds ``threshold`` per second (counters:
    serve-time recompiles, page-pool refill deferrals);
  * ``absence`` — fire while the metric is missing/None (a heartbeat
    that stopped reporting).

``for_s`` holds a breach in ``pending`` until it has been sustained;
``cooldown_s`` suppresses a re-fire right after a resolve (flap
damping); while ``firing``, repeated breaches re-emit nothing
(dedup). ``guard_metric``/``guard_min`` gate a rule until the run has
enough signal (the goodput-floor rule must not fire in a run's first
seconds when the fraction is trivially low).

The engine takes injectable ``clock``/``evaluate()`` so tests drive
the lifecycle deterministically under fake time; production runs call
``poll()`` from the step loop (cheap clock compare) or ``start()`` a
daemon thread (serving fleets have no step loop). Kill switch is
structural: the session constructs an engine only when the obs layer
is enabled — disabled runs have no rules, no thread, no state.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.obs import _state
from parallax_tpu_torch.obs.metrics import MetricsRegistry

KINDS = ("threshold", "burn_rate", "absence")
OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

# lifecycle states
OK, PENDING, FIRING = "ok", "pending", "firing"


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative rule over a registry snapshot value.

    ``metric`` is a snapshot key, optionally dotted into a summary
    dict: ``"engine.recompiles"`` or
    ``"pipeline.dispatch_gap_ms.p95"``.
    """

    name: str
    metric: str
    kind: str = "threshold"
    op: str = ">"
    threshold: float = 0.0
    window_s: float = 300.0   # burn_rate lookback
    for_s: float = 0.0        # sustain before firing
    cooldown_s: float = 60.0  # re-fire suppression after resolve
    severity: str = "warning"
    guard_metric: Optional[str] = None
    guard_min: float = 0.0
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"alert kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        if self.op not in OPS:
            raise ValueError(f"alert op must be one of "
                             f"{tuple(OPS)}, got {self.op!r}")
        if self.kind == "burn_rate" and self.window_s <= 0:
            raise ValueError("burn_rate rule needs window_s > 0")


def builtin_rules(goodput_floor: float = 0.5,
                  instability_threshold: float = 0.8
                  ) -> Tuple[AlertRule, ...]:
    """The stock ruleset every session/fleet arms: SLO burn,
    instability, serve-time recompiles, page-pool exhaustion,
    goodput-below-floor. Each is guarded/conservative enough that a
    clean run fires none of them (test_ops pins that)."""
    return (
        AlertRule(
            "slo_burn", "serve.slo.deadline_miss_budget_consumed",
            kind="threshold", op=">", threshold=1.0,
            severity="error", cooldown_s=60.0,
            description="deadline-miss rate exceeds the SLO budget"),
        AlertRule(
            "instability", "health.instability",
            kind="threshold", op=">",
            threshold=float(instability_threshold),
            severity="warning",
            description="anomaly-fed training instability score high"),
        AlertRule(
            "serve_recompiles", "serve.recompiles",
            kind="burn_rate", op=">", threshold=0.0, window_s=300.0,
            severity="warning",
            description="serve-time recompile happened (warmed "
                        "signature set should make this impossible)"),
        AlertRule(
            "page_pool_exhausted", "serve.kv_refill_deferred",
            kind="burn_rate", op=">", threshold=0.0, window_s=300.0,
            severity="warning",
            description="KV page pool exhausted: refills deferring"),
        AlertRule(
            "goodput_floor", "ops.goodput_fraction",
            kind="threshold", op="<", threshold=float(goodput_floor),
            guard_metric="ops.wall_s", guard_min=120.0,
            severity="warning",
            description="run goodput fraction below floor"),
    )


def _resolve(snapshot: Dict, metric: str):
    """Snapshot value for a (possibly dotted-into-a-summary) metric
    name; None when absent or non-numeric."""
    value = snapshot.get(metric)
    if value is None and "." in metric:
        base, field = metric.rsplit(".", 1)
        parent = snapshot.get(base)
        if isinstance(parent, dict):
            value = parent.get(field)
    if isinstance(value, bool):
        value = int(value)
    return value if isinstance(value, (int, float)) else None


class AlertEngine:
    """Evaluates rules over registry snapshots; owns the lifecycle.

    ``clock`` is injectable monotonic time (tests pass a fake);
    ``evaluate()`` is one pass, ``poll()`` throttles it to
    ``interval_s``, ``start()``/``stop()`` run it on a daemon thread.
    """

    def __init__(self, registry: MetricsRegistry,
                 rules: Tuple[AlertRule, ...] = (),
                 journal=None, flight=None,
                 interval_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if interval_s <= 0:
            raise ValueError(
                f"alert interval_s must be > 0, got {interval_s}")
        self._registry = registry
        self._journal = journal
        self._flight = flight
        self._clock = clock
        self._interval = float(interval_s)
        self._lock = threading.Lock()
        self._rules: Dict[str, AlertRule] = {}
        self._states: Dict[str, dict] = {}
        self._samples: Dict[str, list] = {}  # burn_rate (t, v) trail
        self._last_eval: Optional[float] = None
        self._stop_evt: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._firings = registry.counter("alerts.firings")
        self._resolved = registry.counter("alerts.resolved")
        self._evals = registry.counter("alerts.evals")
        registry.gauge("alerts.firing").set_fn(
            lambda: len(self.active()))
        for rule in rules:
            self.add_rule(rule)

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            self._rules[rule.name] = rule
            self._states.setdefault(rule.name, {
                "state": OK, "breach_since": None, "fired_at": None,
                "resolved_at": None, "count": 0, "value": None,
            })

    @property
    def rules(self) -> Tuple[AlertRule, ...]:
        with self._lock:
            return tuple(self._rules.values())

    # -- evaluation --------------------------------------------------------

    def _breached(self, rule: AlertRule, value, t: float) -> bool:
        if rule.kind == "absence":
            return value is None
        if value is None:
            return False  # threshold/burn_rate never fire on no data
        if rule.kind == "threshold":
            return OPS[rule.op](float(value), rule.threshold)
        # burn_rate: per-second increase over the window
        trail = self._samples.setdefault(rule.name, [])
        trail.append((t, float(value)))
        cutoff = t - rule.window_s
        while len(trail) > 1 and trail[0][0] < cutoff:
            trail.pop(0)
        if len(trail) < 2:
            return False
        dt = trail[-1][0] - trail[0][0]
        if dt <= 0:
            return False
        rate = (trail[-1][1] - trail[0][1]) / dt
        return OPS[rule.op](rate, rule.threshold)

    def evaluate(self) -> List[dict]:
        """One pass over all rules; returns the TRANSITIONS (fired /
        resolved events) this pass produced. Never raises."""
        if not _state.enabled:
            return []
        try:
            snapshot = self._registry.snapshot()
        except Exception:
            return []  # a poisoned gauge must not kill alerting
        t = self._clock()
        transitions: List[dict] = []
        with self._lock:
            rules = list(self._rules.values())
            self._last_eval = t
        self._evals.inc()
        for rule in rules:
            value = _resolve(snapshot, rule.metric)
            if rule.guard_metric is not None:
                guard = _resolve(snapshot, rule.guard_metric)
                if guard is None or guard < rule.guard_min:
                    continue
            breached = self._breached(rule, value, t)
            event = self._step_lifecycle(rule, breached, value, t)
            if event is not None:
                transitions.append(event)
        for event in transitions:
            self._emit(event)
        return transitions

    def _step_lifecycle(self, rule: AlertRule, breached: bool,
                        value, t: float) -> Optional[dict]:
        with self._lock:
            st = self._states[rule.name]
            st["value"] = value
            state = st["state"]
            if breached:
                if state == FIRING:
                    return None  # dedup: already firing
                resolved_at = st["resolved_at"]
                if (state == OK and resolved_at is not None
                        and t - resolved_at < rule.cooldown_s):
                    return None  # cooldown: flap damping
                if st["breach_since"] is None:
                    st["breach_since"] = t
                if t - st["breach_since"] >= rule.for_s:
                    st["state"] = FIRING
                    st["fired_at"] = t
                    st["count"] += 1
                    return {"transition": "firing", "rule": rule,
                            "value": value, "t": t}
                st["state"] = PENDING
                return None
            st["breach_since"] = None
            if state == FIRING:
                st["state"] = OK
                st["resolved_at"] = t
                return {"transition": "resolved", "rule": rule,
                        "value": value, "t": t}
            st["state"] = OK
            return None

    def _emit(self, event: dict) -> None:
        rule: AlertRule = event["rule"]
        firing = event["transition"] == "firing"
        (self._firings if firing else self._resolved).inc()
        parallax_log.warning(
            "alert %s %s: %s=%r (%s)", rule.name, event["transition"],
            rule.metric, event["value"], rule.description or rule.kind)
        if self._journal is not None:
            self._journal.emit(
                "alert", event["transition"],
                severity=rule.severity if firing else "info",
                alert=rule.name, metric=rule.metric,
                value=event["value"], rule_kind=rule.kind,
                threshold=rule.threshold)
        if firing and self._flight is not None:
            try:
                self._flight.trigger(
                    "alert:" + rule.name,
                    {"alert": rule.name, "metric": rule.metric,
                     "value": event["value"],
                     "severity": rule.severity,
                     "description": rule.description})
            except Exception:
                pass

    # -- cadence -----------------------------------------------------------

    def poll(self) -> None:
        """Evaluate iff ``interval_s`` has elapsed since the last pass
        — cheap enough for the step loop (one clock read + compare)."""
        if not _state.enabled:
            return
        t = self._clock()
        with self._lock:
            due = (self._last_eval is None
                   or t - self._last_eval >= self._interval)
        if due:
            self.evaluate()

    def start(self) -> "AlertEngine":
        """Daemon evaluation thread (serving fleets — no step loop to
        poll from). Idempotent."""
        if self._thread is not None:
            return self
        self._stop_evt = threading.Event()

        def _loop():
            while not self._stop_evt.wait(self._interval):
                self.evaluate()

        self._thread = threading.Thread(
            target=_loop, name="parallax-alert-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    # -- consumers ---------------------------------------------------------

    def active(self) -> List[str]:
        """Names of rules currently firing."""
        with self._lock:
            return sorted(n for n, st in self._states.items()
                          if st["state"] == FIRING)

    def state(self, name: str) -> Optional[str]:
        with self._lock:
            st = self._states.get(name)
            return st["state"] if st else None

    def summary(self) -> Dict:
        """JSON-ready lifecycle view (flight dumps, ops_report)."""
        with self._lock:
            return {
                "rules": len(self._rules),
                "firing": sorted(
                    n for n, st in self._states.items()
                    if st["state"] == FIRING),
                "firings_total": self._firings.value,
                "resolved_total": self._resolved.value,
                "states": {
                    n: {"state": st["state"], "count": st["count"],
                        "value": st["value"]}
                    for n, st in sorted(self._states.items())},
            }

    def prometheus_alerts(self) -> List[Dict]:
        """Rows for the exporter's ``parallax_alerts`` section: one
        sample per rule, value 1 while firing else 0."""
        with self._lock:
            rules = dict(self._rules)
            return [{"alert": name,
                     "severity": rules[name].severity,
                     "state": st["state"],
                     "value": 1.0 if st["state"] == FIRING else 0.0}
                    for name, st in sorted(self._states.items())]


__all__ = ["AlertRule", "AlertEngine", "builtin_rules"]
