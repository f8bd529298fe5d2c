"""Health-aware request routing over serving replicas
(``parallax_tpu/serve/router.py``).

The fleet's control plane: every replica carries a health state the
router maintains from three probe families, and placement only ever
lands on replicas the probes trust —

* **heartbeat** — each serving loop refreshes ``session.heartbeat``
  every pass (including idle polls), so a stalled device step, a
  wedged host thread or an injected stall all read as a stale
  heartbeat: ``stale > heartbeat_timeout_s`` degrades the replica,
  ``stale > 3x`` ejects it.
* **error rate** — every batch outcome lands in a bounded per-replica
  window (``record_success`` / ``record_error``); a window error rate
  at ``degrade_error_rate`` degrades, at ``eject_error_rate`` ejects.
  Deadline expiries are NOT errors (shedding on time is the deadline
  contract working), and a dead session (``alive == False``) is
  ejected permanently — there is nothing to re-admit.
* **latency** — an EWMA of per-request serve latency per replica; a
  replica whose EWMA exceeds ``latency_degrade_ratio`` x the fleet
  median is degraded (the single-replica straggler the multi-host
  aggregate names during training, applied to serving).

States move ``healthy -> degraded -> ejected`` and back. Ejection
opens a circuit breaker: the replica takes no traffic for a backoff
that doubles with each consecutive ejection (``backoff_initial_s`` ..
``backoff_max_s``); when it lapses the replica re-admits into
``degraded`` *probation*, where ``probation_successes`` consecutive
successes promote it to healthy and any error re-ejects with the next
backoff. Degraded replicas place only when every healthy one is
unavailable or busier by ``degraded_penalty``, EXCEPT that every
``probe_every``-th placement routes to a probationer when one exists —
the circuit-breaker half-open trickle through which a re-admitted
replica demonstrates recovery (the penalty alone would starve it of
exactly the traffic probation requires); an administrative
``draining`` state (hot-swap rotation, scale-down) takes no placement
at all and is not a health verdict.

Placement score is queue depth + in-flight work (``session.load()``,
the live reading behind the ``serve.queue_depth`` gauge) — least
loaded wins, FIFO tie-break. All transitions report through
``on_state_change`` so the fleet can count ejections, trigger flight
dumps and rebaseline the anomaly detectors; every method takes an
explicit ``now`` for deterministic tests.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.serve.batcher import ReplicaUnavailable

HEALTHY = "healthy"
DEGRADED = "degraded"
EJECTED = "ejected"
DRAINING = "draining"


@dataclasses.dataclass
class HealthPolicy:
    """Knobs of the replica health state machine (module docstring)."""

    window: int = 16                  # outcome window per replica
    min_outcomes: int = 4             # don't judge an empty window
    degrade_error_rate: float = 0.25
    eject_error_rate: float = 0.5
    recovery_idle_s: float = 5.0      # no errors this long -> healthy
    heartbeat_timeout_s: float = 2.0
    latency_degrade_ratio: float = 4.0
    latency_ewma_alpha: float = 0.2
    backoff_initial_s: float = 0.5
    backoff_max_s: float = 30.0
    probation_successes: int = 3
    degraded_penalty: float = 1e6     # added to a degraded score
    # every Nth placement routes to a probationer (circuit half-open):
    # without this, the degraded penalty would starve a re-admitted
    # replica of the traffic it needs to demonstrate recovery
    probe_every: int = 16

    def __post_init__(self):
        if not (0.0 < self.degrade_error_rate
                <= self.eject_error_rate <= 1.0):
            raise ValueError(
                "need 0 < degrade_error_rate <= eject_error_rate <= 1, "
                f"got {self.degrade_error_rate}/{self.eject_error_rate}")
        if self.backoff_initial_s <= 0 or self.backoff_max_s \
                < self.backoff_initial_s:
            raise ValueError(
                f"bad backoff range [{self.backoff_initial_s}, "
                f"{self.backoff_max_s}]")
        if int(self.window) < int(self.min_outcomes):
            raise ValueError(
                f"window {self.window} < min_outcomes "
                f"{self.min_outcomes} can never judge")


class ReplicaHandle:
    """Router-side record of one replica: the live session plus health
    accounting. ``session`` is duck-typed — anything with ``submit`` /
    ``load`` / ``idle`` / ``alive`` / ``heartbeat`` / ``close``
    (a :class:`~parallax_tpu_torch.serve.session.ServeSession`)."""

    def __init__(self, rid, session, policy: HealthPolicy):
        self.rid = rid
        self.session = session
        self.state = HEALTHY
        self.state_reason = "new"
        self.dead = False                  # permanent (session died)
        self.outcomes: collections.deque = collections.deque(
            maxlen=int(policy.window))     # True = success
        self.last_error_at: Optional[float] = None
        self.latency_ewma_ms: Optional[float] = None
        self.ejections = 0                 # consecutive (backoff base)
        self.reopen_at: Optional[float] = None
        self.probation_left = 0            # successes still owed
        self.placing = 0                   # placements not yet enqueued
        # model-variant multiplexing: which weight variant
        # this replica currently serves (None = the fleet's base
        # params). Placement with a ``require`` predicate filters on
        # it; set by ServeFleet.assign_variants via swap_params.
        self.variant: Optional[str] = None
        # (state, reason) before an administrative drain, restored by
        # set_draining(False) — rotation is not a health verdict either
        # way, so it must not launder DEGRADED/probation into HEALTHY
        self.predrain: Optional[Tuple[str, str]] = None

    def error_rate(self) -> Optional[float]:
        n = len(self.outcomes)
        if n == 0:
            return None
        return sum(1 for ok in self.outcomes if not ok) / n

    def placeable(self) -> bool:
        return self.state in (HEALTHY, DEGRADED) and not self.dead

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        rate = self.error_rate()
        now = time.perf_counter() if now is None else now
        return {"state": self.state, "reason": self.state_reason,
                "dead": self.dead, "variant": self.variant,
                "error_rate": round(rate, 3) if rate is not None else None,
                "latency_ewma_ms": (round(self.latency_ewma_ms, 3)
                                    if self.latency_ewma_ms is not None
                                    else None),
                "ejections": self.ejections,
                "load": self.session.load(),
                # circuit-breaker status: the incident dump
                # must show whether a replica can come back, when, and
                # what it still owes probation
                "circuit": {
                    "reopen_at": self.reopen_at,
                    "reopen_in_s": (round(self.reopen_at - now, 3)
                                    if self.reopen_at is not None
                                    else None),
                    "probation_left": self.probation_left,
                    "last_error_at": self.last_error_at,
                },
                "placing": self.placing,
                "heartbeat_age_s": round(
                    now - self.session.heartbeat, 4)}


class Router:
    """Placement + health state machine over :class:`ReplicaHandle`\\s."""

    def __init__(self, policy: Optional[HealthPolicy] = None,
                 on_state_change: Optional[Callable] = None):
        self.policy = policy or HealthPolicy()
        self._on_state_change = on_state_change
        self._lock = threading.Lock()
        self._handles: Dict[Any, ReplicaHandle] = {}
        self._rr = 0          # round-robin tie-break cursor
        self._placements = 0  # probe-cadence counter (probe_every)

    # -- membership --------------------------------------------------------

    def add(self, rid, session) -> ReplicaHandle:
        with self._lock:
            if rid in self._handles:
                raise ValueError(f"replica {rid!r} already routed")
            h = ReplicaHandle(rid, session, self.policy)
            self._handles[rid] = h
        return h

    def remove(self, rid) -> Optional[ReplicaHandle]:
        with self._lock:
            return self._handles.pop(rid, None)

    def handles(self) -> List[ReplicaHandle]:
        with self._lock:
            return list(self._handles.values())

    def get(self, rid) -> Optional[ReplicaHandle]:
        with self._lock:
            return self._handles.get(rid)

    def counts(self) -> Dict[str, int]:
        out = {HEALTHY: 0, DEGRADED: 0, EJECTED: 0, DRAINING: 0}
        for h in self.handles():
            out[h.state] += 1
        return out

    # -- placement ---------------------------------------------------------

    def place(self, exclude: Tuple = (),
              require: Optional[Callable[[ReplicaHandle], bool]] = None
              ) -> ReplicaHandle:
        """Pick the least-loaded trusted replica (healthy first,
        degraded with a large penalty). Every ``probe_every``-th
        placement instead routes to a PROBATIONER (a circuit-reopened
        replica still owing successes) when one exists — the half-open
        trickle that lets it demonstrate recovery; the penalty alone
        would starve it whenever any healthy replica has headroom.
        ``require`` further constrains the candidate set (the fleet's
        model-variant routing: only replicas serving the requested
        variant are eligible — probes included).
        Increments the handle's ``placing`` count — the caller MUST
        pair it with ``done_placing`` after the submit lands, so a
        drain can tell "idle" from "a placement is racing me". Raises
        :class:`ReplicaUnavailable` when no replica is placeable."""
        with self._lock:
            self._placements += 1
            if self._placements % max(1, int(self.policy.probe_every)) \
                    == 0:
                probes = [h for h in self._handles.values()
                          if h.rid not in exclude
                          and h.state == DEGRADED
                          and h.probation_left > 0
                          and h.session.alive
                          and (require is None or require(h))]
                if probes:
                    probe = min(probes, key=lambda h:
                                h.session.load() + h.placing)
                    probe.placing += 1
                    return probe
            best, best_score = None, None
            n = len(self._handles)
            order = list(self._handles.values())
            # rotate the scan start so exact ties round-robin
            order = order[self._rr % n:] + order[:self._rr % n] if n else []
            self._rr += 1
            for h in order:
                if h.rid in exclude or not h.placeable():
                    continue
                if not h.session.alive:
                    continue
                if require is not None and not require(h):
                    continue
                score = h.session.load() + h.placing
                if h.state == DEGRADED:
                    score += self.policy.degraded_penalty
                if best_score is None or score < best_score:
                    best, best_score = h, score
            if best is None:
                raise ReplicaUnavailable(
                    f"no serving replica available (states: "
                    f"{ {h.rid: h.state for h in self._handles.values()} }"
                    f", excluded: {list(exclude)}"
                    + (", with a placement constraint"
                       if require is not None else "") + ")")
            best.placing += 1
            return best

    def done_placing(self, handle: ReplicaHandle) -> None:
        with self._lock:
            handle.placing = max(0, handle.placing - 1)

    # -- probes ------------------------------------------------------------

    @staticmethod
    def _transition(h: ReplicaHandle, state: str, reason: str,
                    now: float, events: List[tuple]) -> None:
        """Caller holds the lock; accumulated events fire their
        callback OUTSIDE it (the fleet's handler touches
        metrics/flight/anomaly)."""
        old = h.state
        if old == state:
            return
        h.state = state
        h.state_reason = reason
        events.append((h, old, state, reason, now))

    def _with_events(self, fn):
        events: List[tuple] = []
        with self._lock:
            out = fn(events)
        for h, old, new, reason, now in events:
            parallax_log.warning(
                "router: replica %r %s -> %s (%s)", h.rid, old, new,
                reason)
            if self._on_state_change is not None:
                try:
                    self._on_state_change(h, old, new, reason)
                except Exception:
                    pass
        return out

    def _eject_locked(self, h: ReplicaHandle, reason: str, now: float,
                      events: List[tuple],
                      permanent: bool = False) -> None:
        h.ejections += 1
        h.outcomes.clear()
        h.probation_left = 0
        if permanent or not h.session.alive:
            h.dead = True
            h.reopen_at = None
        else:
            backoff = min(
                self.policy.backoff_max_s,
                self.policy.backoff_initial_s
                * (2.0 ** (h.ejections - 1)))
            h.reopen_at = now + backoff
            reason = f"{reason}; circuit open {backoff:.2f}s"
        self._transition(h, EJECTED, reason, now, events)

    def record_success(self, handle: ReplicaHandle,
                       latency_ms: Optional[float] = None,
                       now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        p = self.policy

        def fn(events):
            handle.outcomes.append(True)
            if latency_ms is not None:
                e = handle.latency_ewma_ms
                handle.latency_ewma_ms = (
                    latency_ms if e is None
                    else (1 - p.latency_ewma_alpha) * e
                    + p.latency_ewma_alpha * latency_ms)
            if handle.state == DEGRADED and handle.probation_left > 0:
                handle.probation_left -= 1
                if handle.probation_left == 0:
                    handle.ejections = 0  # clean bill: backoff resets
                    self._transition(handle, HEALTHY,
                                     "probation served", now, events)

        self._with_events(fn)

    def record_error(self, handle: ReplicaHandle, exc: BaseException,
                     now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        p = self.policy

        def fn(events):
            handle.outcomes.append(False)
            handle.last_error_at = now
            if handle.state == EJECTED:
                return
            if not handle.session.alive:
                self._eject_locked(handle, f"replica died: {exc}",
                                   now, events, permanent=True)
                return
            if handle.state == DEGRADED and handle.probation_left > 0:
                self._eject_locked(handle, "error during probation",
                                   now, events)
                return
            rate = handle.error_rate()
            if rate is None or len(handle.outcomes) < p.min_outcomes:
                return
            if rate >= p.eject_error_rate:
                self._eject_locked(
                    handle, f"error rate {rate:.2f} >= "
                    f"{p.eject_error_rate}", now, events)
            elif rate >= p.degrade_error_rate \
                    and handle.state == HEALTHY:
                self._transition(
                    handle, DEGRADED,
                    f"error rate {rate:.2f} >= "
                    f"{p.degrade_error_rate}", now, events)

        self._with_events(fn)

    def eject(self, rid, reason: str = "forced",
              permanent: bool = False,
              now: Optional[float] = None) -> None:
        """Administrative ejection (the fleet uses it for dead
        replicas and failed hot-swaps)."""
        now = time.perf_counter() if now is None else now

        def fn(events):
            h = self._handles.get(rid)
            if h is not None and h.state != EJECTED:
                self._eject_locked(h, reason, now, events,
                                   permanent=permanent)

        self._with_events(fn)

    def set_draining(self, rid, draining: bool,
                     now: Optional[float] = None) -> None:
        """Administrative rotation (hot-swap / scale-down): a draining
        replica takes no new placements; restoring re-enters the state
        it was rotated out of — a DEGRADED replica mid-probation comes
        back DEGRADED with its probation debt intact (rotation is not a
        health verdict, in either direction)."""
        now = time.perf_counter() if now is None else now

        def fn(events):
            h = self._handles.get(rid)
            if h is None:
                return
            if draining:
                if h.state != DRAINING:
                    h.predrain = (h.state, h.state_reason)
                self._transition(h, DRAINING, "rotation", now, events)
            elif h.state == DRAINING:
                state, reason = h.predrain or (HEALTHY, "")
                h.predrain = None
                if state == HEALTHY:
                    reason = "rotation complete"
                self._transition(h, state, reason, now, events)

        self._with_events(fn)

    def tick(self, now: Optional[float] = None) -> None:
        """Periodic probe pass: heartbeat staleness, latency-vs-fleet
        straggler check, circuit-breaker re-admission, idle recovery."""
        now = time.perf_counter() if now is None else now
        p = self.policy

        def fn(events):
            ewmas = sorted(h.latency_ewma_ms
                           for h in self._handles.values()
                           if h.latency_ewma_ms is not None)
            # lower-middle median: in a 2-replica fleet the straggler
            # must be judged against its sibling, not against itself
            median = ewmas[(len(ewmas) - 1) // 2] if ewmas else None
            for h in self._handles.values():
                if h.dead:
                    continue
                if not h.session.alive:
                    self._eject_locked(h, "session dead", now, events,
                                       permanent=True)
                    continue
                if h.state == EJECTED:
                    if h.reopen_at is not None and now >= h.reopen_at:
                        h.reopen_at = None
                        h.probation_left = p.probation_successes
                        h.outcomes.clear()
                        self._transition(
                            h, DEGRADED,
                            f"circuit reopen (probation "
                            f"{p.probation_successes})", now, events)
                    continue
                if h.state == DRAINING:
                    continue
                stale = now - h.session.heartbeat
                if stale > 3 * p.heartbeat_timeout_s:
                    self._eject_locked(
                        h, f"heartbeat stale {stale:.2f}s", now, events)
                    continue
                if stale > p.heartbeat_timeout_s:
                    if h.state == HEALTHY:
                        self._transition(
                            h, DEGRADED,
                            f"heartbeat stale {stale:.2f}s", now,
                            events)
                    continue
                if (median is not None and len(ewmas) >= 2
                        and h.latency_ewma_ms is not None
                        and h.latency_ewma_ms
                        > p.latency_degrade_ratio * median
                        and h.state == HEALTHY):
                    self._transition(
                        h, DEGRADED,
                        f"latency {h.latency_ewma_ms:.1f}ms > "
                        f"{p.latency_degrade_ratio}x fleet median "
                        f"{median:.1f}ms", now, events)
                    continue
                if (h.state == DEGRADED and h.probation_left == 0
                        and h.state_reason.startswith(
                            ("error rate", "heartbeat", "latency"))):
                    # recovery: the condition that degraded it cleared
                    rate = h.error_rate()
                    idle_ok = (h.last_error_at is None
                               or now - h.last_error_at
                               >= p.recovery_idle_s)
                    rate_ok = (rate is not None
                               and len(h.outcomes) >= p.min_outcomes
                               and rate < p.degrade_error_rate / 2)
                    lat_ok = (h.latency_ewma_ms is None
                              or median is None or len(ewmas) < 2
                              or h.latency_ewma_ms
                              <= p.latency_degrade_ratio * median)
                    if (rate_ok or idle_ok) and lat_ok \
                            and now - h.session.heartbeat \
                            <= p.heartbeat_timeout_s:
                        h.ejections = 0
                        self._transition(h, HEALTHY, "recovered", now,
                                         events)

        self._with_events(fn)


__all__ = ["Router", "ReplicaHandle", "HealthPolicy",
           "HEALTHY", "DEGRADED", "EJECTED", "DRAINING"]
