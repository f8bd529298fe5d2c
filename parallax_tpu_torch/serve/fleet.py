"""ServeFleet — N replicated serving engines behind a health-aware
router (``parallax_tpu/serve/fleet.py``).

One ``ServeSession`` is one point of failure: one stall, NaN or crash
takes down every user on it. The fleet is the layer that survives it:

* **replicas** — each a full :class:`ServeSession` (its own dispatch
  thread, queue, and captured graphs). A decode replica owns its own
  :class:`DecodeProgram` (a program serves one live session:
  serve/continuous.py), so the factory builds one per replica. The
  replicas may share one card: their dispatch threads replay their
  graphs side by side, and a replica added under traffic captures on
  its own thread while the others replay.
* **routing** (serve/router.py) — placement by load onto healthy
  replicas; heartbeat/error-rate/latency probes move replicas
  ``healthy -> degraded -> ejected`` with circuit-breaker re-admission
  on exponential backoff.
* **failover** — a replica death fails its accepted-but-unserved
  requests with the RETRYABLE :class:`ReplicaUnavailable`; the fleet
  transparently resubmits each onto a healthy replica within the
  ORIGINAL deadline. A request that delivered a result is never
  retried (delivery is exactly-once), so dispatched work is never
  double-served; a greedy-decode retry reproduces the same tokens
  because each slot's decode is independent of its neighbours.
* **hot-swap** — :meth:`ServeFleet.push_weights` rotates replicas out
  one at a time (drain -> ``swap_params`` in place -> re-admit), so
  every captured graph survives (``serve.recompiles`` stays 0 and no
  graph is captured again) and traffic keeps flowing through the rest
  of the fleet: the train -> serve continuous-deployment handoff
  (``ParallaxSession.push_weights(fleet)``).
* **autoscaling** — an optional loop scales up on sustained load and
  scales down via graceful drain (the ``RequestQueue`` drain
  semantics), reporting every deliberate scale event to an anomaly
  monitor's rebaseline path when one is attached.

``fleet.*`` metrics (replicas, replicas_healthy, failovers, retries,
hotswaps, ejections, drain_seconds, ...) land in the fleet's registry.
``flight``, ``anomaly`` and ``journal`` are optional duck-typed hooks
(a flight recorder's ``trigger`` / ``add_provider``, an anomaly
monitor's ``notify_deliberate_change``, a journal's ``emit``) that
replica incidents (crash, ejection, failed hot-swap) and scale events
report to. The chaos harness (serve/faults.py) injects crash / stall /
NaN / saturation deterministically.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.obs import _state as obs_state
from parallax_tpu_torch.obs import metrics as obs_metrics, reqtrace, trace
from parallax_tpu_torch.serve.batcher import (DeadlineExceeded,
                                        ReplicaUnavailable, ServeClosed,
                                        ServeError, ServeOverloaded)
from parallax_tpu_torch.serve.router import (DRAINING, EJECTED, HEALTHY,
                                       HealthPolicy, ReplicaHandle,
                                       Router)


@dataclasses.dataclass
class FleetConfig:
    """Fleet knobs.

    * ``num_replicas`` — replicas built at construction;
      ``min_replicas`` / ``max_replicas`` bound the autoscaler.
    * ``max_retries`` — additional attempts per request after its
      first placement (failover hops), always within the original
      deadline.
    * ``health`` — the router's :class:`HealthPolicy`.
    * ``check_outputs`` — replicas scan one-shot outputs for
      non-finite values and fail the batch retryably (the NaN fault's
      detection path). Costs one ``isfinite`` pass per batch.
    * ``tick_interval_s`` — maintenance cadence (health probes,
      circuit-breaker clock, autoscaler).
    * ``drain_timeout_s`` — per-replica quiesce bound for hot-swap
      rotation and scale-down drain.
    * ``autoscale`` + watermarks — scale up when mean per-replica load
      stays above ``autoscale_high_load`` for
      ``autoscale_sustain_ticks`` consecutive ticks; scale down below
      ``autoscale_low_load`` (never under ``min_replicas``).
    """

    num_replicas: int = 2
    min_replicas: int = 1
    max_replicas: int = 4
    max_retries: int = 2
    health: HealthPolicy = dataclasses.field(default_factory=HealthPolicy)
    check_outputs: bool = True
    tick_interval_s: float = 0.05
    drain_timeout_s: float = 30.0
    autoscale: bool = False
    autoscale_high_load: float = 4.0
    autoscale_low_load: float = 0.5
    autoscale_sustain_ticks: int = 3

    def __post_init__(self):
        if not (1 <= int(self.min_replicas) <= int(self.num_replicas)
                <= int(self.max_replicas)):
            raise ValueError(
                f"need 1 <= min_replicas <= num_replicas <= "
                f"max_replicas, got {self.min_replicas}/"
                f"{self.num_replicas}/{self.max_replicas}")
        if int(self.max_retries) < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if float(self.autoscale_low_load) \
                >= float(self.autoscale_high_load):
            raise ValueError(
                f"autoscale_low_load {self.autoscale_low_load} must be "
                f"< autoscale_high_load {self.autoscale_high_load}")


_freq_ids = itertools.count()


class FleetRequest:
    """The fleet-level future: same ``result()/done()/error()`` shape
    as a replica :class:`~parallax_tpu_torch.serve.batcher.Request` (a
    load generator drives a fleet unchanged), plus the failover
    trail: ``replicas`` lists every replica this request was placed
    on, in order — ``len(replicas) > 1`` means it failed over."""

    __slots__ = ("id", "feed", "deadline", "max_new_tokens",
                 "tenant", "slo_class", "variant",
                 "t_enqueue", "t_done", "t_first_token", "replicas",
                 "rec", "_event", "_result", "_error", "_lock")

    def __init__(self, feed, deadline: Optional[float],
                 max_new_tokens: Optional[int],
                 tenant=None, slo_class: Optional[str] = None,
                 variant: Optional[str] = None):
        self.id = next(_freq_ids)
        self.feed = feed
        self.deadline = deadline
        self.max_new_tokens = max_new_tokens
        # multi-tenant serving: the billing/namespace
        # tenant, the SLO class, and the model variant this request
        # must be served by (None = the base weights)
        self.tenant = tenant
        self.slo_class = slo_class
        self.variant = variant
        self.t_enqueue = time.perf_counter()
        self.t_done: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.replicas: List[Any] = []
        # the fleet-owned lifecycle record (obs/reqtrace.py): ONE
        # record across every failover hop, so the TTFT decomposition
        # covers the whole client-visible window; None when obs is off
        self.rec = None
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"fleet request {self.id} not done within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def error(self) -> Optional[BaseException]:
        return self._error if self._event.is_set() else None

    def latency_s(self) -> Optional[float]:
        return (None if self.t_done is None
                else self.t_done - self.t_enqueue)

    def _complete(self, result, t_first_token=None) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self.t_done = time.perf_counter()
            self.t_first_token = t_first_token
            self._result = result
            self._event.set()
        if self.rec is not None:
            # normally already finalized by the delivering replica's
            # Request._complete (same shared record) — idempotent
            self.rec.complete(self.t_done)

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self.t_done = time.perf_counter()
            self._error = exc
            self._event.set()
        if self.rec is not None:
            # idempotent: a sub-request terminal outcome (delivery,
            # deadline) may have finalized the shared record already
            self.rec.complete(
                self.t_done,
                outcome=("deadline_exceeded"
                         if isinstance(exc, DeadlineExceeded)
                         else f"failed:{type(exc).__name__}"))


class ServeFleet:
    """N serving replicas, one front door.

    ``make_replica(rid, **serve_kw)`` builds one replica and must
    forward ``serve_kw`` into the :class:`ServeSession` constructor —
    that is how the fleet wires per-replica metrics registries, its
    fault injector and its death/error callbacks without constraining
    what the factory serves (one-shot fn or decode program). A decode
    factory builds a fresh program per replica::

        def make_replica(rid, **serve_kw):
            prog = NMTDecodeProgram(cfg, max_src_len=64, page_size=16,
                                    pool_pages=512)
            return ServeSession(program=prog, params=params,
                                config=cfg, **serve_kw)

        fleet = ServeFleet(make_replica,
                           config=FleetConfig(num_replicas=2))
        req = fleet.submit({"src": tokens}, deadline_ms=200)
        out = req.result()
        fleet.push_weights(new_params)   # zero-downtime hot-swap
        fleet.close()
    """

    def __init__(self, make_replica: Callable, *,
                 config: Optional[FleetConfig] = None,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None,
                 flight=None, anomaly=None, faults=None,
                 journal=None):
        self._cfg = config or FleetConfig()
        self._make_replica = make_replica
        self.metrics = metrics if metrics is not None \
            else obs_metrics.MetricsRegistry()
        self._flight = flight
        self._anomaly = anomaly
        # run-event journal (obs/journal.py): fleet churn — replica
        # deaths, ejections, hot-swaps, scale events — lands in the
        # same causal record as the training/serving incidents
        self._journal = journal
        self.faults = faults
        self._router = Router(self._cfg.health,
                              on_state_change=self._on_state_change)
        self._rid = itertools.count()
        self._registries: Dict[Any, obs_metrics.MetricsRegistry] = {}
        # request forensics: the fleet-level lifecycle ring
        # (failed-over requests keep ONE record across hops) and the
        # in-flight table the correlated incident dump captures
        self.reqtrace = reqtrace.RequestTraceRing(self.metrics)
        self._inflight: Dict[Any, FleetRequest] = {}
        self._inflight_lock = threading.Lock()
        # the telemetry exporter (start_exporter), stopped at close
        self._exporter = None
        self._closed = False
        self._swap_lock = threading.Lock()
        self._scale_lock = threading.Lock()
        self._high_ticks = 0
        self._low_ticks = 0
        # the last checkpoint pushed through push_weights — kept so a
        # later scale-up swaps the newcomer onto the CURRENT weights
        # instead of whatever the factory closure captured
        self._pushed_params = None
        # model-variant multiplexing: variant name -> params (same
        # shapes as the base — swap_params' structural check is the
        # guard). Empty = a single-variant fleet.
        self._variants: Dict[str, Any] = {}
        # at most one in-flight autoscaler action (its drain or capture
        # must not stack, and must not run on the maintenance thread)
        self._autoscale_busy = False

        m = self.metrics
        self._requests = m.counter("fleet.requests")
        self._completed = m.counter("fleet.completed")
        self._failed = m.counter("fleet.failed")
        self._shed = m.counter("fleet.shed")
        self._timeouts = m.counter("fleet.timeouts")
        self._retries = m.counter("fleet.retries")
        self._failovers = m.counter("fleet.failovers")
        self._hotswaps = m.counter("fleet.hotswaps")
        self._hotswap_failures = m.counter("fleet.hotswap_failures")
        self._ejections = m.counter("fleet.ejections")
        self._scale_ups = m.counter("fleet.scale_ups")
        self._scale_downs = m.counter("fleet.scale_downs")
        self._drain_s = m.histogram("fleet.drain_seconds")
        self._latency = m.histogram("fleet.request_latency_ms")
        self._replicas_g = m.gauge("fleet.replicas")
        self._healthy_g = m.gauge("fleet.replicas_healthy")

        for _ in range(int(self._cfg.num_replicas)):
            self._add_replica()
        self._update_gauges()
        if self._flight is not None:
            # correlated incident dumps: every subsequent
            # flight artifact — whatever triggered it — carries the
            # fleet aggregates, the router's health + circuit-breaker
            # states, the live in-flight request table (with hop
            # trails) and the recent completed-request records, all in
            # ONE artifact stamped with a shared incident id
            self._flight.add_provider("fleet", self.stats)
            self._flight.add_provider("router", self._router_snapshot)
            self._flight.add_provider("requests_in_flight",
                                      self._inflight_snapshot)
            self._flight.add_provider(
                "request_records",
                lambda: self.reqtrace.records(last=64))

        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._maintenance_loop, name="parallax-fleet-tick",
            daemon=True)
        self._thread.start()

    # -- replica lifecycle -------------------------------------------------

    def _add_replica(self) -> ReplicaHandle:
        rid = next(self._rid)
        registry = obs_metrics.MetricsRegistry()
        t0 = time.perf_counter()
        session = self._make_replica(
            rid,
            metrics=registry,
            replica_id=rid,
            faults=self.faults,
            check_outputs=self._cfg.check_outputs,
            on_fatal=lambda exc, _rid=rid: self._on_replica_fatal(
                _rid, exc),
            on_error=lambda exc, n, _rid=rid: self._on_batch_error(
                _rid, exc, n),
            flight=self._flight)
        # under the swap lock: either the newcomer joins the router
        # BEFORE a concurrent push_weights snapshots its rotation set
        # (and gets rotated with everyone), or it joins after and is
        # caught up here from the stored checkpoint — a rotation that
        # interleaves with the slow factory build above can never
        # leave it serving the factory closure's stale weights
        with self._swap_lock:
            vname = None
            if self._variants:
                # multiplexed fleet: the newcomer serves the variant
                # with the fewest live replicas (capacity rebalances
                # toward starved variants on every scale-up)
                counts = {v: 0 for v in self._variants}
                for h in self._router.handles():
                    if not h.dead and h.variant in counts:
                        counts[h.variant] += 1
                vname = min(sorted(counts), key=lambda k: counts[k])
                session.swap_params(self._variants[vname])
            elif self._pushed_params is not None:
                session.swap_params(self._pushed_params)
            self._registries[rid] = registry
            handle = self._router.add(rid, session)
            handle.variant = vname
        dt = time.perf_counter() - t0
        self.metrics.histogram("fleet.replica_spinup_seconds").record(dt)
        parallax_log.info("fleet: replica %d up in %.2fs", rid, dt)
        return handle

    def replica_ids(self) -> List[Any]:
        return [h.rid for h in self._router.handles()]

    @property
    def num_replicas(self) -> int:
        return len(self._router.handles())

    def _update_gauges(self) -> None:
        counts = self._router.counts()
        self._replicas_g.set(sum(counts.values()))
        self._healthy_g.set(counts[HEALTHY])

    # -- incident callbacks (replica threads) ------------------------------

    def _on_replica_fatal(self, rid, exc: BaseException) -> None:
        """A replica's dispatch loop died. Its accepted-but-unserved
        requests were already failed with ReplicaUnavailable by the
        loop itself — their done-callbacks are failing over right now;
        here the fleet makes the death administrative: permanent
        ejection, counters, post-mortem."""
        parallax_log.error("fleet: replica %r died: %s", rid, exc)
        self._router.eject(rid, reason=f"fatal: {exc}", permanent=True)
        self._update_gauges()
        if self._journal is not None:
            self._journal.emit(
                "fleet", "replica_fatal", severity="error",
                replica=str(rid),
                error=f"{type(exc).__name__}: {exc}")
        if self._flight is not None:
            # by this point the dead replica's requests have already
            # been failed over (the scheduler's failure cascade runs
            # the done-callbacks synchronously before on_fatal), so
            # the affected set carries the post-failover hop trails
            self._flight.trigger(
                f"fleet_crash:replica_{rid}",
                {"replica": rid,
                 "error": f"{type(exc).__name__}: {exc}",
                 "affected_requests": self._affected_by(rid)})
        if self._anomaly is not None:
            # the failover surge is deliberate recovery, not a quiet
            # regression — rebaseline instead of firing a change-point
            self._anomaly.notify_deliberate_change(
                f"fleet replica {rid} crash/failover")

    def _on_batch_error(self, rid, exc: BaseException, n: int) -> None:
        """A replica batch failed (non-fatal) — visibility only. The
        router's error window is fed PER REQUEST in ``_on_sub_done``
        (matching per-request successes); recording the batch here too
        would count one failure n+1 times and eject a replica for a
        single transient batch."""
        self.metrics.counter("fleet.replica_batch_errors").inc()

    def _record_request_error(self, rid, exc: BaseException) -> None:
        """One request's failure into the router's error-rate window.
        Deadline expiries are shedding-by-contract, not replica faults
        — they never count against health."""
        if isinstance(exc, DeadlineExceeded):
            return
        h = self._router.get(rid)
        if h is not None:
            self._router.record_error(h, exc)
            self._update_gauges()

    def _on_state_change(self, handle: ReplicaHandle, old: str,
                         new: str, reason: str) -> None:
        self._update_gauges()
        if new == EJECTED:
            self._ejections.inc()
            if self._journal is not None:
                self._journal.emit(
                    "fleet", "ejection", severity="warning",
                    replica=str(handle.rid), from_state=old,
                    reason=reason)
            if self._flight is not None:
                self._flight.trigger(
                    f"fleet_ejection:replica_{handle.rid}",
                    {"replica": handle.rid, "from": old,
                     "reason": reason})
            if self._anomaly is not None:
                self._anomaly.notify_deliberate_change(
                    f"fleet replica {handle.rid} ejected: {reason}")

    # -- admission / dispatch ----------------------------------------------

    def submit(self, feed: Dict[str, Any],
               deadline_ms: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               tenant: Any = None,
               slo_class: Optional[str] = None,
               variant: Optional[str] = None,
               rec: Optional[reqtrace.RequestRecord] = None) -> FleetRequest:
        """Admit one request to the fleet; returns its
        :class:`FleetRequest` future. Sheds with ``ServeOverloaded``
        only when EVERY placeable replica sheds; raises
        ``ReplicaUnavailable`` when no replica is placeable at all.

        ``tenant`` / ``slo_class`` flow to the serving replica
        (admission quota, prefix-cache namespace, queue priority);
        ``variant`` constrains placement to replicas currently serving
        that model variant (:meth:`assign_variants`) — failover hops
        respect the same constraint, so a request never lands on the
        wrong weights. ``rec`` carries an EXISTING lifecycle record
        into this fleet (disaggregated serving: the record opened at
        the front door already holds the prefill + kv_transfer phases;
        this fleet's hops accumulate onto it instead of opening a
        fresh one)."""
        if self._closed:
            raise ServeClosed("fleet is closed")
        if variant is not None and variant not in self._variants:
            raise ValueError(
                f"unknown model variant {variant!r}; assigned: "
                f"{sorted(self._variants) or '(none)'}")
        if variant is None and self._variants:
            # symmetric with push_weights: on a multiplexed fleet an
            # unconstrained placement would be served by WHICHEVER
            # variant is least loaded — nondeterministic weights, not
            # load balancing
            raise ValueError(
                f"this fleet multiplexes variants "
                f"{sorted(self._variants)}; submit needs "
                f"variant=<name> so the request is served by the "
                f"weights it asked for")
        deadline = (time.perf_counter() + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        freq = FleetRequest(feed, deadline, max_new_tokens,
                            tenant=tenant, slo_class=slo_class,
                            variant=variant)
        if rec is not None:
            freq.rec = rec
            # a carried record means the request entered the SYSTEM
            # earlier (disaggregated front door): client-side
            # latency/TTFT must span the prefill + transfer phases
            # already spent, not restart at this pool's door
            freq.t_enqueue = rec.t0
        elif obs_state.enabled:
            freq.rec = reqtrace.RequestRecord(
                freq.id, t0=freq.t_enqueue, deadline=deadline,
                ring=self.reqtrace, fleet_owned=True)
        self._requests.inc()
        with self._inflight_lock:
            self._inflight[freq.id] = freq
        try:
            self._dispatch(freq, exclude=())
        except ServeOverloaded:
            self._shed.inc()
            self._untrack(freq, outcome="shed")
            raise
        except BaseException as e:
            # keep one label per SLO event class: a deadline spent
            # before placement is the same miss as one spent inside a
            # replica (batcher/FleetRequest._fail use the same label)
            self._untrack(freq, outcome=(
                "deadline_exceeded" if isinstance(e, DeadlineExceeded)
                else f"failed:{type(e).__name__}"))
            raise
        return freq

    # -- direct placement (the disaggregated prefill pool) -----------------

    def acquire_replica(self, exclude: Tuple = (),
                        require=None) -> ReplicaHandle:
        """Reserve one placeable replica for DIRECT (non-queued) work —
        the disaggregated prefill pool runs ``prefill_only`` on the
        caller's thread instead of going through :meth:`submit`. The
        handle counts as a racing placement until
        :meth:`release_replica` (hot-swap rotation waits on it); raises
        ``ReplicaUnavailable`` when nothing is placeable."""
        return self._router.place(tuple(exclude), require=require)

    def release_replica(self, handle: ReplicaHandle) -> None:
        """Release a :meth:`acquire_replica` reservation."""
        self._router.done_placing(handle)

    def record_replica_success(self, handle: ReplicaHandle,
                               latency_ms: float = 0.0) -> None:
        """Feed one direct-work success into the router's health
        probes (the same per-request accounting submit-path work
        gets)."""
        self._router.record_success(handle, latency_ms=latency_ms)

    def record_replica_error(self, handle: ReplicaHandle,
                             exc: BaseException) -> None:
        """Feed one direct-work failure into the router's error-rate
        window (deadline expiries excepted — shedding on time is the
        contract working)."""
        self._record_request_error(handle.rid, exc)

    def live_sessions(self) -> List[Tuple[Any, Any]]:
        """``(rid, session)`` for every live, non-ejected replica —
        the disaggregation layer's import-broadcast surface."""
        return [(h.rid, h.session) for h in self._router.handles()
                if not h.dead and h.state != EJECTED]

    def _untrack(self, freq: FleetRequest,
                 outcome: Optional[str] = None) -> None:
        """Drop a request from the in-flight table (terminal); with an
        ``outcome``, also finalize its record (synchronous admission
        failures never reach a sub-request's completion hook)."""
        with self._inflight_lock:
            self._inflight.pop(freq.id, None)
        if outcome is not None and freq.rec is not None:
            freq.rec.complete(outcome=outcome)

    def request_records(self, last: Optional[int] = None):
        """Snapshots of recently completed fleet request records."""
        return self.reqtrace.records(last)

    def _inflight_snapshot(self) -> List[Dict]:
        """The live request table: id, hop trail, deadline headroom and
        the lifecycle record so far — the incident dump's 'who was
        affected' section."""
        now = time.perf_counter()
        out = []
        with self._inflight_lock:
            freqs = list(self._inflight.values())
        for f in freqs:
            row = (f.rec.snapshot() if f.rec is not None
                   else {"id": f.id})
            row["hops"] = list(f.replicas)
            row["deadline_remaining_ms"] = (
                round((f.deadline - now) * 1e3, 3)
                if f.deadline is not None else None)
            out.append(row)
        return out

    def _router_snapshot(self) -> List[Dict]:
        now = time.perf_counter()
        return [dict(h.snapshot(now), rid=h.rid)
                for h in self._router.handles()]

    def _affected_by(self, rid) -> List[Dict]:
        """Every request whose hop trail touches replica ``rid`` —
        still in flight (failing over right now) or recently completed
        (the retry may already have landed by dump time)."""
        out: Dict[Any, List] = {}
        with self._inflight_lock:
            freqs = list(self._inflight.values())
        for f in freqs:
            if rid in f.replicas:
                out[f.id] = list(f.replicas)
        for r in self.reqtrace.records():
            if rid in (r.get("hops") or ()):
                out.setdefault(r["id"], list(r["hops"]))
        return [{"id": k, "hops": v}
                for k, v in sorted(out.items(), key=lambda kv: str(kv[0]))]

    def _remaining_ms(self, freq: FleetRequest) -> Optional[float]:
        if freq.deadline is None:
            return None
        return (freq.deadline - time.perf_counter()) * 1e3

    def _dispatch(self, freq: FleetRequest, exclude: Tuple) -> None:
        """Place ``freq`` on one replica, spilling across replicas on
        admission-time refusals. Raises when no replica accepts."""
        exclude = tuple(exclude)
        any_shed = False
        require = (None if freq.variant is None
                   else (lambda h, v=freq.variant: h.variant == v))
        while True:
            remaining = self._remaining_ms(freq)
            if remaining is not None and remaining <= 0:
                raise DeadlineExceeded(
                    f"fleet request {freq.id} deadline expired before "
                    f"placement")
            try:
                handle = self._router.place(exclude, require=require)
            except ReplicaUnavailable:
                if any_shed:
                    raise ServeOverloaded(
                        "every serving replica shed this request")
                raise
            try:
                sub = handle.session.submit(
                    freq.feed, deadline_ms=remaining,
                    max_new_tokens=freq.max_new_tokens, rec=freq.rec,
                    tenant=freq.tenant, slo_class=freq.slo_class)
            except ServeError as e:
                exclude = exclude + (handle.rid,)
                any_shed = any_shed or isinstance(e, ServeOverloaded)
                continue
            finally:
                self._router.done_placing(handle)
            freq.replicas.append(handle.rid)
            sub.add_done_callback(
                lambda sub_req, h=handle, f=freq:
                self._on_sub_done(f, h, sub_req))
            return

    def _on_sub_done(self, freq: FleetRequest, handle: ReplicaHandle,
                     sub) -> None:
        """One replica attempt finished (runs on that replica's
        dispatch thread). Success completes the fleet future —
        delivery is exactly-once, so a delivered request is never
        retried and dispatched work is never double-served. A
        RETRYABLE failure within the original deadline fails over to
        another replica; everything else fails the future."""
        err = sub.error()
        if err is None:
            self._router.record_success(
                handle, latency_ms=(sub.latency_s() or 0.0) * 1e3)
            freq._complete(sub._result,
                           t_first_token=sub.t_first_token)
            self._completed.inc()
            self._latency.record(
                (time.perf_counter() - freq.t_enqueue) * 1e3)
            self._untrack(freq)
            return
        if isinstance(err, DeadlineExceeded):
            # shedding on time is the deadline contract working, not a
            # replica fault — and the budget is spent: no retry
            self._timeouts.inc()
            freq._fail(err)
            self._untrack(freq)
            return
        self._record_request_error(handle.rid, err)
        retryable = bool(getattr(err, "retryable", False))
        remaining = self._remaining_ms(freq)
        hops = len(freq.replicas) - 1
        if (self._closed or not retryable
                or hops >= int(self._cfg.max_retries)
                or (remaining is not None and remaining <= 0)):
            self._failed.inc()
            freq._fail(err)
            self._untrack(freq)
            return
        self._retries.inc()
        if freq.rec is not None:
            # the gap from this failure to the next placement is the
            # failover phase of the request timeline
            freq.rec.mark("failover")
            freq.rec.note_retry()
        if isinstance(err, ReplicaUnavailable):
            self._failovers.inc()
        parallax_log.warning(
            "fleet: request %d failing over from replica %r "
            "(attempt %d): %s", freq.id, handle.rid, hops + 2, err)
        try:
            # exclude only the replica that just failed — it may be
            # the ONLY sibling of the next failure
            self._dispatch(freq, exclude=(handle.rid,))
        except Exception as e:
            self._failed.inc()
            freq._fail(e)
            self._untrack(freq)

    # -- hot-swap (zero-downtime weight push) ------------------------------

    def push_weights(self, params,
                     drain_timeout_s: Optional[float] = None,
                     variant: Optional[str] = None) -> Dict:
        """Rotate every live replica through drain -> ``swap_params``
        -> re-admit, one at a time, so the rest of the fleet keeps
        serving throughout (zero downtime with >= 2 replicas; a
        1-replica fleet has a drain-long placement gap, surfaced to
        callers as retryable ``ReplicaUnavailable``).

        The swap copies into each replica's own leaves in place, so
        every captured graph stays valid — ``serve.recompiles`` stays 0
        and no graph is captured again on any replica. A replica that fails to
        quiesce or to swap is PERMANENTLY ejected (re-admitting it
        would serve stale weights — version skew is worse than lost
        capacity) with a ``fleet_hotswap`` flight dump; the rotation
        continues, and the failure set is raised at the end.

        On a variant-multiplexed fleet (:meth:`assign_variants`),
        ``variant`` names WHICH variant these weights update and the
        rotation touches only its replicas; pushing without a name is
        refused there (silently overwriting every variant with one
        checkpoint would be weight corruption, not an upgrade).

        Returns ``{rid: "swapped" | "skipped (<state>)"}``.
        """
        timeout = (drain_timeout_s if drain_timeout_s is not None
                   else self._cfg.drain_timeout_s)
        if self._anomaly is not None:
            self._anomaly.notify_deliberate_change("fleet hot-swap")
        outcome: Dict[Any, str] = {}
        failures: Dict[Any, str] = {}
        with self._swap_lock:
            if self._variants and variant is None:
                raise ValueError(
                    f"this fleet multiplexes variants "
                    f"{sorted(self._variants)}; push_weights needs "
                    f"variant=<name> so only that variant's replicas "
                    f"rotate")
            if variant is not None:
                if variant not in self._variants:
                    raise ValueError(
                        f"unknown model variant {variant!r}; "
                        f"assigned: {sorted(self._variants) or '(none)'}")
                self._variants[variant] = params
            else:
                # future scale-ups must come up on THESE weights, not
                # on whatever the replica factory's closure captured
                self._pushed_params = params
            for h in self._router.handles():
                if variant is not None and h.variant != variant:
                    outcome[h.rid] = "skipped (other variant)"
                    continue
                if h.dead or h.state == EJECTED:
                    outcome[h.rid] = f"skipped ({h.state})"
                    continue
                t0 = time.perf_counter()
                self._router.set_draining(h.rid, True)
                quiesced = self._wait_idle(h, timeout)
                self._drain_s.record(time.perf_counter() - t0)
                if not quiesced:
                    msg = (f"replica {h.rid} did not quiesce within "
                           f"{timeout}s")
                    self._hotswap_fail(h, msg)
                    outcome[h.rid] = failures[h.rid] = msg
                    continue
                try:
                    with trace.span("fleet.hotswap", rid=h.rid):
                        h.session.swap_params(params)
                except Exception as e:
                    msg = (f"swap failed on replica {h.rid}: "
                           f"{type(e).__name__}: {e}")
                    self._hotswap_fail(h, msg)
                    outcome[h.rid] = failures[h.rid] = msg
                    continue
                self._router.set_draining(h.rid, False)
                self._hotswaps.inc()
                outcome[h.rid] = "swapped"
                parallax_log.info(
                    "fleet: hot-swapped weights on replica %r "
                    "(drained in %.3fs)", h.rid,
                    time.perf_counter() - t0)
        self._update_gauges()
        if self._journal is not None:
            self._journal.emit(
                "fleet", "hotswap",
                severity="error" if failures else "info",
                swapped=sum(1 for v in outcome.values()
                            if v == "swapped"),
                failed=len(failures),
                variant=variant)
        if failures:
            raise RuntimeError(
                f"hot-swap failed on {len(failures)} replica(s): "
                f"{failures} — they are ejected (stale weights must "
                f"not rejoin); scale up to restore capacity")
        return outcome

    def assign_variants(self, variants: Dict[str, Any],
                        drain_timeout_s: Optional[float] = None) -> Dict:
        """Multiplex N model VARIANTS on one fleet: each
        live replica is rotated (drain -> ``swap_params`` -> re-admit,
        the push_weights discipline) onto one variant's weights,
        round-robin over the sorted variant names, and tagged so
        ``submit(variant=...)`` routes only to matching replicas —
        failover included. Same-shape weights ride the hot-swap
        machinery, so the whole assignment captures nothing.

        With fewer live replicas than variants the excess variants are
        unplaceable until a scale-up (which picks the starved variant
        first) — reported loudly, not hidden. Returns
        ``{rid: variant | "<failure>"}``.
        """
        if not variants:
            raise ValueError("assign_variants needs >= 1 variant")
        timeout = (drain_timeout_s if drain_timeout_s is not None
                   else self._cfg.drain_timeout_s)
        if self._anomaly is not None:
            self._anomaly.notify_deliberate_change(
                "fleet variant assignment")
        names = sorted(variants)
        outcome: Dict[Any, str] = {}
        failures: Dict[Any, str] = {}
        with self._swap_lock:
            self._variants = dict(variants)
            self._pushed_params = None
            live = [h for h in self._router.handles()
                    if not h.dead and h.state != EJECTED]
            if len(live) < len(names):
                parallax_log.warning(
                    "fleet: %d variant(s) over %d live replica(s) — "
                    "variant(s) %s have no replica until a scale-up",
                    len(names), len(live),
                    [v for i, v in enumerate(names) if i >= len(live)])
            for i, h in enumerate(live):
                vname = names[i % len(names)]
                t0 = time.perf_counter()
                self._router.set_draining(h.rid, True)
                quiesced = self._wait_idle(h, timeout)
                self._drain_s.record(time.perf_counter() - t0)
                if not quiesced:
                    msg = (f"replica {h.rid} did not quiesce within "
                           f"{timeout}s")
                    self._hotswap_fail(h, msg)
                    outcome[h.rid] = failures[h.rid] = msg
                    continue
                try:
                    with trace.span("fleet.assign_variant", rid=h.rid,
                                    variant=vname):
                        h.session.swap_params(variants[vname])
                except Exception as e:
                    msg = (f"variant swap failed on replica {h.rid}: "
                           f"{type(e).__name__}: {e}")
                    self._hotswap_fail(h, msg)
                    outcome[h.rid] = failures[h.rid] = msg
                    continue
                h.variant = vname
                self._router.set_draining(h.rid, False)
                self._hotswaps.inc()
                outcome[h.rid] = vname
        self.metrics.gauge("fleet.variants").set(len(names))
        self._update_gauges()
        if failures:
            raise RuntimeError(
                f"variant assignment failed on {len(failures)} "
                f"replica(s): {failures} — they are ejected; scale up "
                f"to restore capacity")
        return outcome

    def variant_map(self) -> Dict[Any, Optional[str]]:
        """``{rid: variant}`` for every routed replica (None = base)."""
        return {h.rid: h.variant for h in self._router.handles()}

    def _hotswap_fail(self, handle: ReplicaHandle, msg: str) -> None:
        self._hotswap_failures.inc()
        parallax_log.error("fleet: %s", msg)
        self._router.eject(handle.rid, reason=msg, permanent=True)
        if self._flight is not None:
            self._flight.trigger(
                f"fleet_hotswap:replica_{handle.rid}",
                {"replica": handle.rid, "error": msg})

    def _wait_idle(self, handle: ReplicaHandle, timeout: float) -> bool:
        """Wait for the replica to quiesce: no racing placement
        (``handle.placing``), nothing queued, nothing in flight."""
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            if handle.placing == 0 and handle.session.idle():
                return True
            time.sleep(0.002)
        return False

    # -- autoscaling -------------------------------------------------------

    def scale_up(self, reason: str = "manual") -> Optional[Any]:
        """Add one replica (bounded by ``max_replicas``); returns its
        id or None at the bound."""
        with self._scale_lock:
            if self._closed or self.num_replicas \
                    >= int(self._cfg.max_replicas):
                return None
            handle = self._add_replica()
        self._scale_ups.inc()
        self._update_gauges()
        parallax_log.info("fleet: scaled UP to %d replicas (%s)",
                          self.num_replicas, reason)
        if self._journal is not None:
            self._journal.emit("fleet", "scale_up",
                               replicas=self.num_replicas,
                               reason=reason)
        if self._anomaly is not None:
            self._anomaly.notify_deliberate_change(
                f"fleet scale-up ({reason})")
        return handle.rid

    def scale_down(self, rid=None, reason: str = "manual",
                   drain_timeout_s: Optional[float] = None) -> bool:
        """Remove one replica via graceful drain: rotate it out of
        placement, let its accepted queue serve to completion
        (``RequestQueue`` drain semantics via ``session.close``),
        then drop it. Never goes under ``min_replicas``."""
        timeout = (drain_timeout_s if drain_timeout_s is not None
                   else self._cfg.drain_timeout_s)
        # _swap_lock too (always after _scale_lock, the order
        # _add_replica established): a push_weights rotation holds it
        # while a replica is DRAINING mid-swap, and closing that
        # replica under it would hand swap_params a dead session
        with self._scale_lock, self._swap_lock:
            live = [h for h in self._router.handles() if not h.dead]
            if len(live) <= int(self._cfg.min_replicas):
                return False
            if rid is None:
                # least-loaded placeable replica drains cheapest
                cands = [h for h in live
                         if h.state not in (EJECTED, DRAINING)]
                if not cands:
                    return False
                h = min(cands, key=lambda h: h.session.load())
            else:
                h = self._router.get(rid)
                if h is None:
                    return False
            t0 = time.perf_counter()
            self._router.set_draining(h.rid, True)
            self._wait_idle(h, timeout)
            try:
                h.session.close(drain=True)
            except Exception as e:
                parallax_log.warning(
                    "fleet: scale-down close of replica %r failed: %s",
                    h.rid, e)
            self._drain_s.record(time.perf_counter() - t0)
            self._router.remove(h.rid)
            self._registries.pop(h.rid, None)
        self._scale_downs.inc()
        self._update_gauges()
        parallax_log.info("fleet: scaled DOWN to %d replicas (%s)",
                          self.num_replicas, reason)
        if self._journal is not None:
            self._journal.emit("fleet", "scale_down",
                               replicas=self.num_replicas,
                               reason=reason)
        if self._anomaly is not None:
            self._anomaly.notify_deliberate_change(
                f"fleet scale-down ({reason})")
        return True

    def _spawn_scale_action(self, fn, *args, **kw) -> None:
        """Run one scale action OFF the maintenance thread: a
        scale-down drains for up to ``drain_timeout_s`` and a cold
        scale-up captures — neither may freeze the health probes
        and circuit-breaker clock while it happens. At most one
        autoscaler action is in flight at a time."""
        self._autoscale_busy = True

        def run():
            try:
                fn(*args, **kw)
            except Exception as e:
                parallax_log.warning("fleet autoscale action failed: "
                                     "%s", e)
            finally:
                self._autoscale_busy = False

        threading.Thread(target=run, name="parallax-fleet-scale",
                         daemon=True).start()

    def _autoscale_tick(self) -> None:
        """One autoscaler decision: sustained mean load per placeable
        replica against the watermarks (called from the maintenance
        loop; callable directly — and deterministically — in tests).
        The decision is made here; the action itself runs on its own
        thread (see ``_spawn_scale_action``)."""
        cfg = self._cfg
        if self._autoscale_busy:
            return
        placeable = [h for h in self._router.handles()
                     if h.placeable() and h.session.alive]
        if not placeable:
            return
        mean_load = sum(h.session.load() for h in placeable) \
            / len(placeable)
        self.metrics.gauge("fleet.mean_load").set(round(mean_load, 3))
        if mean_load >= cfg.autoscale_high_load:
            self._high_ticks += 1
            self._low_ticks = 0
            if self._high_ticks >= int(cfg.autoscale_sustain_ticks):
                self._high_ticks = 0
                self._spawn_scale_action(
                    self.scale_up,
                    reason=f"sustained load {mean_load:.1f}")
        elif mean_load <= cfg.autoscale_low_load:
            self._low_ticks += 1
            self._high_ticks = 0
            if self._low_ticks >= int(cfg.autoscale_sustain_ticks):
                self._low_ticks = 0
                self._spawn_scale_action(
                    self.scale_down,
                    reason=f"idle load {mean_load:.1f}")
        else:
            self._high_ticks = self._low_ticks = 0

    # -- maintenance -------------------------------------------------------

    def _tick(self, now: Optional[float] = None) -> None:
        """One maintenance pass: health probes + circuit-breaker clock
        (+ autoscaler when enabled). Tests drive this directly with an
        explicit ``now``."""
        self._router.tick(now)
        self._update_gauges()
        if self._cfg.autoscale:
            self._autoscale_tick()

    def _maintenance_loop(self) -> None:
        while not self._stop.wait(self._cfg.tick_interval_s):
            try:
                self._tick()
            except Exception as e:
                # the control plane must never take the data plane down
                parallax_log.warning("fleet tick failed: %s", e)

    # -- introspection / teardown ------------------------------------------

    def start_exporter(self, port: int = 0, alerts_fn=None):
        """Serve the fleet's live telemetry (the fleet's aggregates AND
        every replica's ``serve.*`` registry, ``source``-labelled) as
        Prometheus text on ``127.0.0.1`` (port 0: the OS picks one).
        ``alerts_fn`` (an ``AlertEngine.prometheus_alerts``) adds the
        ``parallax_alerts`` section. Returns the running
        :class:`~parallax_tpu_torch.obs.export.TelemetryExporter`
        (``.url``); stopped at :meth:`close`."""
        from parallax_tpu_torch.obs.export import TelemetryExporter

        if self._exporter is not None:
            # never leak a bound port and its thread on a second call
            self._exporter.stop()

        def snapshot():
            out = {"fleet": self.metrics.snapshot()}
            for rid, reg in list(self._registries.items()):
                out[f"replica{rid}"] = reg.snapshot()
            return out

        self._exporter = TelemetryExporter(snapshot, port=port,
                                           alerts_fn=alerts_fn)
        return self._exporter.start()

    def recompiles(self) -> int:
        """Total serve-time captures (dispatches that missed the
        captured signature set) across every live replica — the
        fleet-wide zero-recompile invariant."""
        # snapshot: the autoscaler thread mutates the dict live
        return sum(int(reg.snapshot().get("serve.recompiles", 0))
                   for reg in list(self._registries.values()))

    def stats(self) -> Dict[str, Any]:
        """JSON-ready fleet snapshot: every ``fleet.*`` metric plus a
        per-replica section (state, health accounting, ``serve.*``)."""
        out = {k: v for k, v in self.metrics.snapshot().items()
               if k.startswith("fleet.")}
        regs = dict(self._registries)  # autoscaler mutates it live
        out["replicas"] = {
            str(h.rid): dict(h.snapshot(),
                             serve={k: v for k, v in
                                    regs[h.rid].snapshot().items()
                                    if k.startswith("serve.")}
                             if h.rid in regs else {})
            for h in self._router.handles()}
        return out

    def close(self, drain: bool = True) -> None:
        """Stop the maintenance loop, close every replica (with drain
        by default — accepted requests complete), idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._thread.join(timeout=10.0)
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None
        for h in self._router.handles():
            try:
                h.session.close(drain=drain)
            except Exception as e:
                parallax_log.warning(
                    "fleet: close of replica %r failed: %s", h.rid, e)

    def __enter__(self) -> "ServeFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["ServeFleet", "FleetConfig", "FleetRequest"]
