"""Request futures, the serve error taxonomy, the admission queue and
the one-shot micro-batcher.

Clients submit single-request feeds. The continuous-decode scheduler
pops them one at a time into decode slots; the one-shot micro-batcher
fuses them into device batches under two bounds — ``max_batch`` (a
full batch dispatches at once) and ``max_wait_ms`` (a partial batch
dispatches once its OLDEST request has waited that long). Admission
control keeps the system stable under overload:

* a bounded queue (``max_queue``) — a submit beyond it is SHED with
  :class:`ServeOverloaded` raised synchronously to the caller, so
  overload produces fast failures instead of unbounded queueing delay;
* per-request deadlines — a request whose deadline expires while it
  waits is dropped (:class:`DeadlineExceeded` delivered through its
  future) rather than computed for a caller who already gave up;
* per-tenant quotas and SLO-class priorities (``ServeConfig``).

Batches are formed per *group key* (the padded example signature the
session computes at submit time): requests in one device batch share a
shape signature, and the group of the oldest waiting request forms
first, so no signature starves.

``close()`` stops admission; the already-accepted queue stays
servable until the session's drain window ends (partial batches
dispatch at once while draining).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.obs import trace


class ServeError(RuntimeError):
    """Base class of serving-layer request failures.

    Two class attributes declare the transient-vs-permanent taxonomy
    ON the exception, so retry logic reads a declared
    property instead of pattern-matching type names:

    * ``retryable`` — another attempt (later, or on another replica,
      within the original deadline) may succeed.
    * ``fatal`` — the replica that raised it is DEAD: the serving loop
      that observes it stops, fails everything it holds with
      :class:`ReplicaUnavailable`, and reports ``on_fatal`` so a fleet
      can eject the replica and fail work over.
    """

    retryable = False
    fatal = False


class ServeOverloaded(ServeError):
    """Admission control shed this request (queue at ``max_queue``).

    Transient: the queue is full NOW — a different replica (or a later
    retry) may have headroom."""

    retryable = True


class TenantQuotaExceeded(ServeOverloaded):
    """Admission control shed this request because its TENANT is at
    its admission quota: the tenant already has its full
    allowance of admitted-but-unfinished requests on this replica.

    A subclass of :class:`ServeOverloaded` (same retryable taxonomy —
    another replica may have quota headroom for this tenant), so every
    existing shed-handling path treats it correctly; the distinct type
    and the ``serve.tenant_shed`` counter make quota pressure visible
    separately from global queue pressure. The quota is also the
    anti-starvation guarantee in the other direction: a noisy tenant
    is capped at its own allowance, so it cannot consume the queue
    capacity other tenants' quotas entitle them to."""


class DeadlineExceeded(ServeError):
    """The request's deadline expired before it was served.

    Permanent: the budget is spent — retrying elsewhere cannot unmiss
    a deadline."""

    retryable = False


class ServeClosed(ServeError):
    """The session closed before this request could be served.

    Permanent for the session the caller submitted to (the fleet maps
    a replica-side close into :class:`ReplicaUnavailable` instead)."""

    retryable = False


class ReplicaUnavailable(ServeError):
    """The replica holding this request died or was ejected before
    completing it (crash, non-finite output, forced ejection).

    Transient at the fleet tier: the request was accepted but never
    served — nothing was delivered, so a retry on a healthy replica
    cannot double-serve it."""

    retryable = True


_req_ids = itertools.count()


class Request:
    """One submitted request: the feed plus a future for its result.

    ``result()`` blocks until the serving loop completes or fails the
    request (re-raising the failure); ``done()`` never blocks. Times
    are ``time.perf_counter()`` seconds: ``t_enqueue`` at submit,
    ``deadline`` absolute (None = no deadline), ``t_done`` when the
    result (or failure) landed.

    ``rec`` is the request's lifecycle record
    (:class:`~parallax_tpu_torch.obs.reqtrace.RequestRecord`, attached by the
    owning session; None with the obs layer disabled). Terminal
    transitions finalize it here — the single completion point —
    so every path (delivery, batch failure, deadline expiry in queue, at
    dispatch or mid-decode, replica death, close) lands in the request
    timeline without each call site having to remember to.
    """

    __slots__ = ("id", "feed", "deadline", "group_key", "max_new_tokens",
                 "tenant", "slo_rank", "t_enqueue", "t_done",
                 "t_first_token", "rec", "_event", "_result", "_error",
                 "_callbacks")

    def __init__(self, feed: Dict[str, Any],
                 deadline: Optional[float] = None,
                 group_key: Any = None,
                 max_new_tokens: Optional[int] = None,
                 tenant: Any = None,
                 slo_rank: int = 0):
        self.id = next(_req_ids)
        self.feed = feed
        self.deadline = deadline
        self.group_key = group_key
        self.max_new_tokens = max_new_tokens
        # multi-tenant admission: the tenant this request
        # bills against (None = the anonymous default tenant) and its
        # SLO-class priority rank (LOWER serves first; requests of one
        # rank stay FIFO among themselves)
        self.tenant = tenant
        self.slo_rank = int(slo_rank)
        self.t_enqueue = time.perf_counter()
        self.t_done: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.rec = None
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._callbacks: List[Callable] = []

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.id} not done within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def error(self) -> Optional[BaseException]:
        """The failure, if the request failed (non-blocking)."""
        return self._error if self._event.is_set() else None

    def latency_s(self) -> Optional[float]:
        return (None if self.t_done is None
                else self.t_done - self.t_enqueue)

    def add_done_callback(self, fn: Callable[["Request"], None]) -> None:
        """``fn(request)`` runs exactly once when the request completes
        or fails — immediately (on the calling thread) if it already
        did, else on whichever thread delivers the outcome. The fleet
        chains sub-request outcomes to its own futures through this
        instead of a watcher thread per request. Callback
        exceptions are swallowed (a broken observer must not fail the
        serving loop)."""
        self._callbacks.append(fn)
        if self._event.is_set():
            self._drain_callbacks()

    def _drain_callbacks(self) -> None:
        # list.pop is atomic under the GIL: however many threads race
        # here, each callback is popped (and therefore invoked) once
        while True:
            try:
                fn = self._callbacks.pop(0)
            except IndexError:
                return
            try:
                fn(self)
            except Exception:
                pass

    def _complete(self, result) -> None:
        self.t_done = time.perf_counter()
        if self.rec is not None:
            # finalized BEFORE the event fires: a fleet done-callback
            # reading the record sees the completed decomposition
            self.rec.complete(self.t_done)
        self._result = result
        self._event.set()
        self._drain_callbacks()

    def _fail(self, exc: BaseException) -> None:
        self.t_done = time.perf_counter()
        if self.rec is not None:
            if isinstance(exc, DeadlineExceeded):
                # a spent budget is final at every tier — no retry can
                # unmiss a deadline, so the record closes here
                self.rec.complete(self.t_done,
                                  outcome="deadline_exceeded")
            else:
                # a fleet-owned record stays open for failover; a
                # standalone one finalizes with the failure class
                self.rec.attempt_failed(type(exc).__name__, self.t_done)
        self._error = exc
        self._event.set()
        self._drain_callbacks()


class RequestQueue:
    """Bounded FIFO with deadline shedding, tenant quotas, SLO-class
    priority and group-aware batch formation; shared by the one-shot
    micro-batcher and the continuous-decode scheduler."""

    def __init__(self, max_queue: int, metrics=None, on_timeout=None,
                 tenant_quotas: Optional[Dict[Any, int]] = None,
                 default_tenant_quota: Optional[int] = None):
        self.max_queue = int(max_queue)
        self._items: List[Request] = []
        self._cond = threading.Condition()
        self._closed = False
        self._metrics = metrics
        self._depth = (metrics.gauge("serve.queue_depth")
                       if metrics is not None else None)
        self._timeouts = (metrics.counter("serve.timeouts")
                          if metrics is not None else None)
        self._shed = (metrics.counter("serve.shed")
                      if metrics is not None else None)
        # per-tenant admission quotas: a tenant's count of
        # admitted-but-unfinished requests (queued OR in service) is
        # capped at its quota; the count releases when the request
        # completes/fails, via its done-callback. None = unlimited.
        self._tenant_quotas = dict(tenant_quotas or {})
        self._default_quota = (None if default_tenant_quota is None
                               else int(default_tenant_quota))
        self._tenant_outstanding: Dict[Any, int] = {}
        self._tenant_shed = (metrics.counter("serve.tenant_shed")
                             if metrics is not None else None)
        # latched once any request with a nonzero SLO rank is admitted:
        # rank-free sessions (the overwhelming default) keep pop() at
        # the old O(1) head-pop instead of paying a priority scan
        self._ranked_ever = False
        # ``on_timeout(n)``: the SLO-breach hook (the serve session points
        # it at its flight recorder). Expiries are detected under the
        # queue lock but reported OUTSIDE it (_report_expired): the hook
        # may do file I/O and must not stall producers or consumers.
        self._on_timeout = on_timeout
        self._expired_unreported = 0

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    @property
    def closed(self) -> bool:
        return self._closed

    def _set_depth_locked(self) -> None:
        if self._depth is not None:
            self._depth.set(len(self._items))

    def _quota_of(self, tenant) -> Optional[int]:
        return self._tenant_quotas.get(tenant, self._default_quota)

    def tenant_outstanding(self, tenant) -> int:
        with self._cond:
            return self._tenant_outstanding.get(tenant, 0)

    def _release_tenant(self, req: Request) -> None:
        with self._cond:
            n = self._tenant_outstanding.get(req.tenant, 0) - 1
            if n <= 0:
                self._tenant_outstanding.pop(req.tenant, None)
            else:
                self._tenant_outstanding[req.tenant] = n

    def put(self, req: Request) -> None:
        """Admit one request; raises :class:`ServeOverloaded` (counted
        as ``serve.shed``) when the queue is at ``max_queue``,
        :class:`TenantQuotaExceeded` (counted as ``serve.shed`` AND
        ``serve.tenant_shed``) when the request's tenant is at its
        admission quota, and :class:`ServeClosed` after ``close()``."""
        with self._cond:
            if self._closed:
                raise ServeClosed("serve session is closed to new "
                                  "requests")
            if len(self._items) >= self.max_queue:
                if self._shed is not None:
                    self._shed.inc()
                raise ServeOverloaded(
                    f"request queue at max_queue={self.max_queue}; "
                    f"request shed")
            quota = self._quota_of(req.tenant)
            if quota is not None:
                held = self._tenant_outstanding.get(req.tenant, 0)
                if held >= quota:
                    if self._shed is not None:
                        self._shed.inc()
                    if self._tenant_shed is not None:
                        self._tenant_shed.inc()
                    raise TenantQuotaExceeded(
                        f"tenant {req.tenant!r} at admission quota "
                        f"{quota} ({held} request(s) outstanding); "
                        f"request shed")
                self._tenant_outstanding[req.tenant] = held + 1
                req.add_done_callback(self._release_tenant)
            if req.slo_rank:
                self._ranked_ever = True
            self._items.append(req)
            self._set_depth_locked()
            self._cond.notify_all()

    def requeue_front(self, req: Request) -> None:
        """Put an ALREADY-ADMITTED request back at the queue head (the
        continuous scheduler defers a refill when the KV page pool is
        exhausted — the request keeps its FIFO position and its
        deadline). Bypasses the admission bound (the request was
        counted at ``put``) and works on a closed queue (drain must
        still serve it)."""
        with self._cond:
            self._items.insert(0, req)
            self._set_depth_locked()
            self._cond.notify_all()

    def _shed_expired_locked(self, now: float) -> None:
        kept = []
        for r in self._items:
            if r.deadline is not None and now > r.deadline:
                if self._timeouts is not None:
                    self._timeouts.inc()
                self._expired_unreported += 1
                r._fail(DeadlineExceeded(
                    f"request {r.id} deadline expired after "
                    f"{now - r.t_enqueue:.3f}s in queue"))
            else:
                kept.append(r)
        self._items = kept
        self._set_depth_locked()

    def _report_expired(self) -> None:
        """Fire ``on_timeout`` for expiries detected since the last
        report; called with the lock RELEASED."""
        if self._on_timeout is None:
            return
        with self._cond:
            n, self._expired_unreported = self._expired_unreported, 0
        if n:
            try:
                self._on_timeout(n)
            except Exception:
                # forensics must never take the serving loop down
                pass

    def pop(self, timeout: float = 0.05) -> Optional[Request]:
        """Best non-expired request, or None after ``timeout`` (also
        None immediately when closed and empty). "Best" is SLO-class
        order: the LOWEST ``slo_rank`` present wins, FIFO
        within a rank — so a realtime-class request admitted behind a
        queue of batch-class work is served first, while same-class
        traffic keeps strict arrival order (a deferred refill put back
        via :meth:`requeue_front` keeps the head position of its own
        rank)."""
        end = time.perf_counter() + timeout
        try:
            with self._cond:
                while True:
                    now = time.perf_counter()
                    self._shed_expired_locked(now)
                    if self._items:
                        if self._ranked_ever:
                            best = min(range(len(self._items)),
                                       key=lambda i:
                                       (self._items[i].slo_rank, i))
                        else:
                            # no ranked request ever admitted: the scan
                            # provably returns 0 — skip it
                            best = 0
                        req = self._items.pop(best)
                        self._set_depth_locked()
                        return req
                    if self._closed or now >= end:
                        return None
                    self._cond.wait(min(0.02, max(0.0, end - now)))
        finally:
            self._report_expired()

    def form_group(self, max_n: int, max_wait_s: float,
                   stop: threading.Event,
                   poll_s: float = 0.05) -> List[Request]:
        """Form one batch: up to ``max_n`` requests sharing the OLDEST
        waiting request's ``group_key``, dispatched as soon as the
        group is full, the oldest member has waited ``max_wait_s``, or
        the queue is draining (closed). Returns [] when there is
        nothing to serve yet (the caller loops)."""
        try:
            with self._cond:
                now = time.perf_counter()
                self._shed_expired_locked(now)
                if not self._items:
                    if not (self._closed or stop.is_set()):
                        self._cond.wait(poll_s)
                        self._shed_expired_locked(time.perf_counter())
                    if not self._items:
                        return []
                key = self._items[0].group_key
                dispatch_at = self._items[0].t_enqueue + max_wait_s
            while True:
                with self._cond:
                    now = time.perf_counter()
                    self._shed_expired_locked(now)
                    matching = [r for r in self._items
                                if r.group_key == key]
                    full = len(matching) >= max_n
                    due = now >= dispatch_at
                    if full or due or self._closed or stop.is_set():
                        take = matching[:max_n]
                        for r in take:
                            self._items.remove(r)
                        self._set_depth_locked()
                        return take
                    self._cond.wait(
                        min(poll_s, max(0.001, dispatch_at - now)))
        finally:
            self._report_expired()

    def close(self) -> None:
        """Stop admission; queued requests stay servable (drain)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def fail_all(self, exc: BaseException) -> int:
        """Fail every still-queued request (end of drain); returns the
        count failed."""
        with self._cond:
            items, self._items = self._items, []
            self._set_depth_locked()
        for r in items:
            r._fail(exc)
        return len(items)


class MicroBatcher:
    """The one-shot dispatch loop: forms batches off a
    :class:`RequestQueue` and hands them to ``run_batch(requests)``
    (the session's pad-copy-replay-split callback) on a dedicated
    daemon thread. A ``run_batch`` failure fails exactly that batch's
    requests — the loop (and every other request) survives — UNLESS
    the exception declares ``fatal = True`` (an injected replica crash,
    or any condition after which the replica cannot be trusted): then
    the loop fails the batch AND everything still queued with
    :class:`ReplicaUnavailable`, closes admission, reports ``on_fatal``
    and exits — a dead replica fails fast instead of serving garbage
    or hanging its clients.

    ``heartbeat`` is refreshed every loop pass (idle polls included);
    a fleet router treats a stale heartbeat as a stalled replica.
    ``on_error(exc, n)`` reports every failed batch (the router's
    error-rate signal); ``alive`` flips False on the fatal path.
    """

    def __init__(self, queue: RequestQueue, run_batch: Callable,
                 max_batch: int, max_wait_ms: float,
                 name: str = "parallax-serve-batcher",
                 on_error: Optional[Callable] = None,
                 on_fatal: Optional[Callable] = None):
        self._queue = queue
        self._run_batch = run_batch
        self._max_batch = int(max_batch)
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._stop = threading.Event()
        self._on_error = on_error
        self._on_fatal = on_fatal
        self.alive = True
        self.busy = False
        self.heartbeat = time.perf_counter()
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    def _die(self, batch, cause: BaseException) -> None:
        """Fatal path: this replica is done serving. The in-flight
        batch and the whole queue fail with ReplicaUnavailable (the
        RETRYABLE wrapper — nothing was delivered, so a fleet retry
        cannot double-serve), admission closes, on_fatal fires."""
        self.alive = False
        err = ReplicaUnavailable(
            f"serving replica died: {type(cause).__name__}: {cause}")
        err.__cause__ = cause
        for r in batch:
            if not r.done():
                r._fail(err)
        self._queue.close()
        n = self._queue.fail_all(err)
        parallax_log.error(
            "serve batcher died (%s); failed %d queued request(s)",
            cause, n)
        if self._on_fatal is not None:
            try:
                self._on_fatal(cause)
            except Exception:
                pass

    def _loop(self) -> None:
        while True:
            self.heartbeat = time.perf_counter()
            if self._stop.is_set():
                return
            batch = self._queue.form_group(self._max_batch,
                                           self._max_wait_s, self._stop)
            if batch:
                if self._stop.is_set():
                    # fast close (no drain): stop arrived while the
                    # group formed — these requests are FAILED, not
                    # served, as the close contract says
                    for r in batch:
                        r._fail(ServeClosed(
                            "session closed without drain"))
                    continue
                try:
                    self.busy = True
                    with trace.span("serve.batch", n=len(batch)):
                        self._run_batch(batch)
                except BaseException as e:
                    if self._on_error is not None:
                        try:
                            self._on_error(e, len(batch))
                        except Exception:
                            pass
                    if getattr(e, "fatal", False):
                        self._die(batch, e)
                        return
                    # fail the batch, not the loop
                    parallax_log.warning(
                        "serve batch of %d request(s) failed: %s",
                        len(batch), e)
                    for r in batch:
                        if not r.done():
                            r._fail(e if isinstance(e, Exception)
                                    else ServeError(str(e)))
                finally:
                    self.busy = False
                continue
            if self._queue.closed and len(self._queue) == 0:
                return

    def drain(self, timeout_s: float) -> None:
        """Wait for the loop to serve the closed queue to completion
        (call after ``queue.close()``); hard-stops at the timeout —
        with ``timeout_s=0`` (close without drain) the loop fails
        still-queued requests instead of serving them."""
        if timeout_s > 0:
            self._thread.join(timeout=timeout_s)
        self._stop.set()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            parallax_log.warning(
                "serve batcher thread did not stop within the drain "
                "window; undrained requests will be failed by close()")
