"""Request futures, the serve error taxonomy and the admission queue.

Clients submit single-request feeds; the continuous-decode scheduler
pops them one at a time into decode slots. Admission control keeps the
system stable under overload:

* a bounded queue (``max_queue``) — a submit beyond it is SHED with
  :class:`ServeOverloaded` raised synchronously to the caller, so
  overload produces fast failures instead of unbounded queueing delay;
* per-request deadlines — a request whose deadline expires while it
  waits is dropped (:class:`DeadlineExceeded` delivered through its
  future) rather than computed for a caller who already gave up;
* per-tenant quotas and SLO-class priorities (``ServeConfig``).

``close()`` stops admission; the already-accepted queue stays
servable until the session's drain window ends.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class ServeError(RuntimeError):
    """Base class of serving-layer request failures.

    Two class attributes declare the transient-vs-permanent taxonomy
    ON the exception, so retry logic reads a declared
    property instead of pattern-matching type names:

    * ``retryable`` — another attempt (later, or on another replica,
      within the original deadline) may succeed.
    * ``fatal`` — the replica that raised it is DEAD: the serving loop
      that observes it stops and fails everything it holds with
      :class:`ReplicaUnavailable`.
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

    Permanent for the session the caller submitted to."""

    retryable = False


class ReplicaUnavailable(ServeError):
    """The replica holding this request died or was ejected before
    completing it (crash, non-finite output, forced ejection).

    Transient: the request was accepted but never served — nothing was
    delivered, so a retry on a healthy replica cannot double-serve
    it."""

    retryable = True


_req_ids = itertools.count()


class Request:
    """One submitted request: the feed plus a future for its result.

    ``result()`` blocks until the scheduler completes or fails the
    request (re-raising the failure); ``done()`` never blocks. Times
    are ``time.perf_counter()`` seconds: ``t_enqueue`` at submit,
    ``deadline`` absolute (None = no deadline), ``t_done`` when the
    result (or failure) landed.

    ``rec`` is the request's lifecycle record
    (:class:`~parallax_tpu_torch.obs.reqtrace.RequestRecord`, attached by the
    owning session; None with the obs layer disabled). Terminal
    transitions finalize it here — the single completion point —
    so every path (delivery, deadline expiry in queue or mid-decode,
    scheduler death, close) lands in the request
    timeline without each call site having to remember to.
    """

    __slots__ = ("id", "feed", "deadline", "max_new_tokens",
                 "tenant", "slo_rank", "t_enqueue", "t_done",
                 "t_first_token", "rec", "_event", "_result", "_error",
                 "_callbacks")

    def __init__(self, feed: Dict[str, Any],
                 deadline: Optional[float] = None,
                 max_new_tokens: Optional[int] = None,
                 tenant: Any = None,
                 slo_rank: int = 0):
        self.id = next(_req_ids)
        self.feed = feed
        self.deadline = deadline
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
        did, else on whichever thread delivers the outcome. Callback
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
            # finalized BEFORE the event fires: a done-callback
            # reading the record sees the completed decomposition
            self.rec.complete(self.t_done)
        self._result = result
        self._event.set()
        self._drain_callbacks()

    def _fail(self, exc: BaseException) -> None:
        self.t_done = time.perf_counter()
        if self.rec is not None:
            outcome = ("deadline_exceeded"
                       if isinstance(exc, DeadlineExceeded)
                       else type(exc).__name__)
            self.rec.complete(self.t_done, outcome=outcome)
        self._error = exc
        self._event.set()
        self._drain_callbacks()


class RequestQueue:
    """Bounded FIFO with deadline shedding, tenant quotas and SLO-class
    priority; the continuous-decode scheduler pops from it."""

    def __init__(self, max_queue: int, metrics=None,
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
                r._fail(DeadlineExceeded(
                    f"request {r.id} deadline expired after "
                    f"{now - r.t_enqueue:.3f}s in queue"))
            else:
                kept.append(r)
        self._items = kept
        self._set_depth_locked()

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
