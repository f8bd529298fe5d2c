"""ServeSession — put a decode model behind a request queue.

One object owns the serving stack of one replica:

* **placement** — the parameter tree is moved to the session's device
  (``.to(device)``; the JAX package places it on a mesh);
* **the slot-based continuous scheduler** (serve/continuous.py) driving
  a :class:`DecodeProgram` on its own thread;
* **admission** — the bounded request queue with deadlines, tenant
  quotas and SLO classes (serve/batcher.py);
* **observability** — ``serve.*`` metrics (queue depth, batch
  occupancy, request latency, time-to-first-token, tokens/sec,
  shed/timeout counters) in the session's registry, a ``serve.request``
  span per request, and the per-request lifecycle records.

Only the continuous-decode (program) mode is ported; the JAX package's
one-shot micro-batching mode is not.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import torch

from parallax_tpu_torch.common.config import ParallaxConfig
from parallax_tpu_torch.common.lib import parallax_log, resolve_device
from parallax_tpu_torch.obs import _state as obs_state
from parallax_tpu_torch.obs import metrics as obs_metrics, reqtrace
from parallax_tpu_torch.serve.batcher import (Request, RequestQueue,
                                              ServeClosed, ServeError,
                                              ServeOverloaded)
from parallax_tpu_torch.serve.continuous import ContinuousScheduler


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)


class ServeSession:
    """Serve a :class:`~parallax_tpu_torch.serve.continuous.
    DecodeProgram` behind a request queue::

        prog = NMTDecodeProgram(cfg, max_src_len=64, page_size=16,
                                pool_pages=512, attn_impl="kernel")
        with ServeSession(program=prog, params=params,
                          config=Config(serve_config=ServeConfig(
                              max_batch=64))) as serve:
            req = serve.submit({"src": src}, max_new_tokens=32)
            tokens = req.result()

    ``device`` (default the card) is where the parameters are placed;
    it must match the program's device. On a machine without CUDA the
    default raises — pass ``device="cpu"`` to the session and the
    program to run on the CPU.
    """

    def __init__(self, program=None, params: Any = None, *,
                 config: Optional[ParallaxConfig] = None,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None,
                 device="cuda"):
        if program is None:
            raise ValueError(
                "ServeSession needs program=: only continuous decode is "
                "ported to parallax_tpu_torch")
        if params is None:
            raise ValueError("ServeSession needs a params tree")
        self.device = resolve_device(device)
        prog_dev = torch.device(getattr(program, "device", self.device))
        if prog_dev.type != self.device.type or None not in (
                prog_dev.index, self.device.index) \
                and prog_dev.index != self.device.index:
            raise ValueError(
                f"program runs on {prog_dev}, the session on "
                f"{self.device}")
        self._config = config or ParallaxConfig()
        sc = self._config.serve_config
        self.metrics = metrics if metrics is not None \
            else obs_metrics.MetricsRegistry()
        # nothing compiles at serve time; kept so a dashboard reading
        # the JAX package's counter reads 0 here too
        self.metrics.counter("serve.recompiles")
        self._requests = self.metrics.counter("serve.requests")
        self.reqtrace = reqtrace.RequestTraceRing(self.metrics)
        self._queue = RequestQueue(
            sc.max_queue, self.metrics,
            tenant_quotas=sc.tenant_quotas,
            default_tenant_quota=sc.default_tenant_quota)
        self._closed = False
        self._close_lock = threading.Lock()
        self._params = _to_device(params, self.device)
        self._scheduler = ContinuousScheduler(
            program, self._params, sc, self.metrics, self._queue)

    # -- admission ---------------------------------------------------------

    def submit(self, feed: Dict[str, Any],
               deadline_ms: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               tenant: Any = None,
               slo_class: Optional[str] = None) -> Request:
        """Admit one request; returns its :class:`Request` future, whose
        result is the decoded token array.

        Raises :class:`ServeOverloaded` when admission control sheds it
        (queue full), :class:`TenantQuotaExceeded` when ``tenant`` is
        at its admission quota, :class:`ServeClosed` after ``close()``,
        and ``ValueError`` for a feed or a ``max_new_tokens`` the
        program cannot take. The deadline (``deadline_ms``, else the
        ``slo_class`` deadline, else ``ServeConfig.default_deadline_ms``)
        bounds QUEUE+SERVE time: an expired request is dropped with
        :class:`DeadlineExceeded` instead of served late."""
        t_sub = time.perf_counter()
        sc = self._config.serve_config
        slo_rank, slo_ddl_ms = sc.resolve_slo_class(slo_class)
        ddl_ms = (deadline_ms if deadline_ms is not None
                  else slo_ddl_ms if slo_ddl_ms is not None
                  else sc.default_deadline_ms)
        deadline = (time.perf_counter() + float(ddl_ms) / 1e3
                    if ddl_ms is not None else None)
        req = self._scheduler.make_request(feed, deadline, max_new_tokens,
                                           tenant=tenant,
                                           slo_rank=slo_rank)
        if obs_state.enabled:
            req.rec = reqtrace.RequestRecord(req.id, t0=t_sub,
                                             deadline=deadline,
                                             ring=self.reqtrace)
            req.rec.mark("queue_wait")
        self._requests.inc()
        try:
            self._queue.put(req)  # raises ServeOverloaded / ServeClosed
        except ServeError as e:
            if req.rec is not None:
                req.rec.complete(outcome="shed" if isinstance(
                    e, ServeOverloaded) else "closed")
            raise
        self._scheduler.kick()
        return req

    def request_records(self, last: Optional[int] = None):
        """Snapshots of recently completed request lifecycle records."""
        return self.reqtrace.records(last)

    # -- introspection / teardown ------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """JSON-ready snapshot of every ``serve.*`` metric."""
        return {k: v for k, v in self.metrics.snapshot().items()
                if k.startswith("serve.")}

    def close(self, drain: bool = True) -> None:
        """Stop admission; with ``drain`` (default) serve the accepted
        queue to completion (bounded by ``ServeConfig.drain_timeout_s``),
        then fail whatever remains with :class:`ServeClosed`.
        Idempotent."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        sc = self._config.serve_config
        self._queue.close()
        self._scheduler.drain(sc.drain_timeout_s if drain else 0.0)
        n = self._queue.fail_all(ServeClosed("session closed"))
        if n:
            parallax_log.warning(
                "serve close: failed %d undrained request(s)", n)

    def __enter__(self) -> "ServeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
