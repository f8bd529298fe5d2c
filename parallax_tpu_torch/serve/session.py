"""ServeSession — put a decode model behind a request queue.

One object owns the serving stack of one replica:

* **placement** — the parameter tree is copied to the session's device
  (the session's own leaves: a ``swap_params`` overwrites them in
  place; the JAX package places the tree on a mesh);
* **the slot-based continuous scheduler** (serve/continuous.py) driving
  a :class:`DecodeProgram` on its own thread;
* **admission** — the bounded request queue with deadlines, tenant
  quotas and SLO classes (serve/batcher.py);
* **observability** — ``serve.*`` metrics (queue depth, batch
  occupancy, request latency, time-to-first-token, tokens/sec,
  shed/timeout counters) in the session's registry, a ``serve.request``
  span per request, and the per-request lifecycle records;
* **the replica surface** — ``prefill_only`` / ``import_prefix_entry``
  (an exported prefill and its import into the prefix cache),
  ``swap_params`` (the weights replaced in place, nothing captured
  again), and the ``alive`` / ``heartbeat`` / ``load`` / ``idle``
  probes a router reads.

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
from parallax_tpu_torch.obs import metrics as obs_metrics, reqtrace, trace
from parallax_tpu_torch.serve.batcher import (ReplicaUnavailable, Request,
                                              RequestQueue, ServeClosed,
                                              ServeError, ServeOverloaded)
from parallax_tpu_torch.serve.continuous import ContinuousScheduler


def _to_device(tree, device):
    """A copy of ``tree`` on ``device`` whose leaves are the session's
    own (never the caller's tensors)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.as_tensor(tree).to(device, copy=True)


def _leaves(tree, path=""):
    """(path, leaf) pairs of a params tree, dict keys sorted (as a JAX
    treedef orders them); the path names the structure (dict keys, list
    positions)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


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
        self._program = program
        self._scheduler = ContinuousScheduler(
            program, self._params, sc, self.metrics, self._queue)
        # graphs the program captured: the warmup's, and none after (a
        # params swap copies in place)
        self.metrics.gauge("serve.graph_captures").set_fn(
            lambda: getattr(program, "captures", 0))

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

    def prefix_stats(self) -> Optional[Dict[str, Any]]:
        """The prefix cache's own snapshot (entries, cached pages,
        pinned entries, insertions/evictions); None with
        ``ServeConfig.prefix_cache`` off."""
        return self._scheduler.prefix_stats()

    # -- exported prefill ------------------------------------------------------

    def prefill_only(self, feed: Dict[str, Any]):
        """Run ONLY the prefill of one request, on the caller's thread.
        Returns ``(prepared_feed, prefix_key, request_state)``: the feed
        padded onto the program's fixed shapes, the radix key the result
        is cacheable under, and the request state — tensors the caller
        owns (the program's ``prefill_owned``: the same math, run
        eagerly, touching no buffer the serving loop replays into)."""
        prog = self._program
        if not hasattr(prog, "prefix_key"):
            raise ValueError(
                "prefill_only requires a program exposing prefix_key "
                "(the transfer protocol is keyed by it)")
        if not self._scheduler.alive:
            raise ReplicaUnavailable("this replica's decode loop is dead")
        prepared = prog.prepare_feed(feed)
        chunks = int(getattr(prog, "num_prefill_chunks", 1))
        with trace.span("serve.prefill_export", chunks=chunks):
            rs = prog.prefill_owned(self._params, prepared)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        return prepared, prog.prefix_key(prepared), rs

    def import_prefix_entry(self, tenant, key, request_state,
                            positions: int = 0) -> bool:
        """Install an externally prefilled request state into this
        session's prefix cache; see :meth:`~parallax_tpu_torch.serve.
        continuous.ContinuousScheduler.import_prefix`."""
        return self._scheduler.import_prefix(tenant, key, request_state,
                                             positions=positions)

    # -- live weight swap ------------------------------------------------------

    def swap_params(self, params) -> None:
        """Replace the served parameters IN PLACE.

        The new tree must match the served one in structure, leaf shapes
        and dtypes; a mismatch is refused (``ValueError``). The values
        are copied into the session's own leaves and the program's cast
        copy is refreshed in place, so every captured graph keeps reading
        the same addresses and nothing is captured again
        (``serve.graph_captures`` does not move) — the counterpart of the
        JAX package's swap without recompiles. Quiesce first
        (:meth:`idle`) so no sequence mixes weights. Counted in
        ``serve.hotswaps``."""
        old = list(_leaves(self._params))
        new = list(_leaves(params))
        if [p for p, _ in old] != [p for p, _ in new]:
            raise ValueError(
                "swap_params: new params tree structure differs from the "
                f"served one ({[p for p, _ in new]} vs "
                f"{[p for p, _ in old]})")
        for (path, a), (_, b) in zip(old, new):
            b = torch.as_tensor(b)
            if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                raise ValueError(
                    f"swap_params: leaf {path} changed "
                    f"{tuple(a.shape)}/{a.dtype} -> "
                    f"{tuple(b.shape)}/{b.dtype}; the captured graphs "
                    f"would be invalidated — rebuild the session for a "
                    f"different architecture")
        with trace.span("serve.hotswap"), torch.no_grad():
            for (_, a), (_, b) in zip(old, new):
                a.copy_(torch.as_tensor(b))
            refresh = getattr(self._program, "refresh_params", None)
            if refresh is not None:
                refresh(self._params)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._scheduler.set_params(self._params)
        self.metrics.counter("serve.hotswaps").inc()
        parallax_log.info("serve: swapped params in place (%d leaves, "
                          "no capture)", len(old))

    # -- replica probes --------------------------------------------------------

    @property
    def alive(self) -> bool:
        """False once the decode loop died (a dead session sheds at
        admission: its queue is closed)."""
        return self._scheduler.alive

    @property
    def heartbeat(self) -> float:
        """``perf_counter`` time of the decode loop's last pass."""
        return self._scheduler.heartbeat

    def load(self) -> float:
        """Queued + in-flight work: a router's placement score."""
        return float(len(self._queue) + self._scheduler._active()
                     + len(self._scheduler._pending))

    def idle(self) -> bool:
        """Nothing queued and nothing in flight — the quiesced state a
        params swap requires."""
        return self._scheduler.idle()

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
