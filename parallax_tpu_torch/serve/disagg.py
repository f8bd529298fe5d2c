"""Disaggregated prefill/decode serving
(``parallax_tpu/serve/disagg.py``).

Prefill is compute-bound (one big batched pass over the prompt) and
decode is memory-bound (hundreds of tiny steps against a growing KV
cache), so colocating them forces one replica shape to be wrong for
half its work: a long prompt stalls every decoding slot behind its
prefill, and a decode-heavy mix leaves the prefill FLOPs idle. The
DistServe/Splitwise answer — and this module — is two POOLS:

* a **prefill pool** (:class:`~parallax_tpu_torch.serve.fleet.ServeFleet`
  of ordinary decode replicas used only for their prefill) runs the
  per-request one-time work on the CALLER's thread via
  :meth:`~parallax_tpu_torch.serve.session.ServeSession.prefill_only`
  (eagerly, into tensors the caller owns);
* the finished request state crosses pools as **wire bytes**
  (:func:`export_prefill` / :func:`import_prefill` — a host-side
  page-transfer protocol: device tensors -> npz payload -> host arrays)
  and lands in every decode replica's radix prefix cache through
  :meth:`~parallax_tpu_torch.serve.session.ServeSession.
  import_prefix_entry`
  — the broadcast is what keeps DECODE-side failover free: whichever
  replica the request lands on (first placement or a failover hop)
  finds the entry and skips the prefill;
* a **decode pool** (a second ServeFleet) serves the request normally;
  admission hits the imported entry (a zero-replay prefix hit) and the
  program's ``insert`` re-scatters the prompt KV into locally-owned
  pages — tokens equal the colocated baseline's because the imported
  state is the prefill output the local path computes, and greedy
  decode is deterministic. (In bf16 the wire carries fp32, which is
  exact, and the insert casts back to the cache dtype.)

The two pools autoscale INDEPENDENTLY (each ServeFleet runs its own
watermark loop over its own ``FleetConfig``), which is the point:
prefill capacity follows prompt tokens/sec, decode capacity follows
concurrent sequences.

Failure semantics, in order of escalation:

* a prefill attempt that dies (replica crash mid-transfer — the chaos
  case) fails over to another prefill replica within the pool's
  ``max_retries``, accounted as a ``failover`` phase on the request
  record;
* a prefill pool with nothing placeable FALLS BACK to colocated
  serving: the request goes straight to the decode pool, whose
  admission misses the cache and runs the prefill locally — identical
  tokens, degraded latency, counted in
  ``serve.disagg.prefill_fallbacks``;
* an imported entry evicted under decode-pool memory pressure before
  its request is popped degrades the same way (admission miss ->
  local prefill) — the transfer is an optimization, never a
  correctness dependency.

The request record (obs/reqtrace.py) carries the inter-pool hop as the
``kv_transfer`` phase, so sum(phases) == client wall time survives
disaggregation.
"""

from __future__ import annotations

import io
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.obs import _state as obs_state
from parallax_tpu_torch.obs import metrics as obs_metrics, reqtrace, trace
from parallax_tpu_torch.serve.batcher import (DeadlineExceeded,
                                        ReplicaUnavailable, ServeError)
from parallax_tpu_torch.serve.fleet import (FleetConfig, FleetRequest,
                                      ServeFleet)

# -- the wire format --------------------------------------------------------
#
# One prefill request state = one npz payload. The request state is a
# (possibly nested) dict of arrays; each leaf is stored under its
# '/'-joined key path as a host ndarray. npz carries dtype + shape per
# leaf, so the payload is self-describing and survives process/host
# boundaries; import rebuilds the nested dict exactly. Keys must not
# contain '/' (enforced at export). The format is the JAX package's, so
# either package reads the other's bytes. numpy has no bfloat16, so a
# bf16 tensor travels as float32 — exact, at twice its bytes — and
# comes back as a float32 array.

_SEP = "/"


def _flatten(rs, prefix: str = "") -> List[Tuple[str, np.ndarray]]:
    out: List[Tuple[str, np.ndarray]] = []
    if isinstance(rs, dict):
        for k in sorted(rs):
            key = str(k)
            if _SEP in key:
                raise ValueError(
                    f"request-state key {key!r} contains {_SEP!r} "
                    f"(reserved as the wire path separator)")
            out.extend(_flatten(rs[k], prefix + key + _SEP))
        return out
    if prefix == "":
        raise ValueError(
            f"request state must be a dict of arrays, got "
            f"{type(rs).__name__}")
    return [(prefix[:-1], _host_leaf(rs))]


def _host_leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def export_prefill(request_state) -> bytes:
    """Encode one prefill request state (a nested dict of device
    tensors or host arrays) into self-describing wire bytes."""
    leaves = _flatten(request_state)
    buf = io.BytesIO()
    np.savez(buf, **dict(leaves))
    return buf.getvalue()


def import_prefill(data: bytes) -> Dict[str, Any]:
    """Decode :func:`export_prefill` bytes back into the nested dict
    of host arrays (the decode replica's ``insert`` copies them to its
    device and casts them to its cache dtype)."""
    with np.load(io.BytesIO(data)) as z:
        out: Dict[str, Any] = {}
        for path in z.files:
            node = out
            parts = path.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[path]
    return out


# -- the two-pool front door ------------------------------------------------


class DisaggFleet:
    """A prefill pool and a decode pool behind one ``submit``.

    ``make_prefill_replica`` / ``make_decode_replica`` follow the
    :class:`~parallax_tpu_torch.serve.fleet.ServeFleet` factory contract
    (``(rid, **serve_kw) -> ServeSession``, one program per replica);
    decode replicas MUST run a paged program with
    ``ServeConfig.prefix_cache`` on (the import surface). Each pool takes its own :class:`FleetConfig`, so replica
    counts, retry budgets and autoscaling watermarks are independent —
    the asymmetry disaggregation exists to exploit::

        disagg = DisaggFleet(
            make_prefill_replica, make_decode_replica,
            prefill_config=FleetConfig(num_replicas=2),
            decode_config=FleetConfig(num_replicas=2))
        req = disagg.submit({"ids": prompt}, max_new_tokens=32)
        tokens = req.result()
        disagg.close()
    """

    def __init__(self, make_prefill_replica, make_decode_replica, *,
                 prefill_config: Optional[FleetConfig] = None,
                 decode_config: Optional[FleetConfig] = None,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None,
                 flight=None, anomaly=None, faults=None,
                 decode_faults=None):
        self.metrics = metrics if metrics is not None \
            else obs_metrics.MetricsRegistry()
        self._pcfg = prefill_config or FleetConfig()
        self.prefill_fleet = ServeFleet(
            make_prefill_replica, config=self._pcfg,
            metrics=obs_metrics.MetricsRegistry(), flight=flight,
            anomaly=anomaly, faults=faults)
        self.decode_fleet = ServeFleet(
            make_decode_replica, config=decode_config or FleetConfig(),
            metrics=obs_metrics.MetricsRegistry(), flight=flight,
            anomaly=anomaly, faults=decode_faults)
        # the front-door lifecycle ring: ONE record per request across
        # prefill pool -> transfer -> decode pool (+ any failover hops
        # inside either), so the kv_transfer-extended decomposition
        # still partitions the client-visible window
        self.reqtrace = reqtrace.RequestTraceRing(self.metrics)
        self._requests = self.metrics.counter("serve.disagg.requests")
        self._transfers = self.metrics.counter("serve.disagg.transfers")
        self._bytes = self.metrics.counter("serve.disagg.transfer_bytes")
        self._transfer_ms = self.metrics.histogram(
            "serve.disagg.transfer_ms")
        self._prefill_ms = self.metrics.histogram(
            "serve.disagg.prefill_ms")
        self._failovers = self.metrics.counter(
            "serve.disagg.prefill_failovers")
        self._fallbacks = self.metrics.counter(
            "serve.disagg.prefill_fallbacks")
        self._closed = False

    # -- the phase-aware front door ----------------------------------------

    def submit(self, feed: Dict[str, Any],
               deadline_ms: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               tenant: Any = None,
               slo_class: Optional[str] = None) -> FleetRequest:
        """One disaggregated request: prefill on the prefill pool (on
        THIS thread — the pool scheduler places by phase, so the
        caller's thread is the prefill worker), stream the finished
        state to the decode pool, submit there. Returns the decode
        pool's :class:`FleetRequest` future; its tokens equal a
        colocated submit's of the same feed."""
        t0 = time.perf_counter()
        deadline = (t0 + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        rec = None
        if obs_state.enabled:
            rec = reqtrace.RequestRecord(
                f"disagg-{self._requests.value}", t0=t0,
                deadline=deadline, ring=self.reqtrace, fleet_owned=True)
        self._requests.inc()
        try:
            exported = self._prefill_phase(feed, rec, deadline)
            if exported is not None:
                key, wire, positions = exported
                self._transfer_phase(rec, tenant, key, wire, positions)
        except BaseException as e:
            if rec is not None:
                rec.complete(outcome=(
                    "deadline_exceeded" if isinstance(e, DeadlineExceeded)
                    else f"failed:{type(e).__name__}"))
            raise
        remaining = ((deadline - time.perf_counter()) * 1e3
                     if deadline is not None else None)
        return self.decode_fleet.submit(
            feed, deadline_ms=remaining, max_new_tokens=max_new_tokens,
            tenant=tenant, slo_class=slo_class, rec=rec)

    def _prefill_phase(self, feed, rec, deadline):
        """Run the prefill on the pool, failing over across prefill
        replicas; returns ``(prefix_key, wire_bytes, positions)`` or
        None for the colocated fallback (nothing placeable / retries
        exhausted — the decode pool's local prefill serves it)."""
        if rec is not None:
            rec.mark("prefill")
        exclude: Tuple = ()
        attempts = int(self._pcfg.max_retries) + 1
        for attempt in range(attempts):
            if deadline is not None and time.perf_counter() > deadline:
                raise DeadlineExceeded(
                    "disaggregated request deadline expired during "
                    "prefill")
            try:
                handle = self.prefill_fleet.acquire_replica(exclude)
            except ReplicaUnavailable:
                break  # nothing placeable: colocated fallback
            t0 = time.perf_counter()
            try:
                with trace.span("serve.disagg.prefill",
                                replica=handle.rid, attempt=attempt):
                    _, key, rs = handle.session.prefill_only(feed)
                    wire = export_prefill(rs)
                    # the wire carries request STATE only, no pool
                    # pages — the imported entry covers 0 positions
                    # and the decode-side insert re-scatters the
                    # prompt KV into locally-owned pages
                    positions = 0
            except (ServeError, RuntimeError, OSError) as e:
                # replica died mid-prefill/mid-export (the chaos case):
                # health-account it and fail over within the pool
                self.prefill_fleet.record_replica_error(handle, e)
                exclude = exclude + (handle.rid,)
                self._failovers.inc()
                if rec is not None:
                    rec.mark("failover")
                    rec.note_retry()
                    rec.mark("prefill")
                parallax_log.warning(
                    "disagg: prefill failed on replica %r (attempt "
                    "%d): %s", handle.rid, attempt + 1, e)
                continue
            finally:
                self.prefill_fleet.release_replica(handle)
            dt_ms = (time.perf_counter() - t0) * 1e3
            self._prefill_ms.record(dt_ms)
            self.prefill_fleet.record_replica_success(handle,
                                                      latency_ms=dt_ms)
            if rec is not None:
                rec.note_hop(f"prefill:{handle.rid}")
            return key, wire, positions
        # degraded but correct: the decode replica's admission misses
        # the cache and runs the prefill locally — identical tokens
        self._fallbacks.inc()
        parallax_log.warning(
            "disagg: prefill pool unavailable; falling back to "
            "colocated prefill on the decode pool")
        return None

    def _transfer_phase(self, rec, tenant, key, wire: bytes,
                        positions: int) -> None:
        """Move the wire bytes into the decode pool: import into EVERY
        live decode replica's prefix cache, so first placement and any
        failover hop both find the entry."""
        if rec is not None:
            rec.mark("kv_transfer")
        t0 = time.perf_counter()
        with trace.span("serve.disagg.transfer", bytes=len(wire)):
            rs_host = import_prefill(wire)
            imported = 0
            for rid, session in self.decode_fleet.live_sessions():
                try:
                    if session.import_prefix_entry(
                            tenant, key, rs_host, positions=positions):
                        imported += 1
                except Exception as e:
                    # a single replica refusing the import only costs
                    # IT a local prefill on a failover hop
                    parallax_log.warning(
                        "disagg: import into decode replica %r "
                        "failed: %s", rid, e)
        self._transfers.inc()
        self._bytes.inc(len(wire))
        self._transfer_ms.record((time.perf_counter() - t0) * 1e3)

    # -- introspection / teardown ------------------------------------------

    def request_records(self, last: Optional[int] = None):
        """Snapshots of recently completed front-door records (the
        kv_transfer-extended decompositions)."""
        return self.reqtrace.records(last)

    def recompiles(self) -> int:
        """Serve-time recompiles across BOTH pools (the invariant is
        fleet-wide: transfer must not introduce a single compile)."""
        return (self.prefill_fleet.recompiles()
                + self.decode_fleet.recompiles())

    def stats(self) -> Dict[str, Any]:
        return {
            "disagg": {k: v for k, v in self.metrics.snapshot().items()
                       if k.startswith("serve.disagg.")},
            "prefill_pool": self.prefill_fleet.stats(),
            "decode_pool": self.decode_fleet.stats(),
        }

    def close(self, drain: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        self.prefill_fleet.close(drain=drain)
        self.decode_fleet.close(drain=drain)

    def __enter__(self) -> "DisaggFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["DisaggFleet", "export_prefill", "import_prefill"]
