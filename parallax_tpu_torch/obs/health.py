"""Training health monitors: loss finiteness, gradient norm, device
memory (the JAX package's ``obs/health.py``).

The failure modes these catch are the ones that waste a long run
silently: a loss that went NaN at step 40k (every later step is
garbage), a gradient norm that exploded (divergence hours before the
loss shows it), and device memory creeping toward OOM.

Loss-finiteness and grad-global-norm are computed **in the step**
(core/engine.py appends ``loss_finite`` / ``grad_norm`` outputs when
``Config(monitor_health=True)``) — a handful of FLOPs next to the
backward pass — and consumed **lazily** here: ``observe()`` keeps the
values and only materializes the ones whose transfers already finished
(``is_ready``), so the dispatch thread never blocks on monitoring. On
the card the session copies each step's scalars ``non_blocking`` into a
pinned host buffer and records a CUDA event after the copy
(:class:`HostScalars`); a reading is ready once its event has
completed, and nothing on the dispatch thread calls ``.item()`` on a
fresh output. ``report()`` / session close drain the rest.

Everything lands in the session's MetricsRegistry (``health.*``), so
one snapshot carries it (the JSONL sink, the exporter).
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Dict, Optional

import numpy as np
import torch

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.obs.metrics import MetricsRegistry, summarize_window


def device_memory_stats(devices=None) -> Dict[str, Dict[str, int]]:
    """Per-card memory stats from the caching allocator, keyed
    ``"cuda:<index>"`` with the JAX package's field names:
    ``bytes_in_use`` (allocated), ``peak_bytes_in_use``, ``bytes_limit``
    (the card's total memory) and ``bytes_reserved`` (held by the
    allocator). ``devices``: card indices; default the current card
    only (touching another card would create a context on it). The CPU
    (or a process that never touched CUDA) reports nothing; never
    raises, and makes no CUDA call: the allocator's counters are host
    state, so it is safe beside a capture on another thread."""
    out: Dict[str, Dict[str, int]] = {}
    try:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return out
        if devices is None:
            devices = [torch.cuda.current_device()]
        for i in devices:
            i = int(getattr(i, "index", i) or 0)
            nested = torch.cuda.memory_stats_as_nested_dict(i)
            out[f"cuda:{i}"] = {
                "bytes_in_use": int(nested["allocated_bytes"]["all"]
                                    ["current"]),
                "peak_bytes_in_use": int(nested["allocated_bytes"]["all"]
                                         ["peak"]),
                "bytes_reserved": int(nested["reserved_bytes"]["all"]
                                      ["current"]),
                "bytes_limit": _total_memory(i),
            }
    except Exception:
        return out
    return out


_TOTALS: Dict[int, int] = {}


def _total_memory(index: int) -> int:
    n = _TOTALS.get(index)
    if n is None:
        n = _TOTALS[index] = int(
            torch.cuda.get_device_properties(index).total_memory)
    return n


class HostScalars:
    """One step's scalars on their way to the host: a pinned host copy
    made ``non_blocking`` on the step's stream, and the CUDA event
    recorded after it. ``is_ready()`` never blocks; ``values()`` waits
    for the event (the blocking drain). On the CPU there is no event
    and the values are the tensors themselves."""

    __slots__ = ("_host", "_event")

    def __init__(self, tensors):
        tensors = [t.detach().reshape(()).to(torch.float32)
                   for t in tensors]
        dev = tensors[0].device
        if dev.type == "cuda":
            self._host = torch.empty(len(tensors), dtype=torch.float32,
                                     pin_memory=True)
            self._host.copy_(torch.stack(tensors), non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        else:
            self._host = torch.stack(tensors)
            self._event = None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def values(self):
        if self._event is not None:
            self._event.synchronize()
        return self._host.tolist()


class _Field:
    """One of a ``HostScalars``' values, with the readiness of the copy
    it rides on (``HealthMonitor`` reads values through ``_to_float``)."""

    __slots__ = ("scalars", "index")

    def __init__(self, scalars: HostScalars, index: int):
        self.scalars = scalars
        self.index = index

    def is_ready(self) -> bool:
        return self.scalars.is_ready()

    def __float__(self):
        return float(self.scalars.values()[self.index])


def host_fields(*tensors):
    """``_Field`` views of one ``HostScalars`` copy of ``tensors`` (None
    entries stay None), for ``HealthMonitor.observe``."""
    live = [t for t in tensors if t is not None]
    if not live or not all(isinstance(t, torch.Tensor) for t in live):
        # host values already (an eager fetch): nothing to wait for
        return tuple(tensors)
    hs = HostScalars(live)
    out, k = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
        else:
            out.append(_Field(hs, k))
            k += 1
    return tuple(out)


def _is_ready(value) -> bool:
    is_ready = getattr(value, "is_ready", None)
    return bool(is_ready()) if callable(is_ready) else True


def _to_float(value) -> float:
    if isinstance(value, torch.Tensor):
        return float(value.detach().float().cpu())
    if isinstance(value, _Field):
        return float(value)
    return float(np.asarray(value))


class HealthMonitor:
    """Consumes per-step health outputs without blocking dispatch.

    ``observe(step, loss_finite, grad_norm)`` parks the device values in
    a bounded deque and drains every entry whose transfer has already
    completed; entries older than ``max_pending`` are drained blocking
    (bounding host memory — in practice the device is at most a couple
    of steps behind). A non-finite loss or grad norm increments a
    counter and logs ONE warning per incident step, immediately — not at
    the end of the run.
    """

    def __init__(self, registry: MetricsRegistry, max_pending: int = 128,
                 on_nonfinite=None, on_reading=None,
                 readings_capacity: int = 256):
        self._registry = registry
        # forensics hooks (obs/flightrec.py, obs/anomaly.py), invoked
        # from _consume with already-materialized host floats:
        #   on_nonfinite(step, kind)            kind in {"loss", "grad"}
        #   on_reading(step, loss, grad_norm)   either value may be None
        # Guarded — a broken hook must not corrupt health accounting.
        self._on_nonfinite = on_nonfinite
        self._on_reading = on_reading
        # bounded ring of (step, loss, grad_norm, loss_finite) — the
        # flight recorder's health section. Own lock: a flight dump
        # snapshots it from another thread while _consume appends, and
        # iterating a mutating deque raises — losing the health
        # section of the very post-mortem the incident produced
        self._readings_lock = threading.Lock()
        self.readings: collections.deque = collections.deque(
            maxlen=int(readings_capacity))
        self._lock = threading.Lock()
        # serializes pop+consume as one unit: concurrent pollers (the
        # dispatch thread and a metrics_snapshot from the sink thread)
        # must not interleave consumption, or first_nonfinite_step and
        # the warning order could name the wrong step. observe() only
        # try-acquires it (skipping the drain under contention), so a
        # blocking report() can never stall the dispatch thread.
        # REENTRANT: _consume fires the forensics hooks, and a flight
        # dump's metrics provider polls health again on the same
        # thread — a plain Lock would deadlock the incident path.
        self._consume_lock = threading.RLock()
        self._pending: collections.deque = collections.deque()
        self._max_pending = int(max_pending)
        self._observed = registry.counter("health.steps_observed")
        self._nonfinite_loss = registry.counter(
            "health.nonfinite_loss_steps")
        self._nonfinite_grad = registry.counter(
            "health.nonfinite_grad_steps")
        self._grad_norm = registry.histogram("health.grad_norm")
        self._last_grad_norm = registry.gauge("health.last_grad_norm")
        # report()/healthy bookkeeping is plain ints, NOT the registry
        # counters: monitor_health=True is an explicit opt-in that must
        # stay self-consistent even with the obs layer disabled
        # (PARALLAX_OBS=0 makes Counter.inc a no-op, which would report
        # 0 nonfinite steps next to a set first_nonfinite_step).
        # Written only from _consume, which _consume_lock serializes.
        self._n_observed = 0
        self._n_nonfinite_loss = 0
        self._n_nonfinite_grad = 0
        # own grad-norm window for the same reason (the registry
        # histogram no-ops when obs is disabled, but the opt-in report
        # must still carry the trend the user is paying in-graph for)
        self._norms: collections.deque = collections.deque(maxlen=512)
        self._n_norms = 0
        self.first_nonfinite_step: Optional[int] = None
        # Instability score (the hook a preemption-aware checkpoint
        # cadence consumes): a bounded
        # [0, 1) accumulator fed by anomaly events over the numerics
        # stats (update-ratio / underflow trends, loss and grad-norm
        # spikes) and by non-finite incidents. Each event of weight w
        # moves the score toward 1 by a factor (1 - e^-w); every
        # consumed healthy reading decays it multiplicatively, so a
        # quiet run returns to ~0 in a few hundred steps while a
        # streak of anomalies saturates. Plain float, written under
        # _consume_lock like the rest of the opt-in bookkeeping.
        self._instability = 0.0
        self._instability_decay = 0.97
        self._instability_events = 0
        registry.gauge("health.instability").set_fn(
            lambda: round(self._instability, 6))

    # -- producer side (dispatch thread) -----------------------------------

    def observe(self, step: int, loss_finite=None,
                grad_norm=None, loss=None) -> None:
        """Queue one step's health outputs (device values ok); drains
        whatever is ready, never blocking on in-flight steps unless the
        backlog exceeds ``max_pending``. ``loss`` (optional) feeds the
        forensics readings ring and the loss-spike detector — finiteness
        accounting keys on ``loss_finite`` as before."""
        with self._lock:
            self._pending.append((step, loss_finite, grad_norm, loss))
        # opportunistic drain: if another thread (report()/snapshot
        # poll) holds the consume lock, skip rather than wait — the
        # dispatch thread must never stall behind a blocking drain
        if self._consume_lock.acquire(blocking=False):
            try:
                self._poll_locked(block=False)
            finally:
                self._consume_lock.release()
        # bound the backlog by draining ONLY the oldest entries past the
        # cap — never the whole queue, which would block dispatch on the
        # just-dispatched step and collapse the async pipeline. The size
        # check happens OUTSIDE the consume lock: under the cap (the
        # steady state) observe must not wait on a concurrent blocking
        # report() drain.
        while True:
            with self._lock:
                over = len(self._pending) > self._max_pending
            if not over:
                break
            with self._consume_lock:
                with self._lock:
                    if len(self._pending) <= self._max_pending:
                        break
                    entry = self._pending.popleft()
                self._consume(*entry)

    # -- consumer side -----------------------------------------------------

    def poll(self, block: bool = False) -> int:
        """Materialize queued entries — in order, stopping at the first
        not-yet-ready one unless ``block``. Returns entries consumed."""
        with self._consume_lock:
            return self._poll_locked(block)

    def _poll_locked(self, block: bool) -> int:
        consumed = 0
        while True:
            with self._lock:
                if not self._pending:
                    return consumed
                step, lf, gn, loss = self._pending[0]
                if not block and not (_is_ready(lf) and _is_ready(gn)
                                      and _is_ready(loss)):
                    return consumed
                self._pending.popleft()
            self._consume(step, lf, gn, loss)
            consumed += 1

    def _consume(self, step: int, loss_finite, grad_norm,
                 loss=None) -> None:
        self._n_observed += 1
        self._observed.inc()
        loss_f = None
        if loss is not None:
            loss_f = _to_float(loss)
        finite = (bool(_to_float(loss_finite))
                  if loss_finite is not None else None)
        norm = (_to_float(grad_norm)
                if grad_norm is not None else None)
        # the reading lands in the forensics ring BEFORE any incident
        # hook fires: the flight dump a non-finite step triggers must
        # already contain that step's reading
        with self._readings_lock:
            self.readings.append((step, loss_f, norm, finite))
        if self._on_reading is not None:
            try:
                self._on_reading(step, loss_f, norm)
            except Exception:
                pass
        # healthy readings decay the instability score (the accumulate
        # side lives in record_instability_event)
        self._instability *= self._instability_decay
        if finite is False:
            self._n_nonfinite_loss += 1
            self._nonfinite_loss.inc()
            if self.first_nonfinite_step is None:
                self.first_nonfinite_step = step
            parallax_log.warning(
                "health: loss is non-finite at step %d", step)
            self._fire_nonfinite(step, "loss")
        if norm is not None:
            if np.isfinite(norm):
                self._norms.append(norm)
                self._n_norms += 1
                self._grad_norm.record(norm)
                self._last_grad_norm.set(norm)
            else:
                self._n_nonfinite_grad += 1
                self._nonfinite_grad.inc()
                parallax_log.warning(
                    "health: gradient global norm is non-finite at "
                    "step %d", step)
                self._fire_nonfinite(step, "grad")

    def _fire_nonfinite(self, step: int, kind: str) -> None:
        self.record_instability_event(1.0)
        if self._on_nonfinite is not None:
            try:
                self._on_nonfinite(step, kind)
            except Exception:
                pass

    # -- instability score -------------------------------------------------

    def record_instability_event(self, weight: float = 0.5) -> None:
        """One anomaly/incident pushes the score toward 1 (bounded);
        callable from any thread (the anomaly on_event hook fires on
        whichever thread consumed the reading)."""
        w = max(float(weight), 0.0)
        with self._consume_lock:
            self._instability_events += 1
            self._instability = 1.0 - (1.0 - self._instability) \
                * math.exp(-w)

    @property
    def instability(self) -> float:
        """Current [0, 1) instability score — 0 = quiet, ~1 = the run
        is actively misbehaving: a checkpoint cadence should save more
        often while this is high."""
        return self._instability

    def snapshot(self) -> Dict:
        """JSON-able baseline (checkpoint extras): the lifetime
        finiteness accounting a resumed run should carry forward so
        ``healthy``/``first_nonfinite_step`` describe the RUN, not the
        process. The pending device values are not drained — only
        already-consumed history is checkpointable."""
        return {
            "n_observed": self._n_observed,
            "n_nonfinite_loss": self._n_nonfinite_loss,
            "n_nonfinite_grad": self._n_nonfinite_grad,
            "first_nonfinite_step": self.first_nonfinite_step,
        }

    def restore_snapshot(self, snap: Optional[Dict]) -> None:
        if not isinstance(snap, dict):
            return
        self._n_observed = int(snap.get("n_observed", 0))
        self._n_nonfinite_loss = int(snap.get("n_nonfinite_loss", 0))
        self._n_nonfinite_grad = int(snap.get("n_nonfinite_grad", 0))
        first = snap.get("first_nonfinite_step")
        self.first_nonfinite_step = (int(first) if first is not None
                                     else None)

    def recent_readings(self):
        """JSON-ready copies of the readings ring (flight dumps)."""
        with self._readings_lock:
            readings = list(self.readings)
        return [{"step": s, "loss": l, "grad_norm": g,
                 "loss_finite": f}
                for s, l, g, f in readings]

    def report(self) -> Dict:
        """Drain everything (blocking) and return the health summary."""
        self.poll(block=True)
        return {
            "steps_observed": self._n_observed,
            "nonfinite_loss_steps": self._n_nonfinite_loss,
            "nonfinite_grad_steps": self._n_nonfinite_grad,
            "first_nonfinite_step": self.first_nonfinite_step,
            "instability": round(self._instability, 6),
            "instability_events": self._instability_events,
            "grad_norm": summarize_window(sorted(self._norms),
                                          self._n_norms),
        }

    @property
    def healthy(self) -> bool:
        """False once any non-finite loss/grad has been seen."""
        return (self._n_nonfinite_loss == 0
                and self._n_nonfinite_grad == 0)
