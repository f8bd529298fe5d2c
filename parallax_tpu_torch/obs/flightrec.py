"""Flight recorder: always-on bounded history, dumped on incident.

A crash at step 40k is normally diagnosed by rerunning with more
logging — hours of compute to reproduce a state the process was *in*
when it died. The flight recorder inverts that: the session already
keeps the last N steps' timeline rows (obs/timeline.py), health
readings (obs/health.py) and anomaly events (obs/anomaly.py) in bounded
rings at ~zero marginal cost; this module snapshots them all into one
JSON artifact the moment something goes wrong:

  * an exception escaping a training step (``reason="exception:..."``),
  * a non-finite loss / gradient norm (``monitor_health=True``),
  * a serving deadline/SLO breach (serve/session.py),
  * an anomaly detector firing (step-time spike/shift, loss spike),
  * an explicit ``session.dump_flight()``.

Auto-dumps require ``Config(flight_dir=...)`` (a training framework
must not write files nobody asked for); ``dump()`` with an explicit
path always works. Dumps are rate-limited — one per distinct reason,
``max_dumps`` total — so a NaN storm produces one artifact, not
thousands; every suppressed trigger stays visible through the
``flightrec.suppressed.<class>`` registry counters instead of
vanishing, and each artifact carries a process-unique ``incident_id``
so fleet-correlated consumers can join it across logs and metrics.

The artifact is self-contained: trigger reason + detail, the step
rows (with the goodput account), health readings, anomaly events, the
full metrics-registry snapshot, device memory stats, and a config
summary. Every section is produced by an independent provider and
individually guarded — a poisoned device buffer failing one section
must not lose the rest of the post-mortem.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.obs.metrics import MetricsRegistry


class FlightRecorder:
    """Composes the session's bounded histories into dump artifacts.

    ``providers`` maps section name -> zero-arg callable returning a
    JSON-ready value; each is called (and guarded) at dump time only —
    the recorder itself does no per-step work.
    """

    def __init__(self, flight_dir: Optional[str] = None,
                 providers: Optional[Dict[str, Callable[[], Any]]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 max_dumps: int = 8, journal=None):
        self.flight_dir = flight_dir
        # journal-backed incident correlation: every dump
        # — and every SUPPRESSED trigger — lands in the event journal,
        # so the causal record carries the incident_id the artifact
        # does, and rate-limited incidents stay visible
        self.journal = journal
        self._providers: Dict[str, Callable[[], Any]] = dict(
            providers or {})
        self._registry = registry if registry is not None \
            else MetricsRegistry()
        self._dumps = self._registry.counter("flight.dumps")
        self._suppressed = self._registry.counter(
            "flight.dumps_suppressed")
        self._lock = threading.Lock()
        self._max_dumps = int(max_dumps)
        self._seen_reasons: set = set()
        self.dump_paths: list = []
        # incident correlation: every artifact carries a
        # process-unique incident id so fleet-wide consumers can join
        # "this crash" across logs, metrics and the artifact itself
        self._incident_seq = itertools.count(1)
        self.last_incident_id: Optional[str] = None

    def add_provider(self, name: str, fn: Callable[[], Any]) -> None:
        self._providers[name] = fn

    # -- triggers ----------------------------------------------------------

    def trigger(self, reason: str,
                detail: Optional[dict] = None) -> Optional[str]:
        """Auto-dump path (incident handlers): rate-limited, never
        raises, no-op without a configured ``flight_dir``. The reason
        KEY (text before the first ':') dedups — one artifact per
        incident class, however many steps it repeats for."""
        if not self.flight_dir:
            return None
        key = reason.split(":", 1)[0]
        with self._lock:
            if (key in self._seen_reasons
                    or len(self.dump_paths) >= self._max_dumps):
                self._suppressed.inc()
                # per-class visibility: a 9th
                # incident of a class must leave a countable trace,
                # not vanish — flightrec.suppressed.<class> names it
                self._registry.counter(
                    "flightrec.suppressed." + key).inc()
                if self.journal is not None:
                    self.journal.emit(
                        "flight", "dump_suppressed",
                        severity="warning", reason=reason, klass=key)
                return None
            # claimed BEFORE dumping so a concurrent trigger of the
            # same class cannot double-dump...
            self._seen_reasons.add(key)
        try:
            return self.dump(reason, detail=detail)
        except Exception as e:
            # the incident path must never be made worse by forensics
            parallax_log.warning("flight dump for %r failed: %s",
                                 reason, e)
            # ...but a FAILED dump (momentarily full disk, unwritable
            # dir) releases the claim: the next incident of this class
            # retries instead of being suppressed artifact-less forever
            with self._lock:
                self._seen_reasons.discard(key)
            return None

    def dump(self, reason: str = "manual", path: Optional[str] = None,
             detail: Optional[dict] = None) -> str:
        """Write one artifact; returns its path. Explicit calls raise
        on unwritable paths (the caller asked for a file); the
        ``trigger`` path guards."""
        if path is None:
            base = self.flight_dir or "."
            fname = "flight_%s_%d_%s.json" % (
                reason.split(":", 1)[0].replace("/", "_"), os.getpid(),
                time.strftime("%Y%m%d-%H%M%S"))
            path = os.path.join(base, fname)
        incident_id = "inc-%d-%d" % (os.getpid(),
                                     next(self._incident_seq))
        self.last_incident_id = incident_id
        doc: Dict[str, Any] = {
            "reason": reason,
            "incident_id": incident_id,
            "detail": detail,
            "ts": time.time(),
            "pid": os.getpid(),
            "process_index": _process_index(),
        }
        for name, fn in self._providers.items():
            try:
                doc[name] = fn()
            except Exception as e:
                # one poisoned section must not lose the post-mortem
                doc[name] = {"_error": f"{type(e).__name__}: {e}"}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            # default=str: provider values can hold np scalars, paths,
            # dtypes — stringify rather than lose the artifact
            json.dump(doc, f, indent=1, default=str)
        self._dumps.inc()
        with self._lock:
            self.dump_paths.append(path)
        if self.journal is not None:
            # emitted AFTER the artifact is written: the dump's own
            # journal_tail section shows the history that LED here,
            # and this event (carrying the same incident_id) lets any
            # later consumer join journal <-> artifact
            self.journal.emit("flight", "dump", severity="warning",
                              incident_id=incident_id, reason=reason,
                              path=path)
        parallax_log.warning("flight recorder dumped %r to %s", reason,
                             path)
        return path


def _process_index() -> int:
    """This process's rank in the default process group (0 without
    one)."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0
