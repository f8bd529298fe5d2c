"""Live telemetry export: Prometheus-text snapshots over localhost HTTP
(the JAX package's ``obs/export.py``).

The JSONL sink (obs/metrics.py) is a file a scraper tails after the
fact; this is the live endpoint a monitoring stack polls while the
process serves. One stdlib-only HTTP server (no new dependencies)
renders every registered registry — for a fleet, the fleet registry
PLUS each replica's — as Prometheus text exposition on a localhost
port:

    exporter = TelemetryExporter.for_registry(session.metrics)
    exporter.start()                  # port 0 = OS-assigned
    # curl http://127.0.0.1:<exporter.port>/metrics
    exporter.stop()

or, fleet-aggregated (one endpoint, ``source=`` labels per replica)::

    exporter = fleet.start_exporter()   # ServeFleet convenience

Rendering rules (``render_prometheus``): numeric counters/gauges become
``parallax_<name>{source="..."} value`` samples; window-summary dicts
(histograms, the lazy ``serve.timeline.*`` gauges) expand into
``_count`` / ``_mean`` / ``_max`` samples plus ``quantile``-labeled
p50/p95 samples; None and non-numeric values are skipped, never
fabricated. The ``serve.slo.*`` burn-rate gauges (obs/reqtrace.py) ride
along like any other gauge, so deadline-miss budget and p99 margin are
scrapeable live.

Snapshots are taken lazily per GET (the zero-steady-state-cost
pattern): an idle exporter costs one parked thread. ``/healthz``
answers a JSON liveness probe; the server binds localhost only —
exposure beyond the host is a deployment concern, not this module's.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.obs.metrics import MetricsRegistry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

# summary-dict fields rendered as suffixed samples / quantile labels
_SUMMARY_FIELDS = (("count", "_count"), ("mean", "_mean"),
                   ("max", "_max"))
_QUANTILES = (("p50", "0.5"), ("p95", "0.95"))


def _metric_name(name: str, prefix: str) -> str:
    return _NAME_RE.sub("_", f"{prefix}_{name}")


def _labels(source: str, extra: str = "") -> str:
    parts = []
    if source:
        parts.append(f'source="{source}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus(snapshots: Dict[str, Dict],
                      prefix: str = "parallax",
                      alerts: Optional[list] = None) -> str:
    """``{source: registry_snapshot}`` -> Prometheus text exposition.
    Deterministic ordering (sorted metric, then source) so scrapes
    diff cleanly.

    ``alerts``: rows from
    ``AlertEngine.prometheus_alerts()`` render as a dedicated
    ``<prefix>_alerts`` section — one sample per rule,
    ``{alert=,severity=,state=}`` labeled, value 1 while firing — so
    a monitoring stack needs no recording rules to see firings."""
    # metric name -> [(labels, value)]
    samples: Dict[str, list] = {}

    def put(name, labels, value):
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            return
        samples.setdefault(name, []).append((labels, float(value)))

    for source in sorted(snapshots):
        snap = snapshots[source] or {}
        for key in sorted(snap):
            value = snap[key]
            base = _metric_name(key, prefix)
            if isinstance(value, dict):
                for field, suffix in _SUMMARY_FIELDS:
                    put(base + suffix, _labels(source),
                        value.get(field))
                for field, q in _QUANTILES:
                    put(base, _labels(source, f'quantile="{q}"'),
                        value.get(field))
            else:
                put(base, _labels(source), value)

    for row in alerts or ():
        put(f"{prefix}_alerts",
            _labels("", f'alert="{row.get("alert", "")}",'
                        f'severity="{row.get("severity", "")}",'
                        f'state="{row.get("state", "")}"'),
            row.get("value"))

    lines = []
    for name in sorted(samples):
        lines.append(f"# TYPE {name} gauge")
        for labels, value in samples[name]:
            lines.append(f"{name}{labels} {value}")
    return "\n".join(lines) + "\n"


class TelemetryExporter:
    """Serve ``snapshot_fn() -> {source: registry_snapshot}`` as
    Prometheus text on ``http://host:port/metrics``."""

    def __init__(self, snapshot_fn: Callable[[], Dict[str, Dict]],
                 port: int = 0, host: str = "127.0.0.1",
                 prefix: str = "parallax",
                 alerts_fn: Optional[Callable[[], list]] = None):
        self._snapshot_fn = snapshot_fn
        # zero-arg provider of AlertEngine.prometheus_alerts() rows;
        # sampled lazily per GET like the snapshot itself
        self._alerts_fn = alerts_fn
        self._host = host
        self._requested_port = int(port)
        self._prefix = prefix
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    @classmethod
    def for_registry(cls, registry: MetricsRegistry,
                     source: str = "", **kw) -> "TelemetryExporter":
        return cls(lambda: {source: registry.snapshot()}, **kw)

    @property
    def url(self) -> Optional[str]:
        if self.port is None:
            return None
        return f"http://{self._host}:{self.port}/metrics"

    def start(self) -> "TelemetryExporter":
        if self._server is not None:
            return self
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass  # a scrape per second must not spam the log

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/healthz",):
                    self._send(200, json.dumps({"ok": True}).encode(),
                               "application/json")
                    return
                if self.path not in ("/", "/metrics"):
                    self._send(404, b"not found\n", "text/plain")
                    return
                try:
                    # snapshot per GET: lazy gauges (serve.timeline.*)
                    # are priced at scrape time, never in steady state
                    alerts = (exporter._alerts_fn()
                              if exporter._alerts_fn else None)
                    text = render_prometheus(exporter._snapshot_fn(),
                                             exporter._prefix,
                                             alerts=alerts)
                except Exception as e:  # a scrape must never crash
                    self._send(500, f"# snapshot failed: "
                                    f"{type(e).__name__}: {e}\n"
                               .encode(), "text/plain")
                    return
                self._send(200, text.encode(),
                           "text/plain; version=0.0.4; charset=utf-8")

        self._server = ThreadingHTTPServer(
            (self._host, self._requested_port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="parallax-telemetry-exporter", daemon=True)
        self._thread.start()
        parallax_log.info("telemetry exporter serving %s", self.url)
        return self

    def stop(self) -> None:
        """Idempotent shutdown."""
        server, self._server = self._server, None
        if server is None:
            return
        server.shutdown()
        server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    close = stop

    def __enter__(self) -> "TelemetryExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["TelemetryExporter", "render_prometheus"]
