"""Observability: the kill switch, the metrics registry and its JSONL
sink, host spans, request-scoped records, and the training and serving
sessions' monitors — health, the step timeline, anomaly detection, the
flight recorder, cross-rank aggregation, the goodput ledger, the event
journal, alerting, the Prometheus exporter, the memory watch, the
numerics observatory and the profile parser (``xprof``: per-op and
per-collective attribution of ``torch.profiler`` traces) — the JAX
package's ``obs/``."""

from parallax_tpu_torch.obs import (_state, aggregate, alerts, anomaly,
                                    export, flightrec, goodput, health,
                                    journal, memwatch, metrics, numwatch,
                                    reqtrace, timeline, trace, xprof)
from parallax_tpu_torch.obs._state import disable, enable, is_enabled
from parallax_tpu_torch.obs.alerts import (AlertEngine, AlertRule,
                                           builtin_rules)
from parallax_tpu_torch.obs.anomaly import AnomalyEvent, AnomalyMonitor
from parallax_tpu_torch.obs.export import (TelemetryExporter,
                                           render_prometheus)
from parallax_tpu_torch.obs.flightrec import FlightRecorder
from parallax_tpu_torch.obs.goodput import GoodputLedger
from parallax_tpu_torch.obs.health import HealthMonitor, device_memory_stats
from parallax_tpu_torch.obs.journal import EventJournal
from parallax_tpu_torch.obs.memwatch import MemWatch
from parallax_tpu_torch.obs.metrics import (JsonlSink, MetricsRegistry,
                                            PipelineStats)
from parallax_tpu_torch.obs.numwatch import DriftSentinel, NumericsMonitor
from parallax_tpu_torch.obs.timeline import StepTimeline
from parallax_tpu_torch.obs.trace import export_chrome_trace, span

__all__ = ["metrics", "trace", "reqtrace", "enable", "disable",
           "is_enabled", "_state", "aggregate", "alerts", "anomaly",
           "export", "flightrec", "goodput", "health", "journal",
           "memwatch", "numwatch", "timeline", "xprof", "AlertEngine",
           "AlertRule",
           "builtin_rules", "AnomalyEvent", "AnomalyMonitor",
           "TelemetryExporter", "render_prometheus", "FlightRecorder",
           "GoodputLedger", "HealthMonitor", "device_memory_stats",
           "EventJournal", "MemWatch", "JsonlSink", "MetricsRegistry",
           "PipelineStats", "DriftSentinel", "NumericsMonitor",
           "StepTimeline", "export_chrome_trace", "span"]
