"""Observability for the serving slice: the kill switch, the metrics
registry, host spans and request-scoped records."""

from parallax_tpu_torch.obs import _state, metrics, reqtrace, trace
from parallax_tpu_torch.obs._state import disable, enable, is_enabled

__all__ = ["metrics", "trace", "reqtrace", "enable", "disable",
           "is_enabled", "_state"]
