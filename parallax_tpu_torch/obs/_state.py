"""Process-wide observability kill switch.

One boolean, read per call by every instrument (`trace.span`, counters,
gauges, histograms, request records): `disable()` turns the whole layer
into near-free no-ops. Env ``PARALLAX_OBS=0`` disables at import.

Kept in its own tiny module so `trace` and `metrics` share the flag
without importing each other.
"""

from __future__ import annotations

import os

enabled: bool = os.environ.get("PARALLAX_OBS", "1") != "0"


def enable() -> None:
    global enabled
    enabled = True


def disable() -> None:
    global enabled
    enabled = False


def is_enabled() -> bool:
    return enabled
