"""Engine and build caching across rebuilds and relaunches
(``parallax_tpu.compile.cache``).

Two cache layers with different lifetimes:

* ``EngineCache`` (in-process): built ``Engine`` objects keyed by the
  plan and the bucketed example-batch signature. A cached engine keeps
  its captured graphs, so coming back to a plan is a dictionary lookup
  with no capture.

* The kernel build directory (on disk, across processes):
  ``Config(compilation_cache_dir=...)`` points ``ops/_cuda.py``'s build
  at a directory of the caller's. nvcc's output there is named by a hash
  of the source and the flags, so a relaunch with the same sources loads
  the libraries instead of building them, and a stale entry can only
  miss, never be loaded for another source. It is the port's only
  compile that outlives a process: CUDA graphs are captured anew in
  every process, as they hold device addresses.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional, Tuple

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.obs import metrics as obs_metrics


def enable_persistent_cache(cache_dir: str) -> bool:
    """Build and keep the CUDA kernels under ``cache_dir``.

    Process-wide (the kernel libraries are). Returns False, with a
    warning and the build directory left as it was, where the directory
    cannot be made or written; never raises."""
    from parallax_tpu_torch.ops import _cuda
    path = Path(cache_dir).expanduser()
    try:
        path.mkdir(parents=True, exist_ok=True)
        if not os.access(path, os.W_OK):
            raise PermissionError(f"{path} is not writable")
    except OSError as e:
        parallax_log.warning(
            "compilation_cache_dir=%s cannot be used (%s); the kernels "
            "stay in %s", cache_dir, e, _cuda.BUILD_DIR)
        return False
    _cuda.BUILD_DIR = path
    parallax_log.info("kernel build cache at %s", path)
    return True


class EngineCache:
    """Built engines keyed by ``(plan..., batch-signature)``.

    The session keys with the bucketed example-batch signature, so a
    ragged and a full example batch of one bucket key identically.
    Hit/miss counts flow through the session's registry
    (``session.engine_cache.*``)."""

    def __init__(self, metrics: Optional[obs_metrics.MetricsRegistry]
                 = None):
        registry = metrics if metrics is not None \
            else obs_metrics.MetricsRegistry()
        self._hits = registry.counter("session.engine_cache.hits")
        self._misses = registry.counter("session.engine_cache.misses")
        self._engines: Dict[Tuple, object] = {}

    def get(self, key: Tuple):
        eng = self._engines.get(key)
        if eng is not None:
            self._hits.inc()
        else:
            self._misses.inc()
        return eng

    def put(self, key: Tuple, engine) -> None:
        self._engines[key] = engine

    def prune(self, keep) -> int:
        """Drop every cached engine except ``keep`` and return how many
        were dropped (their graphs and pools are freed when no caller
        holds them)."""
        dropped = [k for k, e in self._engines.items() if e is not keep]
        for k in dropped:
            del self._engines[k]
        return len(dropped)

    def engines(self):
        return list(self._engines.values())

    def __len__(self) -> int:
        return len(self._engines)
