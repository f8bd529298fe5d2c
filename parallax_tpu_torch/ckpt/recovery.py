"""NaN/divergence auto-recovery: roll back instead of dying
(``parallax_tpu/ckpt/recovery.py``).

The session keeps an in-memory last-good snapshot of the state (a host
copy, ``ckpt/snapshot.py``), taken every ``snapshot_every_steps`` steps
after a finite one. When a step gives a non-finite loss or gradient norm
it

1. copies the snapshot back into the live state, in place (a captured
   step graph keeps reading the same buffers),
2. skips the offending batch: the data cursor keeps advancing while the
   step counter rewinds,
3. calls the rollback hooks (``session.set_rollback_hook``),
4. and gives up after ``max_retries`` consecutive non-finite steps with
   :class:`RecoverySurrender`.

Recovery turns ``monitor_health`` on and makes the dispatch thread read
each step's ``loss_finite`` and ``grad_norm``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.ckpt.snapshot import (HostSnapshot, Leaf,
                                              host_snapshot)

__all__ = ["RecoveryPolicy", "RecoverySurrender", "host_snapshot",
           "restore_snapshot"]


class RecoverySurrender(RuntimeError):
    """Auto-recovery exhausted its retry budget: every rollback and skip
    reproduced a non-finite step."""


def restore_snapshot(snap: HostSnapshot) -> int:
    """``snap.restore()``: the snapshot back into its live leaves."""
    return snap.restore()


class RecoveryPolicy:
    """Owns the last-good snapshot and the retry budget."""

    def __init__(self, config, registry=None,
                 on_rollback: Optional[Callable[[int], None]] = None):
        self.config = config
        if registry is None:
            from parallax_tpu_torch.obs.metrics import MetricsRegistry
            registry = MetricsRegistry()
        self._rollbacks = registry.counter("recovery.rollbacks")
        self._snapshots = registry.counter("recovery.snapshots")
        self._snapshot_s = registry.histogram("recovery.snapshot_seconds")
        self._surrenders = registry.counter("recovery.surrenders")
        self.on_rollback = on_rollback
        self._snap: Optional[HostSnapshot] = None
        self._buffers: Dict[str, Any] = {}
        # consecutive non-finite steps since the last finite one
        self.consecutive_failures = 0
        self.total_rollbacks = 0

    @property
    def snapshot_step(self) -> Optional[int]:
        return self._snap.step if self._snap is not None else None

    @property
    def snapshot(self) -> Optional[HostSnapshot]:
        """The last-good snapshot (its host copies by leaf name), or
        None before the first."""
        return self._snap

    def maybe_snapshot(self, step: int, leaves: List[Leaf],
                       force: bool = False) -> bool:
        """Refresh the last-good snapshot when the cadence is due or
        ``force``. Call it only on a state known finite."""
        every = int(self.config.snapshot_every_steps)
        if not force and self._snap is not None and step % every != 0:
            return False
        t0 = time.perf_counter()
        self._snap = host_snapshot(leaves, step, self._buffers)
        self._snapshots.inc()
        self._snapshot_s.record(time.perf_counter() - t0)
        return True

    def note_good_step(self) -> None:
        """A finite step: the retry budget resets."""
        self.consecutive_failures = 0

    def rollback(self, step: int, kind: str) -> int:
        """A non-finite ``kind`` ('loss' or 'grad') at ``step``: copy the
        last-good snapshot back into the live state and return its step,
        or raise :class:`RecoverySurrender` once the budget is spent."""
        if self._snap is None:
            raise RecoverySurrender(
                f"non-finite {kind} at step {step} with no last-good "
                f"snapshot to roll back to")
        self.consecutive_failures += 1
        if self.consecutive_failures > int(self.config.max_retries):
            self._surrenders.inc()
            raise RecoverySurrender(
                f"non-finite {kind} persisted through "
                f"{self.consecutive_failures - 1} rollback+skip "
                f"attempt(s) (max_retries={self.config.max_retries}); "
                f"surrendering at step {step}")
        self.total_rollbacks += 1
        self._rollbacks.inc()
        parallax_log.warning(
            "recovery: non-finite %s at step %d — rolling back to "
            "last-good step %d and skipping the batch (attempt %d/%d)",
            kind, step, self._snap.step, self.consecutive_failures,
            int(self.config.max_retries))
        if self.on_rollback is not None:
            try:
                self.on_rollback(self.consecutive_failures)
            except Exception as e:
                parallax_log.warning("rollback hook failed: %s", e)
        return self._snap.restore()

    def stats(self) -> dict:
        return {
            "snapshot_step": self.snapshot_step,
            "snapshot_nbytes": (self._snap.nbytes
                                if self._snap is not None else 0),
            "total_rollbacks": self.total_rollbacks,
            "consecutive_failures": self.consecutive_failures,
            "max_retries": int(self.config.max_retries),
            "snapshot_every_steps": int(self.config.snapshot_every_steps),
        }
