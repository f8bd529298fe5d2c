"""The per-step checkpoint hook on the store (``parallax_tpu/ckpt/
hook.py``).

* **cadence**: save every ``save_ckpt_steps`` steps and/or every
  ``save_ckpt_secs`` seconds; ``ckpt_dir`` without either defaults to
  600 s, as the reference's saver did. On several ranks the seconds
  trigger is decided by rank 0 and broadcast, on a throttled step
  cadence, so every rank enters the commit barrier at the same step.
* **async saves** (``CheckPointConfig.async_save``): the dispatch thread
  issues the copies of the state to pinned host buffers (reused from
  save to save) on the step's stream, so the next step runs after them
  and cannot change what they read; a writer thread waits for the copies,
  then serializes and commits. At most one save is in flight: the next
  save and ``close()`` join the writer first, the wait counted in
  ``ckpt.async_waits`` / ``ckpt.async_wait_seconds``. On several ranks
  saves are synchronous (the commit barrier is a collective).
* **verified restore with fallback**: ``restore`` takes the store's
  newest verified checkpoint into the live leaves, in place;
  ``last_restore_info`` keeps the fallback trail and ``restored_extras``
  the manifest's extras.
* **final saves**: ``save_now`` is the preemption path, one synchronous
  save of the current state whatever the cadence, deduplicated on the
  step already saved.
* **journal**: with an ``obs.journal.EventJournal`` every save (its mode
  and seconds) and final save lands in the run's event journal.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from parallax_tpu_torch.common.config import CheckPointConfig
from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.ckpt import snapshot as snap_lib
from parallax_tpu_torch.ckpt.store import (CheckpointStore, as_leaves,
                                           process_count)


def _collective_device() -> torch.device:
    """Where a collective's tensor must lie: the current card under NCCL,
    which refuses host tensors, else the host (gloo)."""
    if torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class CheckpointHook:
    # several ranks: the seconds trigger is agreed every this many steps
    SECS_BROADCAST_EVERY = 10

    def __init__(self, config: Optional[CheckPointConfig], worker_id: int,
                 registry=None, journal=None):
        self._config = config or CheckPointConfig()
        self._worker_id = worker_id
        self._store: Optional[CheckpointStore] = None
        self._last_save_time = time.time()
        if registry is None:
            from parallax_tpu_torch.obs.metrics import MetricsRegistry
            registry = MetricsRegistry()
        self._registry = registry
        # run-event journal (obs/journal.py): saves and final saves land
        # in the run's causal record
        self._journal = journal
        self._async_waits = registry.counter("ckpt.async_waits")
        self._async_wait_s = registry.histogram("ckpt.async_wait_seconds")
        self._restore_s = registry.histogram("ckpt.restore_seconds")
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        self._async_warned = False
        # pinned host buffers of the async snapshot, reused save to save
        self._buffers: Dict[str, Any] = {}
        self.last_saved_step: Optional[int] = None
        self.last_restore_info: Optional[Dict[str, Any]] = None
        self.last_restore_seconds: Optional[float] = None
        if self._config.ckpt_dir:
            if (self._config.save_ckpt_steps is None
                    and self._config.save_ckpt_secs is None):
                self._config.save_ckpt_secs = 600.0
                parallax_log.info(
                    "ckpt_dir set without save_ckpt_steps/secs; "
                    "defaulting to save_ckpt_secs=600")
            self._store = CheckpointStore(
                self._config.ckpt_dir, max_to_keep=self._config.max_to_keep,
                registry=registry)

    @property
    def enabled(self) -> bool:
        return self._store is not None

    @property
    def store(self) -> Optional[CheckpointStore]:
        return self._store

    def _decide_due(self, step: int) -> bool:
        """Is a save due at ``step``: the same answer on every rank."""
        cfg = self._config
        due_steps = bool(cfg.save_ckpt_steps
                         and step % cfg.save_ckpt_steps == 0)
        if not cfg.save_ckpt_secs:
            return due_steps
        late = time.time() - self._last_save_time >= cfg.save_ckpt_secs
        if process_count() == 1:
            return due_steps or late
        if step % self.SECS_BROADCAST_EVERY != 0:
            return due_steps
        flag = torch.tensor([int(due_steps or late)], dtype=torch.int32,
                            device=_collective_device())
        torch.distributed.broadcast(flag, src=0)
        return bool(flag.item())

    # -- save --------------------------------------------------------------

    def maybe_save(self, step: int, state,
                   extras_fn: Optional[Callable[[], dict]] = None) -> bool:
        """Save when the cadence says so. ``state``: the state's ``Leaf``
        records or a tree (``store.as_leaves``), or a callable giving
        them (called only when a save is due)."""
        if not self.enabled or not self._decide_due(step):
            return False
        self._save(step, state() if callable(state) else state,
                   extras_fn() if extras_fn is not None else None)
        return True

    def save_now(self, step: int, leaves, extras: Optional[dict] = None,
                 reason: str = "explicit") -> Optional[str]:
        """One synchronous save out of cadence (preemption, final saves).
        Never raises: a failed last-gasp save must not mask the shutdown
        that called it. Returns the checkpoint directory or None."""
        if not self.enabled:
            return None
        if process_count() > 1:
            # ranks cannot agree on a step from a signal handler, and an
            # unmatched commit barrier would hang the eviction grace
            parallax_log.warning(
                "checkpoint save_now(%s) skipped on a multi-process run: "
                "ranks cannot agree on a step from a signal handler. "
                "Last agreed checkpoint: step %s", reason,
                self.last_saved_step)
            return None
        try:
            self._join_writer(count=False)
            if self.last_saved_step == int(step):
                return None  # already durable at this step
            d = self._store.save(int(step), leaves, extras=extras)
            self.last_saved_step = int(step)
            self._last_save_time = time.time()
            parallax_log.warning("checkpoint save_now(%s) committed step "
                                 "%d", reason, int(step))
            if self._journal is not None:
                self._journal.emit("ckpt", "save_now", severity="warning",
                                   step=int(step), reason=reason)
            return d
        except BaseException as e:
            parallax_log.error("checkpoint save_now(%s) failed: %s",
                               reason, e)
            return None

    def _save(self, step: int, leaves, extras: Optional[dict]) -> None:
        use_async = bool(self._config.async_save)
        if use_async and process_count() > 1:
            if not self._async_warned:
                self._async_warned = True
                parallax_log.warning(
                    "async_save requested on a multi-process run; saving "
                    "synchronously (the commit barrier is a collective and "
                    "cannot run on a background thread next to training "
                    "collectives)")
            use_async = False
        if not use_async:
            self._join_writer(count=False)
            t0 = time.perf_counter()
            self._store.save(step, leaves, extras=extras)
            self.last_saved_step = int(step)
            self._last_save_time = time.time()
            parallax_log.info("saved checkpoint at step %d", step)
            if self._journal is not None:
                self._journal.emit(
                    "ckpt", "save", step=int(step), mode="sync",
                    save_s=round(time.perf_counter() - t0, 4))
            return
        # at most one save in flight: join (and surface) the last commit
        self._join_writer(count=True)
        snap = snap_lib.host_snapshot(as_leaves(leaves), step,
                                      self._buffers)

        def _commit():
            try:
                self._store.save(step, snap.host_leaves(), extras=extras)
                self.last_saved_step = int(step)
            except BaseException as e:  # surfaced at the next join
                self._writer_error = e

        self._writer = threading.Thread(
            target=_commit, name="parallax-ckpt-writer", daemon=True)
        self._writer.start()
        self._last_save_time = time.time()
        parallax_log.info("dispatched checkpoint save at step %d (async "
                          "commit)", step)
        if self._journal is not None:
            self._journal.emit("ckpt", "save", step=int(step),
                               mode="async_dispatch")

    def _join_writer(self, count: bool) -> None:
        w = self._writer
        if w is not None and w.is_alive():
            t0 = time.perf_counter()
            w.join()
            if count:
                self._async_waits.inc()
                self._async_wait_s.record(time.perf_counter() - t0)
        self._writer = None
        if self._writer_error is not None:
            e, self._writer_error = self._writer_error, None
            parallax_log.error("async checkpoint commit failed: %s", e)

    # -- restore -----------------------------------------------------------

    def restore(self, leaves) -> Optional[int]:
        """Restore the newest verified checkpoint into ``leaves`` in place
        (falling back across torn and corrupt ones); returns its step, or
        None when nothing is restorable."""
        if not self.enabled:
            return None
        t0 = time.perf_counter()
        out = self._store.restore_latest(leaves)
        if out is None:
            return None
        _, step, info = out
        self.last_restore_info = info
        self.last_restore_seconds = time.perf_counter() - t0
        self._restore_s.record(self.last_restore_seconds)
        return step

    @property
    def restored_extras(self) -> Dict[str, Any]:
        if self.last_restore_info is None or self._store is None:
            return {}
        return self._store.restore_extras(self.last_restore_info["step"])

    def stats(self) -> Dict[str, Any]:
        """JSON-ready summary."""
        return {
            "enabled": self.enabled,
            "ckpt_dir": self._config.ckpt_dir,
            "async_save": bool(self._config.async_save),
            "max_to_keep": self._config.max_to_keep,
            "last_saved_step": self.last_saved_step,
            "writer_pending": bool(self._writer is not None
                                   and self._writer.is_alive()),
            "restore_info": self.last_restore_info,
            "step_dirs": self._store.all_steps() if self.enabled else [],
        }

    def close(self):
        self._join_writer(count=False)
