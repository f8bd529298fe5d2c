"""Deterministic fault injection for the serving fleet (the chaos
harness; ``parallax_tpu/serve/faults.py``).

Production failure modes — a replica process dying, a straggling step,
silently corrupted output, an overloaded admission queue — are
injected as *armed hooks* consulted at fixed points in the serving
loops, so tests assert exact recovery behavior instead of hoping a
random killer lands somewhere interesting:

* **crash** — the replica's next dispatch raises
  :class:`ReplicaCrash` (``fatal=True``): the loop fails everything it
  holds with :class:`~parallax_tpu_torch.serve.batcher.ReplicaUnavailable`
  and dies, exactly like a process loss viewed from the router. Armed
  once, fires once — dead is dead.
* **stall** — the next ``times`` dispatches sleep ``seconds`` before
  serving (a straggler / GC pause / preempted host). Requests still
  complete; the replica's heartbeat goes stale, which is what the
  router's probe must catch.
* **nan** — the next ``times`` one-shot batches have every float
  output leaf overwritten with NaN *after* the device step (silent
  numeric corruption). With ``ServeSession(check_outputs=True)`` the
  session detects it and fails the batch with the retryable
  ``ReplicaUnavailable`` (feeding the router's error-rate signal);
  without the check the corruption flows to clients — deliberately,
  so tests can prove the check is what saves them. Continuous-decode
  programs emit int tokens, not floats; chaos for decode replicas uses
  crash/stall.
* **saturate** — admission on this replica raises
  :class:`~parallax_tpu_torch.serve.batcher.ServeOverloaded` until cleared
  (a full queue without having to actually fill one): the router must
  spill to other replicas and the fleet must shed only when EVERY
  replica is saturated.

Hooks are keyed by ``replica_id`` (the fleet wires one injector into
every replica it builds); arming is thread-safe and every firing is
appended to ``injector.log`` for assertions and flight artifacts.
An injector with nothing armed costs one dict lookup per dispatch.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.serve.batcher import ServeError, ServeOverloaded


class InjectedFault(ServeError):
    """Base class of injected faults (distinguishable from organic
    failures in logs and flight artifacts)."""


class ReplicaCrash(InjectedFault):
    """Injected replica death. ``fatal``: the serving loop that sees it
    stops and fails everything it holds; ``retryable``: nothing was
    served, so failed-over work cannot be double-served."""

    retryable = True
    fatal = True


class _Armed:
    __slots__ = ("kind", "seconds", "times")

    def __init__(self, kind: str, seconds: float, times: Optional[int]):
        self.kind = kind
        self.seconds = float(seconds)
        self.times = times  # None = until cleared


class FaultInjector:
    """Armable fault hooks, consulted by the serving loops.

    ``arm(replica_id, kind, ...)`` schedules a fault; the serving
    internals call :meth:`on_dispatch` (once per batch / scheduler
    iteration) and :meth:`on_admission` (per submit), which fire
    whatever is armed for that replica. ``kind`` is one of ``crash``,
    ``stall``, ``nan``, ``saturate`` (module docstring).
    """

    KINDS = ("crash", "stall", "nan", "saturate")

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: Dict[Any, Dict[str, _Armed]] = {}
        # (replica_id, kind, perf_counter seconds) per firing
        self.log: List[Tuple[Any, str, float]] = []

    # -- arming ------------------------------------------------------------

    def arm(self, replica_id, kind: str, seconds: float = 0.0,
            times: Optional[int] = 1) -> None:
        """Arm one fault on one replica. ``times`` bounds how many
        firings (None = until :meth:`clear`); ``seconds`` is the stall
        duration (ignored by the other kinds). A crash is always
        one-shot — the replica does not survive to fire it again."""
        if kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; "
                             f"one of {self.KINDS}")
        if kind == "stall" and seconds <= 0:
            raise ValueError("stall needs seconds > 0")
        if kind == "crash":
            times = 1
        with self._lock:
            self._armed.setdefault(replica_id, {})[kind] = _Armed(
                kind, seconds, times)
        parallax_log.warning("fault armed: %s on replica %r%s", kind,
                             replica_id,
                             f" ({seconds}s)" if kind == "stall" else "")

    def clear(self, replica_id=None, kind: Optional[str] = None) -> None:
        """Disarm faults: one kind on one replica, every kind on one
        replica (``kind=None``), or everything (``replica_id=None``)."""
        with self._lock:
            if replica_id is None:
                self._armed.clear()
            elif kind is None:
                self._armed.pop(replica_id, None)
            else:
                self._armed.get(replica_id, {}).pop(kind, None)

    def fired(self, kind: Optional[str] = None) -> int:
        """How many faults have fired (optionally of one kind)."""
        with self._lock:
            return sum(1 for _, k, _t in self.log
                       if kind is None or k == kind)

    # -- hooks (called by the serving loops) -------------------------------

    def _take(self, replica_id, kind: str) -> Optional[_Armed]:
        with self._lock:
            spec = self._armed.get(replica_id, {}).get(kind)
            if spec is None:
                return None
            if spec.times is not None:
                spec.times -= 1
                if spec.times <= 0:
                    del self._armed[replica_id][kind]
            self.log.append((replica_id, kind, time.perf_counter()))
        return spec

    def on_dispatch(self, replica_id) -> Optional[str]:
        """Dispatch-point hook: raises :class:`ReplicaCrash` when a
        crash is armed, sleeps through an armed stall, and returns
        ``"nan"`` when output corruption is armed (the one-shot session
        applies it after the device step). Returns None otherwise."""
        if not self._armed:
            return None
        if self._take(replica_id, "crash") is not None:
            raise ReplicaCrash(
                f"injected crash on replica {replica_id!r}")
        stall = self._take(replica_id, "stall")
        if stall is not None:
            parallax_log.warning("injected stall: replica %r sleeping "
                                 "%.2fs", replica_id, stall.seconds)
            time.sleep(stall.seconds)
        if self._take(replica_id, "nan") is not None:
            return "nan"
        return None

    def on_admission(self, replica_id) -> None:
        """Admission-point hook: raises ``ServeOverloaded`` while a
        ``saturate`` fault is armed (deterministic full-queue)."""
        if not self._armed:
            return
        if self._take(replica_id, "saturate") is not None:
            raise ServeOverloaded(
                f"injected saturation on replica {replica_id!r}")


__all__ = ["FaultInjector", "InjectedFault", "ReplicaCrash"]
