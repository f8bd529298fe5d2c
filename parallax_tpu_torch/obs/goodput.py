"""Run-lifetime goodput/badput ledger: where did the wall clock go?

The step timeline (obs/timeline.py) partitions ONE step's wall time;
this module partitions the RUN's — across restarts, rollbacks and
preemptions — into productive step time vs named badput classes:

  ==================  =================================================
  class               meaning
  ==================  =================================================
  compile_warmup      jit tracing/compile + AOT warmup + process
                      startup (imports) when the run anchor is known
  ckpt_stall          host time blocked on checkpoint saves (sync save
                      wall, async host-snapshot + bounded-staleness
                      joins)
  restore_replay      restore-verify wall + data-cursor replay/skip
                      after a restart
  rollback_discarded  step time whose work a NaN rollback threw away
                      (ckpt/recovery.py rewinds; those steps trained
                      nothing)
  data_wait           input stall: the per-step ``data_wait_ms`` lane
                      summed over the run
  eviction_downtime   wall time between attempts: SIGKILL/preemption
                      to the next process's run anchor (includes the
                      not-yet-checkpointed tail the restart lost)
  unattributed        the explicit residual — host overhead outside
                      steps that no class above measured
  ==================  =================================================

The invariant is the timeline's: ``productive + sum(badput) == wall``
**by construction** — ``unattributed`` is computed as the exact
remainder, never hidden (it may go slightly negative when an
overlapped measurement double-counts; that skew is visible, not
absorbed). Cumulative totals persist through the checkpoint manifest
extras (``snapshot()`` / ``restore_snapshot()``), so a resumed run
reports goodput across attempts.

This module is also the single owner of per-step goodput math:
:func:`step_goodput` is the window account that used to live on
``StepTimeline.goodput()`` (which delegates here), so its keys
keep their meaning while run-lifetime and per-step views can never
disagree on the arithmetic.

Kill switch: the session constructs a ledger only when the obs layer
is enabled (structural — no object, no gauges, no accounting);
``on_step`` is additionally a per-call no-op under ``obs.disable()``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from parallax_tpu_torch.obs import _state
from parallax_tpu_torch.obs.metrics import MetricsRegistry

BADPUT_CLASSES = ("compile_warmup", "ckpt_stall", "restore_replay",
                  "rollback_discarded", "data_wait",
                  "eviction_downtime")

# ring of recent per-step walls so a rollback can refund the ACTUAL
# time of the discarded steps, not a mean-based estimate
_STEP_RING = 1024


def step_goodput(timeline) -> Dict:
    """The per-step goodput account over a StepTimeline's rolling
    window: per-phase mean milliseconds and fraction of mean wall
    time, plus MFU. JSON-ready (flight dumps). One owner of
    this math — ``StepTimeline.goodput()`` is a thin delegate."""
    from parallax_tpu_torch.obs.timeline import COMPONENTS
    rows = timeline.rows()
    if not rows:
        return {"steps": 0}
    n = len(rows)
    wall_mean = sum(r["wall_ms"] for r in rows) / n
    phases = {}
    fractions = {}
    for comp in COMPONENTS + ("device_est_ms",):
        mean = sum(r[comp] for r in rows) / n
        phases[comp] = round(mean, 4)
        fractions[comp] = (round(mean / wall_mean, 4)
                           if wall_mean > 0 else None)
    mfus = [r["mfu"] for r in rows if r["mfu"] is not None]
    return {
        "steps": n,
        "wall_ms_mean": round(wall_mean, 4),
        "phase_ms_mean": phases,
        "phase_frac": fractions,
        "mfu_mean": (round(sum(mfus) / len(mfus), 4)
                     if mfus else None),
        "flops_per_step": timeline._flops_per_step,
        "peak_flops_total": timeline._peak_flops_total,
    }


class GoodputLedger:
    """Cumulative run-wall partition, persistent across attempts.

    ``run_epoch`` (env ``PARALLAX_RUN_EPOCH`` via the session) anchors
    the wall clock at process SPAWN rather than session construction,
    so import/startup time is accounted (as compile_warmup) instead of
    leaking — that is what lets the chaos guard's parent-measured wall
    and the ledger's agree to within 5%.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 journal=None, run_epoch: Optional[float] = None):
        self._lock = threading.Lock()
        self._journal = journal
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        now = time.time()
        self._t0 = now
        self._badput: Dict[str, float] = {c: 0.0
                                          for c in BADPUT_CLASSES}
        self._productive_s = 0.0
        self._steps = 0
        # prior attempts (restored from checkpoint extras)
        self._prior_wall_s = 0.0
        self._attempts = 1
        self._recent: list = []  # (step, productive_s, data_wait_s)
        if run_epoch is not None and float(run_epoch) < now:
            # process startup (imports, device init) before the ledger
            # existed: real wall the run paid before any step could run
            self._badput["compile_warmup"] += now - float(run_epoch)
            self._t0 = float(run_epoch)
        g = self.registry.gauge
        g("ops.goodput_fraction").set_fn(self.goodput_fraction)
        g("ops.wall_s").set_fn(self.wall_s)
        g("ops.badput_s").set_fn(
            lambda: round(sum(self._badput.values()), 3))
        g("ops.attempts").set_fn(lambda: self._attempts)

    # -- per-step inner partition -----------------------------------------

    def on_step(self, row: Optional[dict]) -> None:
        """Fold one timeline row (the dict ``record_step`` returned)
        into the run account: wall minus the data-wait lane is
        productive; data wait is badput."""
        if row is None or not _state.enabled:
            return
        data_wait_s = row["data_wait_ms"] * 1e-3
        productive_s = max(0.0, row["wall_ms"] * 1e-3 - data_wait_s)
        with self._lock:
            self._productive_s += productive_s
            self._badput["data_wait"] += data_wait_s
            self._steps += 1
            self._recent.append((int(row["step"]), productive_s,
                                 data_wait_s))
            if len(self._recent) > _STEP_RING:
                del self._recent[:len(self._recent) - _STEP_RING]

    # -- badput producers --------------------------------------------------

    def note_badput(self, cls: str, seconds: float,
                    carve_from_productive: bool = False) -> None:
        """Attribute ``seconds`` of wall to a named badput class.

        ``carve_from_productive``: for badput paid INSIDE a step's
        dispatch-to-dispatch wall (checkpoint stalls) — the step
        account already booked that time as productive, so it is
        moved, not added twice."""
        if cls not in self._badput:
            raise ValueError(f"unknown badput class {cls!r}; "
                             f"one of {BADPUT_CLASSES}")
        if seconds <= 0 or not _state.enabled:
            return
        with self._lock:
            self._badput[cls] += float(seconds)
            if carve_from_productive:
                self._productive_s = max(
                    0.0, self._productive_s - float(seconds))

    def on_rollback(self, to_step: int) -> float:
        """A recovery rollback rewound to ``to_step``: the rewound
        steps trained nothing — move their measured productive time
        into ``rollback_discarded``. Returns the seconds moved.

        ``to_step`` is the restored snapshot's step in the session's
        post-increment numbering (the state BEFORE running that step),
        so entries at ``step >= to_step`` are the discarded ones."""
        if not _state.enabled:
            return 0.0
        moved = 0.0
        with self._lock:
            keep = []
            for step, productive_s, data_wait_s in self._recent:
                if step >= int(to_step):
                    moved += productive_s
                else:
                    keep.append((step, productive_s, data_wait_s))
            self._recent = keep
            self._productive_s = max(0.0, self._productive_s - moved)
            self._badput["rollback_discarded"] += moved
        return moved

    # -- persistence (checkpoint manifest extras) --------------------------

    def snapshot(self) -> Dict:
        """Cumulative totals as of NOW, JSON-ready — committed inside
        the checkpoint manifest so a resumed run continues the
        account."""
        with self._lock:
            return {
                "wall_s": round(self._prior_wall_s
                                + (time.time() - self._t0), 6),
                "productive_s": round(self._productive_s, 6),
                "badput": {c: round(v, 6)
                           for c, v in self._badput.items()},
                "steps": self._steps,
                "attempts": self._attempts,
                "saved_at": time.time(),
            }

    def restore_snapshot(self, snap: Optional[Dict],
                         restore_s: float = 0.0,
                         replay_s: float = 0.0) -> None:
        """Adopt a previous attempt's totals. The gap between its
        ``saved_at`` and THIS attempt's run anchor is eviction
        downtime (it contains both the dead air and the lost
        not-yet-checkpointed tail); restore/replay wall is its own
        class."""
        if not snap or not _state.enabled:
            return
        with self._lock:
            self._prior_wall_s += float(snap.get("wall_s", 0.0))
            self._productive_s += float(snap.get("productive_s", 0.0))
            for c, v in (snap.get("badput") or {}).items():
                if c in self._badput:
                    self._badput[c] += float(v)
            self._steps += int(snap.get("steps", 0))
            self._attempts = int(snap.get("attempts", 1)) + 1
            saved_at = float(snap.get("saved_at", 0.0))
            if saved_at:
                gap = self._t0 - saved_at
                if gap > 0:
                    # the dead air IS wall the run paid: it joins the
                    # cumulative wall AND its badput class, so the
                    # resumed ledger's wall equals (end - first spawn)
                    # and still sums by construction
                    self._badput["eviction_downtime"] += gap
                    self._prior_wall_s += gap
            if restore_s > 0:
                self._badput["restore_replay"] += float(restore_s)
            if replay_s > 0:
                self._badput["restore_replay"] += float(replay_s)
        if self._journal is not None:
            self._journal.emit(
                "ops", "ledger_restored", severity="info",
                attempts=self._attempts,
                prior_wall_s=round(self._prior_wall_s, 3),
                restore_s=round(restore_s, 3))

    # -- consumers ---------------------------------------------------------

    def wall_s(self) -> float:
        with self._lock:
            return round(self._prior_wall_s
                         + (time.time() - self._t0), 6)

    def goodput_fraction(self) -> Optional[float]:
        with self._lock:
            wall = self._prior_wall_s + (time.time() - self._t0)
            if wall <= 0:
                return None
            return round(self._productive_s / wall, 4)

    def account(self, timeline=None) -> Dict:
        """The run-lifetime account: sums to ``wall_s`` exactly by
        construction (``unattributed`` is the remainder). Optionally
        embeds the per-step window partition."""
        with self._lock:
            wall = self._prior_wall_s + (time.time() - self._t0)
            badput = {c: round(v, 6) for c, v in self._badput.items()}
            productive = self._productive_s
            steps = self._steps
            attempts = self._attempts
        badput["unattributed"] = round(
            wall - productive - sum(badput.values()), 6)
        frac = round(productive / wall, 4) if wall > 0 else None
        out = {
            "wall_s": round(wall, 6),
            "productive_s": round(productive, 6),
            "goodput_fraction": frac,
            "badput_s": badput,
            "steps": steps,
            "attempts": attempts,
        }
        if timeline is not None:
            out["step_window"] = step_goodput(timeline)
        return out


def dominant_badput(account: Dict) -> Optional[str]:
    """The badput class that cost the most wall (ops reports);
    None when nothing was lost."""
    badput = account.get("badput_s") or {}
    if not badput:
        return None
    cls, worst = max(badput.items(), key=lambda kv: kv[1])
    return cls if worst > 0 else None


__all__ = ["GoodputLedger", "BADPUT_CLASSES", "step_goodput",
           "dominant_badput"]
