"""Step-bracketed profiling on ``torch.profiler`` (``parallax_tpu/
profiler.py``).

Reference: ProfileConfig (config.py:101-117); the patched Session.run
forces a full trace on the configured steps and dumps it under
profile_dir/<host>/worker:<id>/ (session_context.py:74-92, lib.py:333-358).

Here a window of steps is traced by ``torch.profiler`` (CPU activity,
and CUDA activity on the card) and written as the Chrome trace Kineto
exports, to ``<dir>/plugins/profile/<time>/<host>.pt.trace.json.gz``
(the layout ``obs.xprof.find_trace_file`` reads). Windows come from the
config (``profile_steps`` / ``profile_range``) or on demand
(``request_window``, the session's ``profile_steps(n)``); one rank
captures (``profile_worker``), so N ranks do not write N traces.

Two rules the card imposes:

* **No window over a capture.** A profiler running while a CUDA graph is
  captured breaks the capture or loses its kernels. ``before_step`` is
  told whether the step captures (``Engine.step_captures``: the first
  step of a new signature, or of a new plan during a search); a window
  that would open on such a step is deferred, one step at a time, to the
  first step that does not, and keeps its length. Nothing is dropped.
  (The JAX hook blocks the profiled steps instead: nothing there
  compiles inside a trace.)
* **Replays must show their kernels.** The profiler is stopped only
  after ``torch.cuda.synchronize()``, so every kernel the window's graph
  replays launched has run and is in the trace; so the window's steps
  need not block on their outputs (the JAX session blocks them). On the
  card a window also runs one warm-up step first (``torch.profiler``'s
  schedule: tracing enabled over the step, its events dropped; the hook
  synchronizes before the traced steps start, so none of its kernels
  lands in them), and the n steps after it are the ones traced: a window
  of 10 LM1B replays opened with no warm-up, minutes into a process that
  had profiled other sessions before, held one replay with 28 of its 347
  kernels missing (B2 among them), twice, with 20 ms of idle device time
  before and after it or without; with the warm-up every replay held
  all 347.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Optional

import torch

from parallax_tpu_torch.common.config import ProfileConfig
from parallax_tpu_torch.common.lib import parallax_log


class ProfileHook:
    def __init__(self, config: Optional[ProfileConfig], worker_id: int,
                 device="cpu"):
        self._config = config or ProfileConfig()
        self._worker_id = worker_id
        self._device = torch.device(device)
        self._prof = None
        # worker gating is shared by the config-driven windows and the
        # on-demand ones: N ranks must not write N identical traces
        self._worker_ok = (self._config.profile_worker is None
                           or self._config.profile_worker == worker_id)
        self._enabled = bool(self._config.profile_dir) and self._worker_ok
        # the window armed or running: [begin, end, outdir, on_demand]
        self._window: Optional[list] = None
        # fn(trace_dir, steps_captured) called after every stop
        self._on_stop = None
        self._active_dir: Optional[str] = None
        self._begin_step = 0
        self._manifest_written = False
        self._warming = False
        self.deferred_steps = 0

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def worker_enabled(self) -> bool:
        """Whether this worker's gating admits captures at all —
        check BEFORE allocating capture directories."""
        return self._worker_ok

    @property
    def capture_busy(self) -> bool:
        """A capture is armed or in flight; request_window would
        refuse."""
        return self._prof is not None or self._window is not None

    def set_on_stop(self, fn) -> None:
        """Install the capture-complete callback
        (``fn(trace_dir, steps_captured)``); fired after every stop,
        config-driven and on-demand alike, and always guarded —
        attribution failing must never kill the step loop."""
        self._on_stop = fn

    def request_window(self, start_step: int, n: int,
                       outdir: str) -> bool:
        """Arm an on-demand capture of steps ``[start_step,
        start_step + n)`` into ``outdir`` (no ``profile_dir`` required).
        Returns False on a worker this hook's gating excludes; refuses
        while a capture is armed or in flight."""
        if not self._worker_ok:
            return False
        if self.capture_busy:
            raise RuntimeError(
                "a profile capture is already armed/in flight; wait "
                "for it to finish before requesting another window")
        if int(n) < 1:
            raise ValueError(f"profile window must cover >= 1 step, "
                             f"got {n}")
        self._window = [int(start_step), int(start_step) + int(n),
                        outdir, True]
        return True

    def _is_profile_step(self, step: int) -> bool:
        cfg = self._config
        if cfg.profile_steps and step in cfg.profile_steps:
            return True
        if cfg.profile_range:
            begin, end = cfg.profile_range[0], cfg.profile_range[-1]
            return begin <= step < end
        return False

    def _config_run(self, step: int) -> int:
        """The configured profile steps from ``step`` on, consecutive."""
        n = 0
        while self._is_profile_step(step + n):
            n += 1
        return n

    def _trace_dir(self) -> str:
        # layout of the reference's create_profile_directory
        # (lib.py:333-358)
        return os.path.join(self._config.profile_dir, socket.gethostname(),
                            f"worker_{self._worker_id}")

    def _append_task_info(self, path: str) -> None:
        """Task manifest (reference lib.py:333-358): one
        ``<profile_dir>/<hostname>/task_info`` line per worker process,
        written once."""
        if self._manifest_written:
            return
        self._manifest_written = True
        manifest = os.path.join(self._config.profile_dir,
                                socket.gethostname(), "task_info")
        with open(manifest, "a") as f:
            f.write(f"worker:{self._worker_id} devices:1 "
                    f"device:{self._device} dir:{path}\n")

    def before_step(self, step: int, captures: bool = False) -> None:
        """Open a window that starts at ``step``, unless the step
        captures a graph (``captures``): then the window moves one step
        later, its length kept."""
        if self._prof is not None:
            return
        w = self._window
        if w is not None and step >= w[1]:
            # the run jumped past an armed window (skip/rollback): drop
            # it rather than capture the wrong steps forever
            parallax_log.warning(
                "profile window %s expired unstarted at step %d",
                tuple(w[:2]), step)
            self._window = w = None
        if w is None and self._enabled and self._is_profile_step(step):
            path = self._trace_dir()
            self._window = w = [step, step + self._config_run(step), path,
                                False]
        if w is None or step < w[0]:
            return
        if captures:
            w[0] += 1
            w[1] += 1
            self.deferred_steps += 1
            parallax_log.info(
                "profile window deferred past step %d: the step captures "
                "a CUDA graph", step)
            return
        path = w[2]
        os.makedirs(path, exist_ok=True)
        if not w[3]:
            self._append_task_info(path)
        from torch.profiler import ProfilerActivity, profile, schedule
        activities = [ProfilerActivity.CPU]
        if self._device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            # this step warms the tracing up; the window moves one step
            # on (the module doc says why)
            prof = profile(activities=activities, schedule=schedule(
                wait=0, warmup=1, active=w[1] - w[0], repeat=1))
            w[0] += 1
            w[1] += 1
            self._warming = True
        else:
            prof = profile(activities=activities)
        prof.start()
        self._prof = prof
        self._active_dir = path
        self._begin_step = w[0]
        parallax_log.info("profiling steps [%d, %d) -> %s", w[0], w[1],
                          path)

    def after_step(self, step: int) -> None:
        if self._prof is None:
            return
        if self._warming:
            self._warming = False
            # the warm-up step's kernels end before the trace starts
            torch.cuda.synchronize(self._device)
            self._prof.step()        # the traced steps start here
            return
        if step + 1 < self._window[1]:
            return
        self._window = None
        path, begin = self._active_dir, self._begin_step
        self._stop()
        if self._on_stop is not None:
            try:
                self._on_stop(path, step + 1 - begin)
            except Exception as e:  # attribution must never kill a run
                parallax_log.warning(
                    "profile on_stop callback failed: %s", e)

    def _stop(self) -> None:
        """Synchronize (every replayed kernel has run), stop the
        profiler and write its trace."""
        prof, path = self._prof, self._active_dir
        self._prof = None
        self._active_dir = None
        self._warming = False
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        prof.stop()
        out = os.path.join(path, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S"),
                           f"{socket.gethostname()}.pt.trace.json.gz")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        prof.export_chrome_trace(out)

    def close(self) -> None:
        """Stop an in-flight trace (a window extending past the last
        step would otherwise leave the profiler running, and a later
        start raises). Called by ``ParallaxSession.close()``;
        idempotent."""
        self._window = None
        if self._prof is None:
            return
        try:
            self._stop()
        except Exception as e:  # never let profiler teardown mask close
            parallax_log.warning("stopping in-flight trace failed: %s", e)
        else:
            parallax_log.info(
                "stopped in-flight profiler trace at session close (the "
                "profile window extended past the last step)")
