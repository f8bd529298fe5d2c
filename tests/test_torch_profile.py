"""The port's profile hook and the session's profile surface
(``parallax_tpu_torch/profiler.py``; ``ParallaxSession.profile_steps``,
``profile_summary``, ``write_calibration``) held to the JAX package's.

* ``ProfileHook``: config-driven windows (``profile_steps``,
  ``profile_range``), on-demand ones (``request_window``), the worker
  gating, refusals, expiry and ``close``: the same start and stop steps
  and the same captured step counts as the JAX hook, with both
  profilers replaced by recorders. The port's own rule on top: a window
  that would open on a step that captures a graph is deferred, not
  dropped.
* A CPU session's window: ``profile_steps`` / ``profile_summary`` (the
  CPU track), the ``profile.*`` gauges and the flight section.
* ``write_calibration``: its refusals, and the record it writes when a
  calibration was loaded (the applied ratios taken back out) equal to
  the JAX session's on the same decision record and attribution.

No assertion uses a measured CPU time.
"""

import json
import os

import numpy as np
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as pt
from parallax_tpu import profiler as jprofiler
from parallax_tpu.common.config import ProfileConfig as JProfileConfig
from parallax_tpu.obs import xprof as jxprof
from parallax_tpu.session import ParallaxSession as JSession
from parallax_tpu_torch import profiler as tprofiler
from parallax_tpu_torch.common.config import ProfileConfig
from parallax_tpu_torch.session import ParallaxSession as TSession
from parallax_tpu_torch.tune import calibrate as tcal


class _Recorder:
    """Stands in for both profilers: logs start and stop."""

    def __init__(self):
        self.log = []

    def jax_start(self, path, *a, **k):
        self.log.append(("start", path))

    def jax_stop(self):
        self.log.append(("stop",))

    def torch_profile(self, activities=None, schedule=None, **kw):
        rec = self
        rec.log.append(("schedule", schedule is not None))

        class _P:
            def start(self):
                rec.log.append(("start", None))

            def step(self):
                rec.log.append(("step",))

            def stop(self):
                rec.log.append(("stop",))

            def export_chrome_trace(self, path):
                rec.log.append(("export", os.path.basename(path)))

        return _P()


@pytest.fixture
def recorders(monkeypatch):
    import jax.profiler
    import torch.profiler
    jrec, trec = _Recorder(), _Recorder()
    monkeypatch.setattr(jax.profiler, "start_trace", jrec.jax_start)
    monkeypatch.setattr(jax.profiler, "stop_trace", jrec.jax_stop)
    monkeypatch.setattr(torch.profiler, "profile", trec.torch_profile)
    return jrec, trec


def _drive(hook, steps, captures=()):
    """Run ``steps`` through a hook; the (step, event) log of starts and
    stops, and the on_stop callbacks' step counts."""
    events, stopped = [], []
    hook.set_on_stop(lambda path, n: stopped.append(n))
    for s in steps:
        was = hook.active
        if isinstance(hook, tprofiler.ProfileHook):
            hook.before_step(s, s in captures)
        else:
            hook.before_step(s)
        if hook.active and not was:
            events.append((s, "start"))
        hook.after_step(s)
        if was or hook.active:
            if not hook.active:
                events.append((s, "stop"))
    return events, stopped


CONFIGS = {
    "steps": dict(profile_steps=[2, 3, 7]),
    "range": dict(profile_range=(3, 6)),
    "range_past_end": dict(profile_range=(8, 20)),
    "gated_out": dict(profile_steps=[1, 2], profile_worker=3),
    "gated_in": dict(profile_range=(1, 3), profile_worker=0),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_windows_equal_jax(tmp_path, recorders, name):
    kw = dict(CONFIGS[name], profile_dir=str(tmp_path))
    jhook = jprofiler.ProfileHook(JProfileConfig(**kw), worker_id=0)
    thook = tprofiler.ProfileHook(ProfileConfig(**kw), worker_id=0)
    got = _drive(thook, range(10))
    want = _drive(jhook, range(10))
    assert got == want
    # a window still open at the end stops at close, without a callback
    thook.close()
    jhook.close()
    assert not thook.active and not jhook.active
    if name == "range_past_end":
        assert recorders[1].log[-2:] == [
            ("stop",), ("export", f"{os.uname().nodename}.pt.trace.json.gz")]
    if name != "gated_out":
        manifest = tmp_path / os.uname().nodename / "task_info"
        assert manifest.read_text().startswith("worker:0 devices:1")


@pytest.mark.parametrize("start,n", [(0, 1), (2, 3), (5, 4)])
def test_on_demand_windows_equal_jax(tmp_path, recorders, start, n):
    jhook = jprofiler.ProfileHook(JProfileConfig(), worker_id=0)
    thook = tprofiler.ProfileHook(ProfileConfig(), worker_id=0)
    for h in (jhook, thook):
        assert h.request_window(start, n, str(tmp_path)) is True
        assert h.capture_busy
        with pytest.raises(RuntimeError, match="already armed"):
            h.request_window(start, n, str(tmp_path))
    assert _drive(thook, range(12)) == _drive(jhook, range(12))
    assert not thook.capture_busy and not jhook.capture_busy


def test_worker_gating_and_refusals_equal_jax(tmp_path, recorders):
    for hook_cls, cfg_cls in ((jprofiler.ProfileHook, JProfileConfig),
                              (tprofiler.ProfileHook, ProfileConfig)):
        out = hook_cls(cfg_cls(profile_worker=3), worker_id=0)
        assert out.worker_enabled is False
        assert out.request_window(0, 4, str(tmp_path)) is False
        ok = hook_cls(cfg_cls(profile_worker=0), worker_id=0)
        with pytest.raises(ValueError, match=">= 1 step"):
            ok.request_window(0, 0, str(tmp_path))
        assert ok.request_window(0, 4, str(tmp_path)) is True


def test_a_window_past_its_steps_expires_alike(tmp_path, recorders):
    """A run that jumps past an armed window (a skip, a rollback) drops
    it rather than capture the wrong steps."""
    jhook = jprofiler.ProfileHook(JProfileConfig(), worker_id=0)
    thook = tprofiler.ProfileHook(ProfileConfig(), worker_id=0)
    for h in (jhook, thook):
        h.request_window(2, 2, str(tmp_path))
    steps = [0, 1, 7, 8]
    assert _drive(thook, steps) == _drive(jhook, steps) == ([], [])
    assert not thook.capture_busy and not jhook.capture_busy


@pytest.mark.parametrize("captures,opens", [((2,), 3), ((2, 3), 4),
                                            ((3,), 2), ((), 2)])
def test_a_window_over_a_capture_is_deferred(tmp_path, recorders,
                                             captures, opens):
    """A window never opens on a step that captures a graph: it moves
    one step at a time to the first step that does not, and keeps its
    length (a capture inside an open window is the next window's
    concern: once open, the window runs)."""
    hook = tprofiler.ProfileHook(ProfileConfig(), worker_id=0)
    hook.request_window(2, 3, str(tmp_path))
    events, stopped = _drive(hook, range(10), captures=set(captures))
    assert events == [(opens, "start"), (opens + 2, "stop")]
    assert stopped == [3]
    assert hook.deferred_steps == opens - 2


def test_a_card_window_warms_up_one_step_first(tmp_path, recorders,
                                              monkeypatch):
    """On the card a window opens one step early under the profiler's
    schedule (a warm-up step whose events are dropped), steps it once
    after that step, and traces the n steps after it; a capture on the
    warm-up step defers the whole window."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    hook = tprofiler.ProfileHook(ProfileConfig(), worker_id=0,
                                 device="cuda")
    hook.request_window(2, 3, str(tmp_path))
    events, stopped = _drive(hook, range(10), captures={2})
    assert events == [(3, "start"), (6, "stop")]
    assert stopped == [3] and hook.deferred_steps == 1
    log = [e[0] for e in recorders[1].log]
    assert log == ["schedule", "start", "step", "stop", "export"]


def test_config_window_deferred_keeps_its_length(tmp_path, recorders):
    hook = tprofiler.ProfileHook(ProfileConfig(
        profile_dir=str(tmp_path), profile_range=(0, 2)), worker_id=0)
    events, stopped = _drive(hook, range(6), captures={0})
    assert events == [(1, "start"), (2, "stop")] and stopped == [2]


# -- the session ---------------------------------------------------------------


def _simple_session(**cfg):
    from parallax_tpu_torch.models import simple
    sess, *_ = pt.parallel_run(
        simple.build_model(learning_rate=0.1),
        parallax_config=pt.Config(run_option="AR", eager_fetch=True, **cfg),
        device="cpu")
    return sess


def test_session_profile_window_and_gauges(tmp_path):
    from parallax_tpu_torch.models import simple
    sess = _simple_session(flight_dir=str(tmp_path))
    try:
        feed = simple.make_batch(np.random.default_rng(0), 64)
        for _ in range(2):
            sess.run("loss", feed_dict=feed)
        outdir = sess.profile_steps(3)
        assert outdir is not None and os.path.isdir(outdir)
        assert sess.metrics_snapshot()[
            "profile.attribution_coverage"] is None
        doc = json.loads(open(sess.dump_flight(
            str(tmp_path / "d0.json"))).read())
        assert doc["profile"] is None
        for _ in range(3):
            sess.run("loss", feed_dict=feed)
        assert sess._profile_pending is not None
        doc = json.loads(open(sess.dump_flight(
            str(tmp_path / "d1.json"))).read())
        assert doc["profile"]["steps"] == 3 and \
            doc["profile"]["pending_trace"] == outdir
        a = sess.profile_summary()
        assert a and not a.get("error"), a
        assert a["steps"] == 3 and a["track_basis"] == "cpu_op"
        assert a["events"] > 0 and a["coverage"] is not None
        assert a["residual_ms"] >= 0
        assert sess.profile_summary() is a          # parsed once
        snap = sess.metrics_snapshot()
        assert snap["profile.attribution_coverage"] == a["coverage"]
        assert snap["profile.steps"] == 3
        assert snap["profile.share.compute"] == \
            a["by_category"]["compute"]["share"]
        doc = json.loads(open(sess.dump_flight(
            str(tmp_path / "d2.json"))).read())
        assert doc["profile"]["coverage"] == a["coverage"]
        with pytest.raises(ValueError, match="settled mesh search"):
            sess.write_calibration(str(tmp_path / "cal.json"))
    finally:
        sess.close()


def test_profile_steps_refusals():
    from parallax_tpu_torch.models import simple
    sess = _simple_session()
    try:
        feed = simple.make_batch(np.random.default_rng(0), 16)
        sess.run("loss", feed_dict=feed)
        with pytest.raises(ValueError, match=">= 1 step"):
            sess.profile_steps(0)
        sess.profile_steps(2)
        with pytest.raises(RuntimeError, match="already armed"):
            sess.profile_steps(2)
        with pytest.raises(ValueError, match="parsed profile window"):
            sess.write_calibration("/nonexistent/cal.json")
    finally:
        sess.close()
    assert not sess._profile.active


def test_write_calibration_needs_a_path():
    sess = _simple_session()
    try:
        with pytest.raises(ValueError, match="needs a path"):
            sess.write_calibration()
    finally:
        sess.close()


def test_gated_profile_steps_allocates_no_tempdir(monkeypatch):
    import tempfile as _tf
    calls = []
    monkeypatch.setattr(
        _tf, "mkdtemp",
        lambda **kw: calls.append(kw) or "/tmp/should-not-exist")
    sess = _simple_session(profile_config=ProfileConfig(profile_worker=3))
    try:
        assert sess.profile_steps(4) is None
        assert calls == []
    finally:
        sess.close()


def test_write_calibration_unapplies_loaded_ratios_as_jax(tmp_path):
    """A search that loaded a calibration scored calibrated terms; the
    new record compares the nominal prediction with the measured world,
    as the JAX session's does, on the same decision record and
    attribution."""
    applied = {"on_chip": 10.0, "wire": 100.0}
    entry = {"plan": "dp1xtp1/HYBRID",
             "terms_ms": {"compute_s": 100.0, "hbm_s": 50.0,
                          "wire_dense_s": 5.0, "wire_zero_shard_s": 0.0,
                          "wire_table_s": 0.0, "wire_hidden_s": 0.0},
             "calibration": dict(applied)}
    tune = {"winner": {"plan": entry["plan"]}, "scored": [entry],
            "cost_basis": "calibrated(nominal-constants (CPU-relative "
                          "ranking))"}
    with open(os.path.join(os.path.dirname(__file__), "data",
                           "golden_trace.json")) as f:
        attrib = jxprof.attribute(json.load(f), steps=2).as_dict()
    records = {}
    for name, cls, cfg in (
            ("jax", JSession, jparallax.Config(search_partitions=False)),
            ("port", TSession, pt.Config())):
        sess = cls.__new__(cls)
        sess._tune_result = tune
        sess._profile_attrib = attrib
        sess._profile_pending = None
        sess._config = cfg
        sess._world = 1
        sess._device = torch.device("cpu")
        path = str(tmp_path / f"{name}.json")
        if name == "jax":
            import unittest.mock as mock
            with mock.patch("jax.device_count", return_value=1):
                sess.write_calibration(path)
        else:
            sess.write_calibration(path)
        records[name] = tcal.load(path)
    got, want = records["port"], records["jax"]
    assert got["terms"] == want["terms"]
    assert got["terms"]["on_chip"]["predicted_s"] == pytest.approx(1.0)
    assert got["terms"]["wire"]["predicted_s"] == pytest.approx(0.5)
    assert got["basis"] == tune["cost_basis"] + " on cpu"
    assert got["meta"]["device"] == "cpu"
    assert got["meta"]["plan"] == want["meta"]["plan"]
