"""The port's training forensics held to the JAX package's
(``tests/test_forensics.py``'s ``TestStepTimeline``, ``TestAnomaly``,
``TestFlightRecorder``, ``TestAggregate``, ``TestSessionForensics`` and
``TestServeSLOBreachDump``):

* ``StepTimeline``, ``AnomalyMonitor`` and ``FlightRecorder`` fed one
  event stream made from a numpy seed through both packages' classes:
  the timeline rows and goodput fractions equal leaving out the
  wall-clock stamp (``ts``); the anomaly events, their counters and the
  re-baselining equal; the flight dumps' section keys, trigger outcomes
  and suppression counters equal (leaving out pids, paths, stamps);
* the straggler report through both packages' ``build_report`` on the
  same rows, and ``aggregate_host_step_times`` on two gloo ranks
  (``torch.distributed.all_gather_object``), each rank's report equal
  to JAX's ``build_report`` of the gathered rows;
* the session: attribution through ``run`` and ``run_iter``, explicit
  and automatic dumps (a crash escaping a step, a non-finite loss, the
  serve deadline breach);
* a small LM1B in both packages with ``numerics_interval=2`` and
  recovery, a NaN in the ``w`` feed at an odd step: both rollback
  artifacts name ``feed/w``, carry the numerics trail and the same
  sections; the port's trip-step stats are forced (``_sampled`` 1).
"""

import glob
import json
import math
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as tparallax
from parallax_tpu.common.config import AnomalyConfig as JAnomalyConfig
from parallax_tpu.models import lm1b as jlm1b
from parallax_tpu.obs import aggregate as jaggregate
from parallax_tpu.obs.anomaly import AnomalyMonitor as JAnomaly
from parallax_tpu.obs.flightrec import FlightRecorder as JFlight
from parallax_tpu.obs.metrics import MetricsRegistry as JRegistry
from parallax_tpu.obs.timeline import StepTimeline as JTimeline
from parallax_tpu_torch import obs
from parallax_tpu_torch.common.config import AnomalyConfig
from parallax_tpu_torch.models import lm1b as tlm1b
from parallax_tpu_torch.models import simple
from parallax_tpu_torch.obs import aggregate
from parallax_tpu_torch.obs.anomaly import AnomalyMonitor
from parallax_tpu_torch.obs.flightrec import FlightRecorder
from parallax_tpu_torch.obs.metrics import MetricsRegistry
from parallax_tpu_torch.obs.timeline import StepTimeline
from test_torch_dist import run_ranks


def _session(**cfg_kw):
    sess, *_ = tparallax.parallel_run(
        simple.build_model(learning_rate=0.1),
        parallax_config=tparallax.Config(run_option="AR", **cfg_kw),
        device="cpu")
    return sess


def _batches(n, batch=64, seed=0):
    rng = np.random.default_rng(seed)
    return [simple.make_batch(rng, batch) for _ in range(n)]


def _steps(seed=11, n=40):
    """One seeded stream of step phases (seconds)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n):
        d = rng.uniform(0.0, 2e-3, size=6)
        out.append(dict(step=s, ts=float(s), wall_s=float(10e-3 + d[0]),
                        data_wait_s=float(d[1]), convert_s=float(d[2]) / 4,
                        h2d_s=float(d[3]) / 4, dispatch_s=float(d[4]) * 2,
                        fetch_block_s=float(d[5]) / 4,
                        h2d_pre_s=float(d[5]) / 8 if s % 3 else 0.0))
    return out


def _no_ts(rows):
    return [{k: v for k, v in r.items() if k != "ts"} for r in rows]


# -- step-time attribution ----------------------------------------------------


class TestStepTimeline:
    def test_stream_rows_and_goodput_equal_jax(self):
        got = StepTimeline(MetricsRegistry(), capacity=16)
        want = JTimeline(JRegistry(), capacity=16)
        for kw in _steps():
            got.record_step(**kw)
            want.record_step(**kw)
        for tl in (got, want):
            tl.add_fetch_block(30, 0.004)
            tl.add_fetch_block(2, 0.004)      # evicted: dropped
            tl.set_flops(2e9, 1e12)
        assert _no_ts(got.rows()) == _no_ts(want.rows())
        assert got.goodput() == want.goodput()
        assert got.local_stats() == want.local_stats()
        assert got.total_rows == want.total_rows == 40
        g, w = got.registry.snapshot(), want.registry.snapshot()
        assert {k: g[k] for k in g if k.startswith("timeline.")} == \
            {k: w[k] for k in w if k.startswith("timeline.")}

    def test_rows_components_and_residual(self):
        tl = StepTimeline(MetricsRegistry(), capacity=8)
        tl.record_step(0, ts=0.0, wall_s=0.010, data_wait_s=0.002,
                       convert_s=0.001, h2d_s=0.001, dispatch_s=0.004,
                       fetch_block_s=0.001)
        (row,) = tl.rows()
        assert row["wall_ms"] == pytest.approx(10.0)
        assert row["dispatch_ms"] == pytest.approx(2.0)
        attributed = (row["data_wait_ms"] + row["convert_ms"]
                      + row["h2d_ms"] + row["dispatch_ms"]
                      + row["fetch_block_ms"])
        assert row["device_est_ms"] == pytest.approx(10.0 - attributed)
        assert row["mfu"] is None

    def test_pre_dispatch_h2d_not_subtracted_from_dispatch(self):
        tl = StepTimeline(MetricsRegistry(), capacity=4)
        tl.record_step(0, ts=0.0, wall_s=0.020, dispatch_s=0.004,
                       h2d_pre_s=0.010)
        (row,) = tl.rows()
        assert row["h2d_ms"] == pytest.approx(10.0)
        assert row["dispatch_ms"] == pytest.approx(4.0)

    def test_mfu_and_goodput_account(self):
        tl = StepTimeline(MetricsRegistry(), capacity=8)
        for s in range(4):
            tl.record_step(s, ts=0.0, wall_s=0.010, data_wait_s=0.002,
                           dispatch_s=0.003)
        tl.set_flops(1e9, 1e12)
        assert tl.rows()[-1]["mfu"] == pytest.approx(0.1)
        g = tl.goodput()
        assert g["mfu_mean"] == pytest.approx(0.1)
        assert g["phase_frac"]["data_wait_ms"] == pytest.approx(0.2)
        assert sum(g["phase_frac"].values()) == pytest.approx(1.0, abs=1e-6)
        json.dumps(g)

    def test_registry_gauges_and_disabled_noop(self):
        reg = MetricsRegistry()
        tl = StepTimeline(reg, capacity=8)
        tl.record_step(0, ts=0.0, wall_s=0.01, dispatch_s=0.004)
        snap = reg.snapshot()
        assert snap["timeline.wall_ms"]["p50"] == pytest.approx(10.0)
        assert snap["timeline.steps"] == 1
        obs.disable()
        try:
            tl.record_step(1, ts=0.0, wall_s=0.01)
            tl.add_fetch_block(0, 1.0)
        finally:
            obs.enable()
        assert tl.total_rows == 1
        assert tl.rows()[0]["fetch_block_ms"] == 0.0


# -- anomaly detection --------------------------------------------------------


_CFG = dict(window=32, min_samples=8, spike_mads=6.0, spike_min_ratio=2.0,
            shift_window=4, shift_ratio=1.5, cooldown=16)


def _signals(seed=5):
    """(signal, step, value): a noisy step time with a spike and a
    sustained 1.8x shift, a loss with a spike, a flat grad norm."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(120):
        t = 10.0 + rng.normal(0, 0.1)
        if s == 40:
            t = 200.0
        if s >= 70:
            t = 18.0 + rng.normal(0, 0.1)
        out.append(("step_time_ms", s, float(t)))
        loss = 3.0 - 0.005 * s + rng.normal(0, 0.01)
        out.append(("loss", s, float(50.0 if s == 90 else loss)))
        out.append(("grad_norm", s, float(1.0 + 0.01 * (s % 5))))
    return out


class TestAnomaly:
    def test_stream_events_and_rebaselining_equal_jax(self):
        got = AnomalyMonitor(MetricsRegistry(), AnomalyConfig(**_CFG))
        want = JAnomaly(JRegistry(), JAnomalyConfig(**_CFG))
        fired = []
        for sig, s, v in _signals():
            a, b = got.observe(sig, s, v), want.observe(sig, s, v)
            assert (a is None) == (b is None), (sig, s)
            if a is not None:
                assert tuple(a) == tuple(b)
                fired.append((a.signal, a.kind, a.step))
            if (sig, s) == ("step_time_ms", 100):
                for m in (got, want):
                    m.notify_deliberate_change("scale", ["step_time_ms"])
        assert got.events() == want.events()
        assert ("step_time_ms", "spike", 40) in fired
        assert any(k == "shift" for _, k, _ in fired)
        assert ("loss", "spike", 90) in fired
        assert got.snapshot() == want.snapshot()
        g, w = got.registry.snapshot(), want.registry.snapshot()
        assert {k: g[k] for k in g if k.startswith("anomaly.")} == \
            {k: w[k] for k in w if k.startswith("anomaly.")}

    def test_restored_baselines_rearm_like_jax(self):
        """A checkpoint's baselines restored across packages: both
        detectors continue identically."""
        src = AnomalyMonitor(MetricsRegistry(), AnomalyConfig(**_CFG))
        for sig, s, v in _signals()[:150]:
            src.observe(sig, s, v)
        snap = json.loads(json.dumps(src.snapshot()))
        got = AnomalyMonitor(MetricsRegistry(), AnomalyConfig(**_CFG))
        want = JAnomaly(JRegistry(), JAnomalyConfig(**_CFG))
        got.restore_snapshot(snap)
        want.restore_snapshot(snap)
        for sig, s, v in _signals()[150:]:
            a, b = got.observe(sig, s, v), want.observe(sig, s, v)
            assert (None if a is None else tuple(a)) == \
                (None if b is None else tuple(b))
        assert got.events() == want.events()

    def test_spike_fires_and_counts(self):
        reg = MetricsRegistry()
        am = AnomalyMonitor(reg, AnomalyConfig(**_CFG))
        for i in range(20):
            assert am.observe("step_time_ms", i,
                              10.0 + 0.1 * (i % 3)) is None
        ev = am.observe("step_time_ms", 20, 200.0)
        assert ev is not None and ev.kind == "spike" and ev.ratio > 10
        assert reg.counter("anomaly.step_time_ms.spikes").value == 1

    def test_cooldown_suppresses_repeat_firing(self):
        am = AnomalyMonitor(MetricsRegistry(), AnomalyConfig(**_CFG))
        for i in range(20):
            am.observe("s", i, 10.0)
        assert am.observe("s", 20, 300.0) is not None
        assert am.observe("s", 21, 300.0) is None

    def test_stable_signal_never_fires_and_disabled_noop(self):
        am = AnomalyMonitor(MetricsRegistry(), AnomalyConfig(**_CFG))
        for i in range(200):
            assert am.observe("s", i, 5.0 + 0.05 * (i % 7)) is None
        obs.disable()
        try:
            n = am.total_observed
            am.observe("s", 999, 1e9)
        finally:
            obs.enable()
        assert am.total_observed == n

    def test_on_event_callback(self):
        got = []
        am = AnomalyMonitor(MetricsRegistry(), AnomalyConfig(**_CFG),
                            on_event=got.append)
        for i in range(20):
            am.observe("s", i, 1.0)
        am.observe("s", 20, 50.0)
        assert len(got) == 1 and got[0].kind == "spike"

    @pytest.mark.parametrize("kw", [dict(window=1), dict(min_samples=1),
                                    dict(window=8, min_samples=8),
                                    dict(spike_mads=0.0)])
    def test_config_validation_matches_jax(self, kw):
        with pytest.raises(ValueError):
            JAnomalyConfig(**kw)
        with pytest.raises(ValueError):
            AnomalyConfig(**kw)


# -- flight recorder ----------------------------------------------------------


def _triggers():
    return ["nonfinite_loss:a", "nonfinite_loss:b", "serve_deadline_breach",
            "nonfinite_loss:c", "fleet_crash:r0", "anomaly_loss_spike",
            "alert:hot", "alert:cold", "exception:ValueError",
            "oom_risk", "fleet_crash:r1"]


class TestFlightRecorder:
    def test_trigger_stream_equals_jax(self, tmp_path):
        """Outcomes, section keys and suppression counters through both
        recorders on one trigger stream (max_dumps 5)."""
        out = {}
        for name, cls, reg in (("port", FlightRecorder, MetricsRegistry()),
                               ("jax", JFlight, JRegistry())):
            d = tmp_path / name
            fr = cls(flight_dir=str(d), registry=reg, max_dumps=5,
                     providers={"a": lambda: {"x": 1},
                                "bad": lambda: 1 / 0})
            fr.add_provider("b", lambda: [1, 2])
            got = [fr.trigger(t, {"t": t}) is not None for t in _triggers()]
            docs = [json.load(open(p)) for p in fr.dump_paths]
            snap = reg.snapshot()
            out[name] = (got,
                         [sorted(doc) for doc in docs],
                         [(doc["reason"], doc["detail"], doc["a"], doc["b"],
                           doc["bad"]) for doc in docs],
                         {k: v for k, v in snap.items()
                          if k.startswith(("flight", "flightrec"))})
        assert out["port"] == out["jax"]
        assert out["port"][0].count(True) == 5

    def test_dump_sections_and_provider_isolation(self, tmp_path):
        def boom():
            raise RuntimeError("poisoned buffer")
        fr = FlightRecorder(flight_dir=str(tmp_path),
                            providers={"good": lambda: {"x": 1},
                                       "bad": boom})
        doc = json.load(open(fr.dump("manual", detail={"k": "v"})))
        assert doc["reason"] == "manual" and doc["detail"] == {"k": "v"}
        assert doc["good"] == {"x": 1}
        assert "RuntimeError" in doc["bad"]["_error"]
        assert doc["process_index"] == 0

    def test_trigger_requires_flight_dir_and_dedups(self, tmp_path):
        assert FlightRecorder(flight_dir=None).trigger("x") is None
        fr = FlightRecorder(flight_dir=str(tmp_path))
        assert fr.trigger("nonfinite_loss:a", {"step": 1}) is not None
        assert fr.trigger("nonfinite_loss:b", {"step": 2}) is None
        assert fr.trigger("serve_deadline_breach") is not None
        assert len(fr.dump_paths) == 2

    def test_failed_dump_releases_the_class(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        fr = FlightRecorder(flight_dir=str(blocker))
        assert fr.trigger("oom_risk") is None      # unwritable: no claim
        fr.flight_dir = str(tmp_path / "ok")
        assert fr.trigger("oom_risk") is not None

    def test_artifacts_carry_incident_ids(self, tmp_path):
        fr = FlightRecorder(flight_dir=str(tmp_path))
        id1 = json.load(open(fr.trigger("a")))["incident_id"]
        id2 = json.load(open(fr.trigger("b")))["incident_id"]
        assert id1 and id2 and id1 != id2
        assert fr.last_incident_id == id2


# -- straggler aggregation ------------------------------------------------------


class TestAggregate:
    @pytest.mark.parametrize("means,factor", [
        ([10, 10, 10, 10], 1.25), ([10, 31, 10, 10], 1.25), ([10], 1.25),
        ([10, 13, 40, 41], 1.3)])
    def test_find_stragglers_equal_jax(self, means, factor):
        assert aggregate.find_stragglers(means, factor) == \
            jaggregate.find_stragglers(means, factor)

    def test_build_report_names_the_laggard(self):
        rows = np.array([[10.0, 12.0, 50], [41.0, 52.0, 50],
                         [11.0, 13.0, 50]])
        rep = aggregate.build_report(rows, factor=1.25)
        assert rep == jaggregate.build_report(rows, factor=1.25)
        assert rep["stragglers"] == [1] and rep["slowest"] == 1
        assert "process 1" in aggregate.straggler_summary(rep)
        json.dumps(rep)

    def test_single_process_collective(self):
        rep = aggregate.aggregate_host_step_times(
            {"mean_ms": 5.0, "p95_ms": 7.0, "steps": 12})
        assert rep["num_hosts"] == 1 and rep["stragglers"] == []
        assert rep["hosts"][0]["steps"] == 12

    def test_two_gloo_ranks_name_the_slow_rank(self, tmp_path):
        means = [[10.0, 11.0, 9.5, 10.5], [31.0, 30.0, 33.0, 29.0]]
        results = run_ranks(tmp_path, 2, "obs_aggregate", means=means)
        rows = np.array([[np.mean(m), np.percentile(m, 95), len(m)]
                         for m in means])
        for rank, res in enumerate(results):
            assert res["timeline"]["num_hosts"] == 2
            assert res["timeline"]["stragglers"] == [1]
            want = jaggregate.build_report(
                np.array([[h["mean_ms"], h["p95_ms"], h["steps"]]
                          for h in res["timeline"]["hosts"]]))
            assert res["timeline"] == want
            assert [h["mean_ms"] for h in res["timeline"]["hosts"]] == \
                pytest.approx(rows[:, 0].tolist(), rel=1e-6)
            # the session's collective: both ranks, one report each
            assert res["session"]["num_hosts"] == 2
            assert res["session"]["hosts"][rank]["steps"] == 3
        assert results[0]["session"] == results[1]["session"]


# -- session integration --------------------------------------------------------


class TestSessionForensics:
    def test_timeline_attribution_through_run_and_run_iter(self):
        sess = _session()
        try:
            sess.run("loss", feed_dict=_batches(1)[0])
            (row,) = sess.timeline.rows()
            assert row["convert_ms"] > 0
            assert row["h2d_ms"] > 0
            assert row["dispatch_ms"] > 0
            # the first step's wall is its own pre-phases plus dispatch
            assert row["device_est_ms"] >= 0
            for r in sess.run_iter(_batches(6), "loss"):
                float(r)
            rows = sess.timeline.rows()
            assert len(rows) == 7
            assert all(r["h2d_ms"] == 0.0 for r in rows[1:])
            assert any(r["data_wait_ms"] > 0 for r in rows[1:])
            snap = sess.metrics_snapshot()
            assert snap["timeline.steps"] == 7
            assert snap["timeline.wall_ms"]["count"] == 7
        finally:
            sess.close()

    def test_lazy_fetch_block_attributed_to_its_step(self):
        sess = _session()
        try:
            f = sess.run("loss", feed_dict=_batches(1)[0])
            sess.run("loss", feed_dict=_batches(1, seed=1)[0])
            before = sess.timeline.rows()[0]["fetch_block_ms"]
            float(f)
            assert sess.timeline.rows()[0]["fetch_block_ms"] >= before
        finally:
            sess.close()

    def test_explicit_dump_flight_without_flight_dir(self, tmp_path):
        sess = _session()
        try:
            for b in _batches(3):
                sess.run("loss", feed_dict=b)
            doc = json.load(open(sess.dump_flight(
                str(tmp_path / "post.json"))))
            assert doc["reason"] == "manual"
            assert len(doc["steps"]) == 3
            assert doc["goodput"]["steps"] == 3
            assert doc["config"]["run_option"] == "AR"
            assert doc["metrics"]["pipeline.steps"] == 3
            assert doc["progress"]["host_step"] == 3
        finally:
            sess.close()

    def test_crash_dump_on_step_exception(self, tmp_path):
        sess = _session(flight_dir=str(tmp_path))
        try:
            for b in _batches(2):
                sess.run("loss", feed_dict=b)
            bad = {"x": _batches(1)[0]["x"]}       # no 'y' feed
            with pytest.raises(Exception):
                sess._run_step("loss", bad)
            dumps = glob.glob(str(tmp_path / "flight_exception*.json"))
            assert len(dumps) == 1
            doc = json.load(open(dumps[0]))
            assert doc["reason"].startswith("exception:")
            assert doc["detail"]["step"] == 2
            assert len(doc["steps"]) == 2
        finally:
            sess.close()

    def test_nan_loss_triggers_flight_dump(self, tmp_path):
        sess = _session(monitor_health=True, flight_dir=str(tmp_path))
        try:
            good = _batches(3)
            bad = _batches(1, seed=9)[0]
            bad["x"] = np.full_like(bad["x"], np.nan)
            for b in (good[0], good[1], bad, good[2]):
                sess.run("loss", feed_dict=b)
            sess.health.poll(block=True)
            dumps = glob.glob(str(tmp_path / "flight_nonfinite_loss*"))
            assert len(dumps) == 1
            doc = json.load(open(dumps[0]))
            assert doc["detail"]["step"] == 2
            assert doc["health"]["first_nonfinite_step"] == 2
            assert any(r["loss_finite"] is False
                       for r in doc["health"]["readings"])
        finally:
            sess.close()

    def test_warmup_feeds_step_flops_to_timeline(self):
        cfg = tlm1b.tiny_config(lstm_impl="kernel")
        sess, *_ = tparallax.parallel_run(
            tlm1b.build_model(cfg), parallax_config=tparallax.Config(
                run_option="HYBRID", shape_buckets=[8]), device="cpu")
        try:
            b = tlm1b.make_batch(np.random.default_rng(0), 8, 5,
                                 cfg.vocab_size)
            sess.warmup(feed_dict=b)
            flops = sess.step_flops()
            assert flops and flops > 0
            sess.run("loss", feed_dict=b)
            g = sess.timeline.goodput()
            assert g["flops_per_step"] == flops
            assert g["mfu_mean"] is None            # the CPU has no peak
            assert sess.ops_account()["badput_s"]["compile_warmup"] > 0
        finally:
            sess.close()

    def test_host_aggregation_lands_in_dump(self, tmp_path):
        sess = _session()
        try:
            for b in _batches(4):
                sess.run("loss", feed_dict=b)
            rep = sess.aggregate_host_steps()
            assert rep["num_hosts"] == 1 and rep["stragglers"] == []
            doc = json.load(open(sess.dump_flight(
                str(tmp_path / "agg.json"))))
            assert doc["host_report"]["num_hosts"] == 1
        finally:
            sess.close()

    def test_anomaly_on_step_time_dumps_and_journals(self, tmp_path):
        sess = _session(flight_dir=str(tmp_path),
                        anomaly_config=AnomalyConfig(**_CFG))
        try:
            for i, (_, s, v) in enumerate(
                    x for x in _signals() if x[0] == "step_time_ms"):
                if s > 45:
                    break
                sess.anomaly.observe("step_time_ms", s, v)
            assert glob.glob(str(tmp_path / "flight_anomaly_step_time_ms"
                                            "_spike*"))
            kinds = [(e["subsystem"], e["kind"])
                     for e in sess.journal.events()]
            assert ("anomaly", "spike") in kinds
        finally:
            sess.close()


class TestServeSLOBreachDump:
    def test_deadline_breach_triggers_flight_dump(self, tmp_path):
        from parallax_tpu_torch.serve import ServeSession
        from parallax_tpu_torch.serve.batcher import DeadlineExceeded
        fr = FlightRecorder(flight_dir=str(tmp_path))
        serve = ServeSession(
            lambda params, batch: {"y": batch["x"]},
            {"w": torch.zeros((1,))},
            example_feed={"x": np.zeros((4,), np.float32)},
            config=tparallax.Config(serve_config=tparallax.ServeConfig(
                max_batch=2, max_wait_ms=30.0, max_queue=8)),
            flight=fr, device="cpu")
        try:
            req = serve.submit({"x": np.ones((4,), np.float32)},
                               deadline_ms=0.01)
            deadline = time.perf_counter() + 10.0
            while not req.done() and time.perf_counter() < deadline:
                time.sleep(0.01)
            assert req.done()
            with pytest.raises(DeadlineExceeded):
                req.result()
            ok = time.perf_counter() + 5.0
            while not fr.dump_paths and time.perf_counter() < ok:
                time.sleep(0.01)
            dumps = glob.glob(str(tmp_path /
                                  "flight_serve_deadline_breach*"))
            assert len(dumps) == 1
            assert json.load(open(dumps[0]))["detail"]["n"] >= 1
        finally:
            serve.close()


# -- NaN provenance, both packages ----------------------------------------------


def _lm1b_nan_run(pkg, lm1b, fdir, cfg_kw):
    kw = dict(run_option="HYBRID", sparse_grad_mode="slices",
              numerics_interval=2, flight_dir=fdir,
              recovery_config=pkg.RecoveryConfig(
                  enabled=True, snapshot_every_steps=1, max_retries=2))
    if pkg is jparallax:
        kw["search_partitions"] = False
    extra = {} if pkg is jparallax else {"device": "cpu"}
    sess, *_ = pkg.parallel_run(lm1b.build_model(lm1b.tiny_config(
        **cfg_kw)), parallax_config=pkg.Config(**kw), seed=0, **extra)
    rng = np.random.default_rng(21)
    batches = [jlm1b.make_batch(rng, 8, 5, 1000) for _ in range(6)]
    batches[3]["w"] = batches[3]["w"].copy()
    batches[3]["w"][2, 1] = np.nan                  # odd step: unsampled
    losses = []
    try:
        for b in batches:
            losses.append(float(sess.run("loss", feed_dict=b)))
    finally:
        sess.close()
    arts = glob.glob(os.path.join(fdir, "flight_nonfinite_rollback_*"))
    assert len(arts) == 1, os.listdir(fdir)
    return losses, json.load(open(arts[0]))


def test_nan_provenance_names_the_poisoned_feed_like_jax(tmp_path):
    jlosses, jdoc = _lm1b_nan_run(
        jparallax, jlm1b, str(tmp_path / "jax"),
        dict(sparse_grad_mode="slices", compute_dtype=jnp.float32))
    tlosses, tdoc = _lm1b_nan_run(
        tparallax, tlm1b, str(tmp_path / "port"),
        dict(sparse_grad_mode="slices", compute_dtype=torch.float32,
             lstm_impl="kernel"))
    for losses in (jlosses, tlosses):
        assert math.isnan(losses[3])
        assert all(math.isfinite(x) for i, x in enumerate(losses) if i != 3)
    jp, tp = jdoc["detail"]["provenance"], tdoc["detail"]["provenance"]
    assert tp["culprit"] == jp["culprit"] == "feed/w"
    assert tp["trip_stats_sampled"] and jp["trip_stats_sampled"]
    assert [c["name"] for c in tp["checks"]] == \
        [c["name"] for c in jp["checks"]]
    assert [c["nonfinite"] > 0 for c in tp["checks"]] == \
        [c["nonfinite"] > 0 for c in jp["checks"]]
    assert sorted(tdoc) == sorted(jdoc)
    assert sorted(tdoc["detail"]) == sorted(
        set(jdoc["detail"]) | {"trip_stats_basis"})
    assert tdoc["detail"]["trip_stats_basis"]["snapshot_step"] == 3
    assert [r["step"] for r in tdoc["detail"]["stats_trail"]] == \
        [r["step"] for r in jdoc["detail"]["stats_trail"]]
