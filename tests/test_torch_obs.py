"""The port's observability layer held to the JAX package's
(``tests/test_obs.py``'s ``TestHealthMonitor``,
``TestSessionObservability``, ``TestPipelineStatsMigration`` and the
logging knobs), plus the step FLOPs and the card's peak table:

* ``PipelineStats``, ``JsonlSink`` and ``HealthMonitor`` fed one event
  stream made from a numpy seed through both packages' classes: the
  summaries, the health reports and the health readings equal (exact:
  the same float arithmetic on the same values);
* the lazy consumption: a value not yet ready stays queued, in the port
  also the pinned-copy-behind-an-event reading (``HostScalars``), which
  on the CPU is ready at once;
* the session: a NaN batch through the port's and JAX's simple-model
  sessions, the first non-finite step equal; the Chrome trace at close
  with the dispatch and prefetch threads; the metrics sink; the
  recompile counter; the pipeline stats through ``run_iter``;
* ``step_flops``: the LM1B step counted on meta tensors within 1 % of
  the port's copy of ``lm1b_matmul_flops_per_word`` times the step's
  words (the copy equal to JAX's), BERT's (plain and flash attention)
  within 1 % of ``chip_smoke.py``'s ``bert_model_flops``; the peak
  table knows the H100 SXM alone.

The JAX package's timing-budget test (``test_obs_overhead_within_budget``)
is not ported: the overhead is measured on the card (chip_smoke's
``obs-overhead``). No test here asserts a time.
"""

import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as tparallax
from parallax_tpu.common import flops as jflops
from parallax_tpu.models import simple as jsimple
from parallax_tpu.obs.health import HealthMonitor as JHealth
from parallax_tpu.obs.metrics import MetricsRegistry as JRegistry
from parallax_tpu.obs.metrics import PipelineStats as JPipeline
from parallax_tpu_torch import obs
from parallax_tpu_torch.common import flops as tflops
from parallax_tpu_torch.common.lib import (JsonLogFormatter,
                                           configure_logging, parallax_log)
from parallax_tpu_torch.models import bert as tbert
from parallax_tpu_torch.models import lm1b as tlm1b
from parallax_tpu_torch.models import simple as tsimple
from parallax_tpu_torch.obs import health as thealth
from parallax_tpu_torch.obs import trace
from parallax_tpu_torch.obs.health import HealthMonitor, HostScalars
from parallax_tpu_torch.obs.metrics import (JsonlSink, MetricsRegistry,
                                            PipelineStats)

ROOT = Path(__file__).resolve().parent.parent


def _session(**cfg_kw):
    sess, *_ = tparallax.parallel_run(
        tsimple.build_model(learning_rate=0.1),
        parallax_config=tparallax.Config(run_option="AR", **cfg_kw),
        device="cpu")
    return sess


def _jax_session(**cfg_kw):
    sess, *_ = jparallax.parallel_run(
        jsimple.build_model(learning_rate=0.1),
        parallax_config=jparallax.Config(run_option="AR",
                                         search_partitions=False,
                                         **cfg_kw))
    return sess


def _batches(n, batch=64, seed=0):
    rng = np.random.default_rng(seed)
    return [tsimple.make_batch(rng, batch) for _ in range(n)]


def _stream(seed=7, n=24):
    """One seeded event stream: (step, loss_finite, grad_norm, loss),
    two NaN incidents (one loss, one grad) at fixed steps."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n):
        loss = float(rng.uniform(1.0, 3.0))
        norm = float(rng.uniform(0.1, 2.0))
        finite = True
        if s == 9:
            loss, finite = float("nan"), False
        if s == 15:
            norm = float("inf")
        out.append((s, finite, norm, loss))
    return out


# -- pipeline stats ----------------------------------------------------------


class TestPipelineStatsMigration:
    @staticmethod
    def _feed(ps, rng):
        for i in range(12):
            gap = None if i == 0 else float(rng.uniform(1e-4, 2e-3))
            ps.record_dispatch(gap, float(rng.uniform(1e-3, 5e-3)))
            ps.record_h2d(int(rng.integers(1, 1 << 20)))
            ps.record_blocked(float(rng.uniform(0, 1e-3)))

    def test_summary_shape_and_registry_names_equal_jax(self):
        got = PipelineStats(MetricsRegistry())
        want = JPipeline(JRegistry())
        self._feed(got, np.random.default_rng(3))
        self._feed(want, np.random.default_rng(3))
        drop = ("steps_per_sec",)
        g = {k: v for k, v in got.summary().items() if k not in drop}
        w = {k: v for k, v in want.summary().items() if k not in drop}
        assert g == w
        gs, ws = got.registry.snapshot(), want.registry.snapshot()
        assert sorted(gs) == sorted(ws)
        for k in gs:
            if k != "pipeline.steps_per_sec":
                assert gs[k] == ws[k], k

    def test_steps_per_sec_gauge(self):
        reg = MetricsRegistry()
        ps = PipelineStats(reg)
        for _ in range(5):
            ps.record_dispatch(None, 0.001)
            time.sleep(0.002)
        sps = reg.snapshot()["pipeline.steps_per_sec"]
        assert sps is not None and 0 < sps < 1000


# -- the JSONL sink ----------------------------------------------------------


class TestJsonlSink:
    def test_writes_parseable_lines_and_final_flush(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("c").inc(3)
        path = tmp_path / "m.jsonl"
        sink = JsonlSink(reg, str(path), interval_s=0.01)
        time.sleep(0.05)
        reg.counter("c").inc()
        sink.stop()
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        assert len(lines) >= 2
        assert lines[-1]["metrics"]["c"] == 4
        assert all("ts" in x for x in lines)
        sink.stop()   # idempotent

    def test_rotates_at_max_bytes(self, tmp_path):
        reg = MetricsRegistry()
        reg.gauge("pad").set(1.0)
        path = tmp_path / "m.jsonl"
        sink = JsonlSink(reg, str(path), interval_s=3600.0, max_bytes=200)
        for _ in range(8):
            sink._write_line()
        sink.stop()
        assert (tmp_path / "m.jsonl.1").exists()
        assert path.stat().st_size <= 200

    def test_default_keeps_unbounded_growth(self, tmp_path):
        reg = MetricsRegistry()
        path = tmp_path / "m.jsonl"
        sink = JsonlSink(reg, str(path), interval_s=3600.0)
        for _ in range(20):
            sink._write_line()
        sink.stop()
        assert not (tmp_path / "m.jsonl.1").exists()
        assert len(path.read_text().splitlines()) == 21

    @pytest.mark.parametrize("kw", [{"max_bytes": 0}, {"interval_s": 0}])
    def test_rejects_bad_knobs(self, tmp_path, kw):
        with pytest.raises(ValueError):
            JsonlSink(MetricsRegistry(), str(tmp_path / "m.jsonl"), **kw)


# -- health monitors ---------------------------------------------------------


class TestHealthMonitor:
    def test_stream_report_and_readings_equal_jax(self):
        got, want = HealthMonitor(MetricsRegistry()), JHealth(JRegistry())
        for s, finite, norm, loss in _stream():
            got.observe(s, np.bool_(finite), np.float32(norm),
                        loss=np.float32(loss))
            want.observe(s, np.bool_(finite), np.float32(norm),
                         loss=np.float32(loss))
        g, w = got.report(), want.report()
        assert g == w
        assert g["first_nonfinite_step"] == 9
        assert g["nonfinite_grad_steps"] == 1   # step 15
        assert json.dumps(got.recent_readings(), default=str) == \
            json.dumps(want.recent_readings(), default=str)
        assert got.snapshot() == want.snapshot()
        assert got.healthy is want.healthy is False

    def test_detects_injected_nan_loss(self):
        reg = MetricsRegistry()
        hm = HealthMonitor(reg)
        hm.observe(1, np.bool_(True), np.float32(1.5))
        hm.observe(2, np.bool_(False), np.float32(np.nan))
        hm.observe(3, np.bool_(True), np.float32(2.0))
        report = hm.report()
        assert report["steps_observed"] == 3
        assert report["nonfinite_loss_steps"] == 1
        assert report["nonfinite_grad_steps"] == 1
        assert report["first_nonfinite_step"] == 2
        assert report["grad_norm"]["count"] == 2
        assert not hm.healthy

    def test_lazy_consumption_defers_until_ready(self):
        class SlowValue:
            def __init__(self, v):
                self._v = v
                self.ready = False

            def is_ready(self):
                return self.ready

            def __array__(self, dtype=None, copy=None):
                assert self.ready, "materialized before ready"
                return np.asarray(self._v, dtype=dtype)

        reg = MetricsRegistry()
        hm = HealthMonitor(reg)
        slow = SlowValue(True)
        hm.observe(1, slow, None)
        assert reg.counter("health.steps_observed").value == 0
        slow.ready = True
        hm.poll()
        assert reg.counter("health.steps_observed").value == 1

    def test_host_fields_read_through_one_copy(self):
        """The session's reading: the step's scalars stacked into one
        host copy (pinned behind a CUDA event on the card; on the CPU
        the tensors themselves, ready at once)."""
        lf, gn, loss = (torch.tensor(True), torch.tensor(2.5),
                        torch.tensor(0.75, dtype=torch.bfloat16))
        fields = thealth.host_fields(lf, gn, loss)
        assert all(f.is_ready() for f in fields)
        hm = HealthMonitor(MetricsRegistry())
        hm.observe(4, *fields)
        rep = hm.report()
        assert rep["steps_observed"] == 1
        assert hm.recent_readings() == [{"step": 4, "loss": 0.75,
                                         "grad_norm": 2.5,
                                         "loss_finite": True}]
        # missing outputs stay None, host values pass through
        assert thealth.host_fields(None, gn, None)[0] is None
        assert thealth.host_fields(True, 1.0, 2.0) == (True, 1.0, 2.0)
        hs = HostScalars([gn, loss])
        assert hs.is_ready() and hs.values() == [2.5, 0.75]

    def test_device_memory_stats_empty_on_cpu(self):
        assert thealth.device_memory_stats() == {}

    def test_session_detects_nan_loss_like_jax(self):
        good = _batches(3)
        bad = _batches(1, seed=9)[0]
        bad["x"] = np.full_like(bad["x"], np.nan)
        reports = []
        for make in (_session, _jax_session):
            sess = make(monitor_health=True)
            try:
                for b in (good[0], good[1], bad, good[2]):
                    sess.run("loss", feed_dict=b)
                rep = sess.health.report()
                assert not sess.health.healthy
                assert sess.metrics_snapshot()[
                    "health.nonfinite_loss_steps"] >= 1
                reports.append({k: rep[k] for k in (
                    "steps_observed", "nonfinite_loss_steps",
                    "nonfinite_grad_steps", "first_nonfinite_step")})
            finally:
                sess.close()
        assert reports[0] == reports[1]
        assert reports[0]["first_nonfinite_step"] == 2

    def test_health_outputs_present_and_finite_when_enabled(self):
        sess = _session(monitor_health=True)
        try:
            out = tparallax.materialize(
                sess.run(None, feed_dict=_batches(1)[0]))
            assert out["loss_finite"]
            assert np.isfinite(out["grad_norm"]) and out["grad_norm"] > 0
            sess2 = _session()
            try:
                out2 = sess2.run(None, feed_dict=_batches(1)[0])
                assert "grad_norm" not in out2
                assert sess2.health is None
            finally:
                sess2.close()
        finally:
            sess.close()


# -- session integration -----------------------------------------------------


class TestSessionObservability:
    def test_trace_path_written_at_close_with_both_threads(self,
                                                           tmp_path):
        path = tmp_path / "trace.json"
        sess = _session(trace_path=str(path))
        trace.get_collector().clear()
        try:
            for _ in sess.run_iter(_batches(6), "loss"):
                pass
        finally:
            sess.close()
        doc = json.loads(path.read_text())
        xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        names = {e["name"] for e in xs}
        assert {"session.dispatch", "engine.step", "prefetch.place",
                "engine.h2d_place"} <= names
        dispatch_tids = {e["tid"] for e in xs
                         if e["name"] == "session.dispatch"}
        prefetch_tids = {e["tid"] for e in xs
                         if e["name"] == "prefetch.place"}
        assert dispatch_tids and prefetch_tids
        assert dispatch_tids.isdisjoint(prefetch_tids)

    def test_trace_buffer_grows_never_shrinks(self):
        col = trace.get_collector()
        before = col.capacity
        sess = _session(trace_buffer_events=before + 5)
        sess.close()
        assert col.capacity == before + 5
        sess = _session(trace_buffer_events=1)
        sess.close()
        assert col.capacity == before + 5
        col.set_capacity(before)

    def test_metrics_path_sink_and_snapshot(self, tmp_path):
        path = tmp_path / "metrics.jsonl"
        sess = _session(metrics_path=str(path), metrics_interval_s=0.05)
        try:
            for _ in sess.run_iter(_batches(5), "loss"):
                pass
            snap = sess.metrics_snapshot()
            assert snap["pipeline.steps"] == 5
            assert snap["engine.builds"] == 1
            assert sess.steps_per_sec is None or sess.steps_per_sec > 0
            time.sleep(0.12)
        finally:
            sess.close()
        lines = [json.loads(line) for line in path.read_text().splitlines()]
        assert lines
        assert lines[-1]["metrics"]["pipeline.steps"] == 5
        assert sess._metrics_sink is None     # stopped, thread joined

    def test_recompile_counter_flags_shape_retrace(self):
        sess = _session()
        try:
            sess.run("loss", feed_dict=_batches(1, batch=64)[0])
            assert sess.metrics_snapshot()["engine.recompiles"] == 0
            sess.run("loss", feed_dict=_batches(1, batch=32)[0])
            sess.run("loss", feed_dict=_batches(1, batch=32)[0])
            assert sess.metrics_snapshot()["engine.recompiles"] == 1
            b = _batches(1, batch=32)[0]
            sess.run("loss",
                     feed_dict={k: b[k] for k in sorted(b, reverse=True)})
            assert sess.metrics_snapshot()["engine.recompiles"] == 1
        finally:
            sess.close()

    def test_pipeline_stats_roll_up_through_run_iter(self):
        sess = _session()
        try:
            list(sess.run_iter(_batches(8), fetches=[]))
            s = sess.pipeline_stats.summary()
            assert s["steps"] == 8
            assert s["h2d_bytes_per_step"] > 0
            assert s["dispatch"]["p95_ms"] >= s["dispatch"]["p50_ms"] >= 0
        finally:
            sess.close()

    @pytest.mark.parametrize("field,value", [
        ("metrics_interval_s", 0), ("metrics_max_bytes", 0),
        ("trace_buffer_events", 0), ("flight_steps", 0)])
    def test_config_validation_matches_jax(self, field, value):
        with pytest.raises(ValueError):
            jparallax.Config(**{field: value})
        with pytest.raises(ValueError):
            tparallax.Config(**{field: value})


# -- logging -----------------------------------------------------------------


class TestLoggingConfig:
    def _restore(self):
        fmt = logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s")
        for h in parallax_log.handlers:
            h.setFormatter(fmt)
        parallax_log.setLevel("INFO")

    def test_config_overrides_level_at_session_construction(self):
        try:
            sess = _session(log_level="WARNING")
            try:
                assert parallax_log.level == logging.WARNING
            finally:
                sess.close()
        finally:
            self._restore()

    def test_noop_without_knobs(self):
        before = parallax_log.level
        configure_logging()
        assert parallax_log.level == before

    def test_json_formatter_equals_jax(self):
        from parallax_tpu.common.lib import JsonLogFormatter as JFmt
        record = logging.LogRecord("PARALLAX", logging.WARNING, __file__,
                                   1, "msg %d of %s", (7, "run"), None)
        got = json.loads(JsonLogFormatter().format(record))
        want = json.loads(JFmt().format(record))
        assert got == want
        assert got["msg"] == "msg 7 of run" and got["level"] == "WARNING"

    def test_json_formatter_includes_exception(self):
        fmt = JsonLogFormatter()
        try:
            raise RuntimeError("the cause")
        except RuntimeError:
            record = logging.LogRecord("PARALLAX", logging.ERROR,
                                       __file__, 1, "failed", (),
                                       sys.exc_info())
        doc = json.loads(fmt.format(record))
        assert "the cause" in doc["exc"]


# -- step FLOPs and the peak table -------------------------------------------


class TestStepFlops:
    @pytest.mark.parametrize("full", [False, True])
    def test_lm1b_flops_per_word_equals_jax(self, full):
        cfg = tlm1b.LM1BConfig()
        assert tflops.lm1b_matmul_flops_per_word(cfg, full) == \
            jflops.lm1b_matmul_flops_per_word(cfg, full)

    def test_lm1b_step_flops_hold_to_formula(self):
        """Counted on meta tensors (the kernels' plain versions' matmuls)
        within 1 % of the shape formula times the step's B x T words."""
        cfg = tlm1b.tiny_config(sparse_grad_mode="slices",
                                lstm_impl="kernel")
        sess, *_ = tparallax.parallel_run(
            tlm1b.build_model(cfg), parallax_config=tparallax.Config(
                run_option="HYBRID", sparse_grad_mode="slices"),
            device="cpu")
        try:
            b = tlm1b.make_batch(np.random.default_rng(0), 8, 5,
                                 cfg.vocab_size)
            sess.run("loss", feed_dict=b)
            got = sess.step_flops()
            want = tflops.lm1b_matmul_flops_per_word(cfg) * 8 * 5
            assert got == pytest.approx(want, rel=1e-2)
            assert sess.step_flops(cheap_only=False) == got   # cached
        finally:
            sess.close()

    @pytest.mark.parametrize("flash,tol", [(False, 1e-2), (True, 5e-2)])
    def test_bert_step_flops_hold_to_chip_smoke_formula(self, flash, tol):
        """Plain attention within 1 %; the flash route within 5 %: its
        dq and dk/dv passes each recompute the scores, three products a
        layer beyond the formula's (4.3 % more at this shape, 3.8 % at
        BERT-large's T 512)."""
        sys.path.insert(0, str(ROOT))
        import chip_smoke
        cfg = tbert.tiny_config(use_pallas_attention=flash)
        sess, *_ = tparallax.parallel_run(
            tbert.build_model(cfg),
            parallax_config=tparallax.Config(run_option="HYBRID"),
            device="cpu")
        try:
            b = tbert.make_batch(np.random.default_rng(0), 4, 16, 5,
                                 cfg.vocab_size)
            sess.run("loss", feed_dict=b)
            m = chip_smoke.bert_model_flops(cfg, 4, seq=16, masked=5)
            want = (m["bf16_tflop"] + m["fp32_tflop"]) * 1e12
            got = sess.step_flops()
            assert got == pytest.approx(want, rel=tol)
            assert got >= want
        finally:
            sess.close()

    def test_peak_table_knows_the_h100_sxm_alone(self):
        assert tflops.device_peak_flops(
            "cuda", "NVIDIA H100 80GB HBM3") == 989.4e12
        for kind in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL",
                     "NVIDIA A100-SXM4-80GB", "", "TPU v5 lite"):
            assert tflops.device_peak_flops("cuda", kind) is None
        assert tflops.device_peak_flops("cpu",
                                        "NVIDIA H100 80GB HBM3") is None
        assert tflops.mfu(1e9, 1e3, None) is None
        assert tflops.mfu(1e9, 1e3, 1e13) == pytest.approx(0.1)

    def test_cpu_session_mfu_stays_null(self):
        cfg = tlm1b.tiny_config(lstm_impl="kernel")
        sess, *_ = tparallax.parallel_run(
            tlm1b.build_model(cfg),
            parallax_config=tparallax.Config(run_option="HYBRID"),
            device="cpu")
        try:
            b = tlm1b.make_batch(np.random.default_rng(1), 4, 5,
                                 cfg.vocab_size)
            sess.run("loss", feed_dict=b)
            flops = sess.step_flops()
            assert flops is not None and flops > 0
            sess._ensure_flops()
            sess.run("loss", feed_dict=b)
            g = sess.timeline.goodput()
            assert g["flops_per_step"] == flops
            assert g["mfu_mean"] is None      # no peak on the CPU
        finally:
            sess.close()


def test_obs_kill_switch_shared_by_the_instruments():
    reg = MetricsRegistry()
    obs.disable()
    try:
        reg.counter("c").inc()
        assert not obs.is_enabled()
    finally:
        obs.enable()
    assert reg.counter("c").value == 0
