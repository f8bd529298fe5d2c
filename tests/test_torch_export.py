"""The port's telemetry export and memory watch held to the JAX
package's, and the fleet's observability (``tests/test_fleet.py``'s
``test_incident_dump_correlates_fleet_state`` and
``test_fleet_chaos_guard``):

* ``render_prometheus`` on registry snapshots made from a numpy seed
  (counters, gauges, histograms, a None, a bool, odd metric names) and
  alert rows: the text equal to JAX's, byte for byte;
* ``TelemetryExporter`` bound to ``127.0.0.1`` on port 0: ``/metrics``,
  ``/healthz``, a 404, a failing snapshot as a 500; ``close()`` joins
  the server thread;
* ``MemWatch`` fed one seeded stream of device-memory stats through
  both packages: the ring (leaving out stamps), the per-device gauges,
  the ``oom_risk`` incident and ``stats()`` equal; the killswitch and
  the CPU latch;
* the fleet: ``start_exporter`` scraped after a replica crash; the crash
  leaves one correlated flight artifact (the crashed replica, each
  affected request's hop trail, the router's states, the in-flight
  table, the per-replica registries); the chaos guard — a crash and two
  hot swaps under traffic with no accepted request lost, no late
  service, no serve-time capture and the ``fleet_crash`` artifact.
"""

import glob
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from parallax_tpu.obs import export as jexport
from parallax_tpu.obs.memwatch import MemWatch as JMemWatch
from parallax_tpu.obs.metrics import MetricsRegistry as JRegistry
import parallax_tpu_torch as tpx
from parallax_tpu_torch import obs
from parallax_tpu_torch.obs import export
from parallax_tpu_torch.obs.flightrec import FlightRecorder
from parallax_tpu_torch.obs.memwatch import MemWatch
from parallax_tpu_torch.obs.metrics import MetricsRegistry
from parallax_tpu_torch.serve import (FaultInjector, FleetConfig,
                                      ServeFleet, ServeSession)
from parallax_tpu_torch.serve.router import EJECTED


def _fill(reg, rng, n=12):
    names = ["serve.requests", "fleet.replicas", "a.b-c d", "health.x",
             "engine.recompiles", "numerics.enc.grad_norm", "p95.ms"]
    for i, name in enumerate(names):
        if i % 3 == 0:
            reg.counter(name).inc(int(rng.integers(0, 100)))
        elif i % 3 == 1:
            reg.gauge(name).set(float(rng.normal()))
        else:
            h = reg.histogram(name)
            for _ in range(n):
                h.record(float(rng.uniform(0, 50)))
    reg.gauge("none_gauge").set(None)
    reg.gauge("flag").set(True)
    reg.gauge("text").set("not a number")


def _snapshots(pkg_registry, seed=2):
    rng = np.random.default_rng(seed)
    out = {}
    for source in ("fleet", "replica0", "replica1", ""):
        reg = pkg_registry()
        _fill(reg, rng)
        out[source] = reg.snapshot()
    return out


ALERTS = [{"alert": "hot", "severity": "error", "state": "firing",
           "value": 1.0},
          {"alert": "cold", "severity": "warning", "state": "ok",
           "value": 0.0}]


class TestRenderPrometheus:
    def test_text_equals_jax_byte_for_byte(self):
        got = export.render_prometheus(_snapshots(MetricsRegistry),
                                       alerts=ALERTS)
        want = jexport.render_prometheus(_snapshots(JRegistry),
                                         alerts=ALERTS)
        assert got == want
        assert 'parallax_a_b_c_d_count{source="fleet"}' in got
        assert 'quantile="0.95"' in got
        assert "none_gauge" not in got and "parallax_text" not in got

    @pytest.mark.parametrize("prefix", ["parallax", "x"])
    def test_prefix_and_empty_equal_jax(self, prefix):
        assert export.render_prometheus({}, prefix) == \
            jexport.render_prometheus({}, prefix)
        snaps = _snapshots(MetricsRegistry, seed=5)
        assert export.render_prometheus(snaps, prefix) == \
            jexport.render_prometheus(_snapshots(JRegistry, seed=5),
                                      prefix)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


class TestTelemetryExporter:
    def test_serves_localhost_and_close_joins(self):
        reg = MetricsRegistry()
        reg.counter("serve.requests").inc(3)
        ex = export.TelemetryExporter.for_registry(reg, source="r0",
                                                   port=0)
        assert ex.url is None
        with ex:
            assert ex._host == "127.0.0.1" and ex.port > 0
            status, text = _get(ex.url)
            assert status == 200
            assert 'parallax_serve_requests{source="r0"} 3.0' in text
            assert json.loads(_get(
                f"http://127.0.0.1:{ex.port}/healthz")[1]) == {"ok": True}
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(f"http://127.0.0.1:{ex.port}/nope")
            assert e.value.code == 404
            thread = ex._thread
        assert ex._server is None and not thread.is_alive()
        ex.close()        # idempotent

    def test_failing_snapshot_is_a_500(self):
        def boom():
            raise RuntimeError("poisoned")
        ex = export.TelemetryExporter(boom).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(ex.url)
            assert e.value.code == 500
        finally:
            ex.close()

    def test_scrape_is_the_rendered_snapshot(self):
        reg = MetricsRegistry()
        reg.gauge("g").set(2.5)
        ex = export.TelemetryExporter(
            lambda: {"x": reg.snapshot()},
            alerts_fn=lambda: ALERTS).start()
        try:
            assert _get(ex.url)[1] == export.render_prometheus(
                {"x": reg.snapshot()}, alerts=ALERTS)
        finally:
            ex.close()


# -- the memory watch ------------------------------------------------------------


def _mem_stream(seed=6, n=60):
    rng = np.random.default_rng(seed)
    limit = 80 * 2 ** 30
    out = []
    used = 20 * 2 ** 30
    for i in range(n):
        used += int(rng.integers(0, 6 * 2 ** 30))
        out.append({"cuda:0": {"bytes_in_use": min(used, limit),
                               "peak_bytes_in_use": min(used, limit),
                               "bytes_limit": limit,
                               "bytes_reserved": min(used, limit)}})
    return out


class TestMemWatch:
    @staticmethod
    def _run(cls, reg, stream):
        it = iter(stream)
        triggers = []

        class Spy:
            def trigger(self, reason, detail):
                triggers.append((reason, detail))

        mw = cls(reg, flight=Spy(), capacity=8, every=2,
                 stats_fn=lambda: next(it))
        rows = [mw.sample(step) for step in range(len(stream))]
        return mw, rows, triggers

    def test_seeded_stream_equals_jax(self):
        stream = _mem_stream()
        # JAX's ring keeps the same three fields a device reports
        got, grows, gtr = self._run(MemWatch, MetricsRegistry(), stream)
        want, wrows, wtr = self._run(JMemWatch, JRegistry(), stream)
        strip = lambda rows: [None if r is None else
                              {k: v for k, v in r.items() if k != "ts"}
                              for r in rows]
        assert strip(grows) == strip(wrows)
        assert gtr == wtr and gtr[0][0] == "oom_risk"
        gs, ws = got.stats(), want.stats()
        for s in (gs, ws):
            s["ring"] = strip(s["ring"])
        assert gs == ws
        g, w = got.registry.snapshot(), want.registry.snapshot()
        assert {k: g[k] for k in g if k.startswith(("device.", "memwatch"))} \
            == {k: w[k] for k in w if k.startswith(("device.", "memwatch"))}
        assert got.live_peak_bytes() == want.live_peak_bytes()

    def test_cpu_latch_and_killswitch(self):
        mw = MemWatch(MetricsRegistry())        # the CPU: no stats
        for s in range(5):
            assert mw.sample(s) is None
        assert mw._unavailable and mw.total_samples == 0
        mw2 = MemWatch(MetricsRegistry(), stats_fn=lambda: _mem_stream()[0])
        obs.disable()
        try:
            assert mw2.sample(0) is None
        finally:
            obs.enable()
        assert mw2.total_samples == 0
        assert mw2.sample(1) is not None

    @pytest.mark.parametrize("kw", [dict(capacity=0), dict(every=0),
                                    dict(oom_risk_frac=0.0)])
    def test_validation(self, kw):
        with pytest.raises(ValueError):
            MemWatch(MetricsRegistry(), **kw)

    def test_session_memwatch_section_on_the_cpu(self, tmp_path):
        from parallax_tpu_torch.models import simple
        sess, *_ = tpx.parallel_run(
            simple.build_model(0.1),
            parallax_config=tpx.Config(run_option="AR"), device="cpu")
        try:
            for i in range(4):
                sess.run("loss", feed_dict=simple.make_batch(
                    np.random.default_rng(i), 8))
            doc = json.load(open(sess.dump_flight(str(tmp_path / "f"))))
            assert doc["memwatch"]["samples"] == 0
            assert doc["memwatch"]["compiled"] is None
            assert doc["device_memory"] == {}
        finally:
            sess.close()


# -- the fleet ----------------------------------------------------------------------


_DIM = 4


def _infer(p, b):
    return {"y": (b["x"] @ p["w"]).mean(dim=(1, 2))}


def _mlp_fleet(faults=None, flight=None, **obs_kw):
    params = {"w": torch.eye(_DIM)}
    cfg = tpx.Config(serve_config=tpx.ServeConfig(max_batch=2,
                                                  max_wait_ms=1.0))

    def make_replica(rid, **kw):
        return ServeSession(
            _infer, params,
            example_feed={"x": np.zeros((4, _DIM), np.float32)},
            config=cfg, device="cpu", **kw)

    fc = FleetConfig(num_replicas=2, tick_interval_s=3600.0)
    return ServeFleet(make_replica, config=fc, faults=faults,
                      flight=flight, **obs_kw), params


def _feed(v):
    return {"x": np.full((4, _DIM), float(v), np.float32)}


def test_fleet_exporter_scraped_after_a_crash(tmp_path):
    inj = FaultInjector()
    fleet, _ = _mlp_fleet(faults=inj)
    try:
        ex = fleet.start_exporter()
        assert ex.url.startswith("http://127.0.0.1:")
        inj.arm(0, "crash")
        for r in [fleet.submit(_feed(i)) for i in range(8)]:
            r.result(timeout=30.0)
        status, text = _get(ex.url)
        assert status == 200
        assert 'parallax_fleet_failovers{source="fleet"}' in text
        assert 'source="replica1"' in text
        again = fleet.start_exporter()       # the first one is stopped
        assert ex._server is None and again.port > 0
    finally:
        fleet.close()
    assert fleet._exporter is None and again._server is None


def test_incident_dump_correlates_fleet_state(tmp_path):
    inj = FaultInjector()
    flight = FlightRecorder(flight_dir=str(tmp_path))
    fleet, _ = _mlp_fleet(faults=inj, flight=flight)
    try:
        inj.arm(0, "crash")
        reqs = [fleet.submit(_feed(i)) for i in range(8)]
        for r in reqs:
            r.result(timeout=30.0)
        retried = [r for r in reqs if len(r.replicas) > 1]
        assert retried
    finally:
        fleet.close()
    dumps = glob.glob(str(tmp_path / "flight_fleet_crash*.json"))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    assert doc["incident_id"]
    assert doc["detail"]["replica"] == 0
    affected = {a["id"]: a["hops"] for a in doc["detail"]["affected_requests"]}
    for r in retried:
        assert affected.get(r.id) == r.replicas, (r.id, affected)
    states = {row["rid"]: row for row in doc["router"]}
    assert states[0]["state"] == EJECTED and states[0]["dead"]
    assert "circuit" in states[0] and "heartbeat_age_s" in states[0]
    assert isinstance(doc["requests_in_flight"], list)
    assert doc["fleet"]["replicas"]["0"]["serve"]
    assert isinstance(doc["request_records"], list)


def _traffic(fleet, action, scales):
    """Closed-loop traffic from four client threads around ``action()``:
    the requests lost (an exception or a wrong output for every scale in
    ``scales``), the late ones and the completed ones."""
    lost, late, done = [], [], []
    stop = threading.Event()

    def client(k):
        i = 0
        while not stop.is_set():
            v = float(k * 100 + i)
            req = fleet.submit(_feed(v), deadline_ms=10_000.0)
            try:
                out = float(np.asarray(req.result(timeout=30.0)["y"]))
            except Exception as e:            # noqa: BLE001
                lost.append(repr(e))
            else:
                if not any(out == v * s for s in scales):
                    lost.append((v, out))
                done.append(req)
                if getattr(req, "late", False):
                    late.append(req)
            i += 1

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)
        out = action()
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60.0)
    return out, lost, late, done


def test_fleet_chaos_guard(tmp_path):
    """Closed-loop traffic from four client threads while replica 0
    crashes, and on a second fleet while new weights are pushed twice:
    every accepted request completes correctly (before its deadline),
    nothing is captured at serve time on any replica (fresh and
    swapped), the crash leaves its ``fleet_crash`` artifact and the
    journal records the churn."""
    inj = FaultInjector()
    flight = FlightRecorder(flight_dir=str(tmp_path))
    journal = obs.EventJournal(registry=MetricsRegistry())
    fleet, _ = _mlp_fleet(faults=inj, flight=flight, journal=journal)
    try:
        _, lost, late, done = _traffic(fleet, lambda: inj.arm(0, "crash"),
                                       (1.0,))
        s = fleet.stats()
        assert fleet.recompiles() == 0
    finally:
        fleet.close()
    assert not lost and not late and len(done) > 20
    assert s["fleet.failovers"] >= 1 and s["fleet.failed"] == 0
    assert glob.glob(str(tmp_path / "flight_fleet_crash*.json"))
    assert any(e["subsystem"] == "fleet" for e in journal.events())

    anomaly = obs.AnomalyMonitor(MetricsRegistry())
    for s in range(20):                  # a baseline the swaps reset
        anomaly.observe("fleet.latency_ms", s, 1.0)
    fleet, _ = _mlp_fleet(anomaly=anomaly)
    try:
        def swap_twice():
            return [fleet.push_weights({"w": torch.eye(_DIM) * k})
                    for k in (2.0, 3.0)]

        outcomes, lost, late, done = _traffic(fleet, swap_twice,
                                              (1.0, 2.0, 3.0))
        s = fleet.stats()
        assert fleet.recompiles() == 0
    finally:
        fleet.close()
    assert not lost and not late and len(done) > 20
    assert all(set(o.values()) == {"swapped"} for o in outcomes)
    assert s["fleet.hotswaps"] == 4 and s["fleet.failed"] == 0
    # each push is a deliberate change: the detectors rebaseline
    assert anomaly.registry.counter("anomaly.deliberate_changes").value \
        == 2
    assert anomaly.snapshot()["fleet.latency_ms"]["window"] == []
