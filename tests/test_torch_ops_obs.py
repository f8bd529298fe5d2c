"""The port's ops observatory held to the JAX package's
(``tests/test_ops.py``'s ``TestEventJournal``, ``TestGoodputLedger``,
``TestAlertEngine``, ``TestSessionIntegration`` and
``test_goodput_chaos_guard``):

* ``EventJournal``, ``GoodputLedger`` and ``AlertEngine`` fed one event
  stream made from a numpy seed through both packages' classes: journal
  ``seq`` order and envelopes, goodput accounts and alert lifecycles
  equal, leaving out wall-clock stamps (``ts``, ``wall_s``,
  ``saved_at``);
* the session: the ledger across a checkpoint save and restore, the
  journal and alerts in flight dumps, the close event, checkpoint saves
  journaled;
* checkpoint extras written by the JAX session restore into the port's
  anomaly, health and goodput monitors, and the reverse;
* the chaos guard: three port training processes (a clean run, a
  SIGKILL mid-run and its resume, a NaN rollback) whose accounts sum to
  their wall, match the parent's wall within 5 %, fire no alert on the
  clean run, span both attempts across the kill, and book the discarded
  steps in ``rollback_discarded`` after the rollback's journal event.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as tparallax
from parallax_tpu.models import lm1b as jlm1b
from parallax_tpu.obs.alerts import AlertEngine as JAlertEngine
from parallax_tpu.obs.alerts import AlertRule as JAlertRule
from parallax_tpu.obs.alerts import builtin_rules as jbuiltin_rules
from parallax_tpu.obs.goodput import GoodputLedger as JLedger
from parallax_tpu.obs.journal import EventJournal as JJournal
from parallax_tpu.obs.metrics import MetricsRegistry as JRegistry
from parallax_tpu_torch import obs
from parallax_tpu_torch.models import lm1b as tlm1b
from parallax_tpu_torch.models import simple
from parallax_tpu_torch.obs.alerts import (AlertEngine, AlertRule,
                                           builtin_rules)
from parallax_tpu_torch.obs.export import render_prometheus
from parallax_tpu_torch.obs.goodput import (BADPUT_CLASSES, GoodputLedger,
                                            dominant_badput, step_goodput)
from parallax_tpu_torch.obs.journal import EventJournal, read_journal
from parallax_tpu_torch.obs.metrics import MetricsRegistry

ROOT = Path(__file__).resolve().parent.parent


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


PKGS = {"port": (EventJournal, GoodputLedger, AlertEngine, AlertRule,
                 builtin_rules, MetricsRegistry),
        "jax": (JJournal, JLedger, JAlertEngine, JAlertRule,
                jbuiltin_rules, JRegistry)}


def _strip(event):
    return {k: v for k, v in event.items() if k != "ts"}


# -- event journal ------------------------------------------------------------


def _journal_stream(journal, seed=3):
    rng = np.random.default_rng(seed)
    subs = ("ckpt", "anomaly", "recovery", "flight", "alert", "ops")
    for i in range(40):
        sub = subs[int(rng.integers(len(subs)))]
        sev = ("debug", "info", "warning", "error", "bogus")[
            int(rng.integers(5))]
        kw = {"i": i, "v": round(float(rng.normal()), 6)}
        if i % 7 == 0:
            kw["incident_id"] = f"inc-{i}"
        if i % 11 == 0:
            kw["kind"] = "payload"
        journal.emit(sub, f"k{int(rng.integers(4))}", severity=sev, **kw)


class TestEventJournal:
    def test_seeded_stream_equals_jax(self, tmp_path):
        out = {}
        for name, (J, _, _, _, _, R) in PKGS.items():
            j = J(capacity=16, path=str(tmp_path / f"{name}.jsonl"),
                  max_bytes=2000, registry=R())
            _journal_stream(j)
            out[name] = ([_strip(e) for e in j.events()],
                         [_strip(e) for e in read_journal(
                             str(tmp_path / f"{name}.jsonl"))], j.seq,
                         {k: v for k, v in j._registry.snapshot().items()
                          if k.startswith("journal")})
        assert out["port"] == out["jax"]
        assert [e["seq"] for e in out["port"][0]] == list(range(25, 41))

    def test_seq_is_causal_and_ring_bounded(self):
        j = EventJournal(capacity=4, registry=MetricsRegistry())
        for i in range(10):
            j.emit("t", "tick", i=i)
        assert j.seq == 10
        assert [e["seq"] for e in j.events()] == [7, 8, 9, 10]
        tail = j.tail(2)
        assert [e["seq"] for e in tail] == [9, 10]
        tail[0]["seq"] = -1
        assert j.events()[-2]["seq"] == 9

    def test_event_envelope_and_correlation_ids(self):
        j = EventJournal(registry=MetricsRegistry())
        e = j.emit("ckpt", "save", severity="warning",
                   incident_id="inc-1", request_id="r9", step=4)
        assert (e["subsystem"], e["kind"], e["severity"]) == \
            ("ckpt", "save", "warning")
        assert e["incident_id"] == "inc-1" and e["request_id"] == "r9"
        assert e["fields"] == {"step": 4}
        assert j.emit("t", "x", severity="catastrophic")["severity"] == \
            "info"
        e2 = j.emit("anomaly", "spike", kind="loss")
        assert e2["kind"] == "spike" and e2["fields"]["kind"] == "loss"

    def test_read_journal_skips_garbage(self, tmp_path):
        p = str(tmp_path / "j.jsonl")
        with open(p, "w") as f:
            f.write('{"seq": 2, "ts": 5.0, "kind": "b"}\n')
            f.write("NOT JSON AT ALL\n")
            f.write('{"seq": 1, "ts": 4.0, "kind": "a"}\n')
        assert [e["kind"] for e in read_journal(p)] == ["a", "b"]
        assert read_journal(str(tmp_path / "missing.jsonl")) == []

    def test_killswitch_emit_is_noop(self):
        j = EventJournal(registry=MetricsRegistry())
        j.emit("t", "kept")
        obs.disable()
        try:
            assert j.emit("t", "dropped") is None
        finally:
            obs.enable()
        assert j.seq == 1

    def test_non_json_fields_degrade_not_kill(self, tmp_path):
        p = str(tmp_path / "j.jsonl")
        j = EventJournal(path=p, registry=MetricsRegistry())
        j.emit("t", "np", value=np.float32(1.5), arr=torch.arange(2))
        assert len(read_journal(p)) == 1

    @pytest.mark.parametrize("kw", [dict(capacity=0), dict(max_bytes=0)])
    def test_validation(self, kw):
        with pytest.raises(ValueError):
            EventJournal(**kw)


# -- goodput ledger -----------------------------------------------------------


def _row(step, wall_ms, data_wait_ms=0.0):
    return {"step": step, "wall_ms": wall_ms, "data_wait_ms": data_wait_ms}


def _ledger_ops(led, seed=9):
    rng = np.random.default_rng(seed)
    for s in range(30):
        led.on_step(_row(s, float(rng.uniform(5, 20)),
                         float(rng.uniform(0, 2))))
        if s % 9 == 8:
            led.note_badput("ckpt_stall", float(rng.uniform(0, 5e-3)),
                            carve_from_productive=True)
    led.note_badput("compile_warmup", 0.25)
    return led.on_rollback(26)


def _acct(a):
    drop = ("wall_s", "goodput_fraction")
    out = {k: v for k, v in a.items() if k not in drop}
    out["badput_s"] = {k: v for k, v in a["badput_s"].items()
                       if k != "unattributed"}
    return out


class TestGoodputLedger:
    def test_seeded_account_equals_jax(self):
        got, want = GoodputLedger(MetricsRegistry()), JLedger(JRegistry())
        assert _ledger_ops(got) == _ledger_ops(want)
        assert _acct(got.account()) == _acct(want.account())
        for led in (got, want):
            a = led.account()
            total = a["productive_s"] + sum(a["badput_s"].values())
            assert total == pytest.approx(a["wall_s"], abs=1e-5)

    def test_snapshot_restores_across_packages(self):
        src = GoodputLedger(MetricsRegistry(), run_epoch=time.time() - 5)
        _ledger_ops(src)
        snap = json.loads(json.dumps(src.snapshot()))
        snap["saved_at"] = time.time() - 2.0
        got = GoodputLedger(MetricsRegistry())
        want = JLedger(JRegistry())
        got.restore_snapshot(snap, restore_s=0.5)
        want.restore_snapshot(snap, restore_s=0.5)
        g, w = got.account(), want.account()
        assert g["attempts"] == w["attempts"] == 2
        assert g["steps"] == w["steps"] == 30
        assert g["productive_s"] == w["productive_s"]
        for k in ("compile_warmup", "ckpt_stall", "restore_replay",
                  "rollback_discarded", "data_wait"):
            assert g["badput_s"][k] == w["badput_s"][k], k
        assert g["badput_s"]["eviction_downtime"] == pytest.approx(
            w["badput_s"]["eviction_downtime"], abs=0.5)

    def test_step_partition_and_sum_to_wall(self):
        led = GoodputLedger(MetricsRegistry())
        led.on_step(_row(0, 100.0, data_wait_ms=10.0))
        led.on_step(_row(1, 50.0))
        acct = led.account()
        assert acct["productive_s"] == pytest.approx(0.14)
        assert acct["badput_s"]["data_wait"] == pytest.approx(0.01)
        total = acct["productive_s"] + sum(acct["badput_s"].values())
        assert total == pytest.approx(acct["wall_s"], abs=1e-6)
        assert set(BADPUT_CLASSES) <= set(acct["badput_s"])

    def test_rollback_refunds_measured_time(self):
        led = GoodputLedger(MetricsRegistry())
        for s in range(6):
            led.on_step(_row(s, 100.0))
        assert led.on_rollback(4) == pytest.approx(0.2)
        assert led.account()["productive_s"] == pytest.approx(0.4)
        assert led.on_rollback(4) == 0.0
        with pytest.raises(ValueError):
            led.note_badput("no_such_class", 1.0)

    def test_run_epoch_anchors_startup_as_compile_warmup(self):
        led = GoodputLedger(MetricsRegistry(), run_epoch=time.time() - 30.0)
        acct = led.account()
        assert acct["badput_s"]["compile_warmup"] == pytest.approx(
            30.0, abs=2.0)

    def test_killswitch_on_step_is_noop(self):
        led = GoodputLedger(MetricsRegistry())
        obs.disable()
        try:
            led.on_step(_row(0, 100.0))
            led.note_badput("data_wait", 1.0)
            assert led.on_rollback(0) == 0.0
        finally:
            obs.enable()
        assert led.account()["steps"] == 0

    def test_dominant_badput_and_step_goodput(self):
        assert dominant_badput({"badput_s": {}}) is None
        assert dominant_badput({"badput_s": {"data_wait": 1.0,
                                             "ckpt_stall": 3.0}}) == \
            "ckpt_stall"
        tl = obs.StepTimeline(MetricsRegistry(), capacity=16)
        for s in range(4):
            tl.record_step(s, 0.0, 1e-3, 1e-4, 1e-4, 1e-4, 5e-4, 0.0)
        assert tl.goodput() == step_goodput(tl)


# -- alert engine ----------------------------------------------------------------


def _alert_run(pkg):
    J, _, E, Rule, builtins, R = PKGS[pkg]
    reg = R()
    clk = FakeClock()
    j = J(registry=reg)

    class Spy:
        def __init__(self):
            self.triggers = []

        def trigger(self, reason, detail):
            self.triggers.append(reason)

    fl = Spy()
    rules = tuple(builtins(0.4)) + (
        Rule("hot", "g", op=">", threshold=5.0, for_s=10.0,
             cooldown_s=20.0, severity="error"),
        Rule("burn", "c", kind="burn_rate", op=">", threshold=0.5,
             window_s=60.0, cooldown_s=0.0),
        Rule("dead", "heartbeat", kind="absence", cooldown_s=0.0),
        Rule("p", "lat_ms.max", op=">", threshold=50.0, cooldown_s=0.0),
        Rule("floor", "frac", op="<", threshold=0.5, guard_metric="wall",
             guard_min=100.0, cooldown_s=0.0))
    eng = E(reg, rules=rules, journal=j, flight=fl, clock=clk)
    rng = np.random.default_rng(12)
    trail = []
    for t in range(0, 400, 5):
        clk.t = float(t)
        reg.gauge("g").set(float(rng.uniform(0, 10)))
        reg.counter("c").inc(int(rng.integers(0, 80)) if t % 50 == 0
                             else 0)
        if t >= 200:
            reg.gauge("heartbeat").set(1.0)
        reg.histogram("lat_ms").record(float(rng.uniform(1, 70)))
        reg.gauge("frac").set(float(rng.uniform(0, 1)))
        reg.gauge("wall").set(float(t))
        reg.gauge("health.instability").set(float(rng.uniform(0, 0.9)))
        trail.append([(e["transition"], e["rule"].name, e["value"])
                      for e in eng.evaluate()])
    return (trail, [_strip(e) for e in j.events()], fl.triggers,
            eng.summary(), eng.prometheus_alerts(), eng.active())


class TestAlertEngine:
    def test_seeded_lifecycle_equals_jax(self):
        got, want = _alert_run("port"), _alert_run("jax")
        assert got == want
        fired = {n for step in got[0] for tr, n, _ in step
                 if tr == "firing"}
        assert {"hot", "burn", "dead", "p", "floor"} <= fired

    def test_rule_validation(self):
        with pytest.raises(ValueError):
            AlertRule("x", "m", kind="nope")
        with pytest.raises(ValueError):
            AlertRule("x", "m", op="!=")
        with pytest.raises(ValueError):
            AlertRule("x", "m", kind="burn_rate", window_s=0)

    def test_builtin_rules_equal_jax(self):
        assert [tuple(sorted(vars(r).items())) for r in builtin_rules(0.4)] \
            == [tuple(sorted(vars(r).items())) for r in jbuiltin_rules(0.4)]

    def test_threshold_lifecycle_pending_firing_resolved(self):
        reg = MetricsRegistry()
        clk = FakeClock()
        eng = AlertEngine(reg, rules=(AlertRule(
            "hot", "g", op=">", threshold=5.0, for_s=10.0,
            cooldown_s=0.0),), clock=clk)
        g = reg.gauge("g")
        g.set(9.0)
        clk.t = 100.0
        assert eng.evaluate() == [] and eng.state("hot") == "pending"
        clk.t = 111.0
        assert [e["transition"] for e in eng.evaluate()] == ["firing"]
        clk.t = 112.0
        assert eng.evaluate() == []
        g.set(1.0)
        clk.t = 113.0
        assert [e["transition"] for e in eng.evaluate()] == ["resolved"]

    def test_prometheus_alert_rows(self):
        reg = MetricsRegistry()
        clk = FakeClock(1.0)
        eng = AlertEngine(reg, rules=(
            AlertRule("hot", "g", op=">", threshold=0.5, cooldown_s=0.0,
                      severity="error"),), clock=clk)
        reg.gauge("g").set(1.0)
        eng.evaluate()
        text = render_prometheus({"": reg.snapshot()},
                                 alerts=eng.prometheus_alerts())
        assert 'parallax_alerts{alert="hot",severity="error",' \
               'state="firing"} 1.0' in text
        assert "parallax_alerts_firings 1.0" in text

    def test_poll_throttles_and_thread_start_stop(self):
        reg = MetricsRegistry()
        clk = FakeClock(1.0)
        eng = AlertEngine(reg, rules=(AlertRule(
            "hot", "g", op=">", threshold=0.5, cooldown_s=0.0),),
            interval_s=30.0, clock=clk)
        reg.gauge("g").set(1.0)
        eng.poll()
        assert eng.state("hot") == "firing"
        reg.gauge("g").set(0.0)
        clk.t = 10.0
        eng.poll()
        assert eng.state("hot") == "firing"
        clk.t = 40.0
        eng.poll()
        assert eng.state("hot") == "ok"
        eng2 = AlertEngine(reg, rules=(), interval_s=0.01)
        eng2.start()
        time.sleep(0.05)
        eng2.stop()
        assert eng2._thread is None
        assert int(reg.snapshot()["alerts.evals"]) >= 1

    def test_evaluate_never_raises_on_poisoned_gauge(self):
        reg = MetricsRegistry()
        reg.gauge("bad").set_fn(lambda: 1 / 0)
        eng = AlertEngine(reg, rules=(AlertRule("x", "bad"),),
                          clock=FakeClock())
        assert eng.evaluate() == []

    def test_killswitch_structural_noop(self):
        reg = MetricsRegistry()
        clk = FakeClock(1.0)
        eng = AlertEngine(reg, rules=(AlertRule(
            "hot", "g", op=">", threshold=0.5, cooldown_s=0.0),), clock=clk)
        reg.gauge("g").set(1.0)
        obs.disable()
        try:
            assert eng.evaluate() == []
            eng.poll()
        finally:
            obs.enable()
        assert eng.state("hot") == "ok"

    def test_clean_session_fires_no_builtin_alert(self):
        reg = MetricsRegistry()
        reg.gauge("health.instability").set(0.1)
        reg.gauge("ops.goodput_fraction").set(0.05)
        reg.gauge("ops.wall_s").set(30.0)
        clk = FakeClock()
        eng = AlertEngine(reg, rules=builtin_rules(), clock=clk)
        for t in (1.0, 50.0, 100.0):
            clk.t = t
            assert eng.evaluate() == []
        assert eng.active() == []


# -- session integration ------------------------------------------------------------


def _session(**cfg_kw):
    sess, *_ = tparallax.parallel_run(
        simple.build_model(learning_rate=0.1),
        parallax_config=tparallax.Config(run_option="AR", **cfg_kw),
        device="cpu")
    return sess


class TestSessionIntegration:
    def test_ledger_persists_across_ckpt_save_restore(self, tmp_path):
        ck = str(tmp_path / "ck")
        rng = np.random.default_rng(0)
        sess = _session(ckpt_config=tparallax.CheckPointConfig(
            ckpt_dir=ck, save_ckpt_steps=2))
        for _ in range(4):
            sess.run(feed_dict=simple.make_batch(rng, 32))
        acct1 = sess.ops_account()
        assert acct1["attempts"] == 1 and acct1["steps"] == 4
        assert acct1["badput_s"]["ckpt_stall"] > 0
        sess.close()
        sess2 = _session(ckpt_config=tparallax.CheckPointConfig(
            ckpt_dir=ck, save_ckpt_steps=2))
        sess2.prepare(simple.make_batch(rng, 32))
        try:
            acct2 = sess2.ops_account()
            assert acct2["attempts"] == 2
            assert acct2["steps"] >= 4
            assert acct2["badput_s"]["restore_replay"] > 0
            total = acct2["productive_s"] + sum(acct2["badput_s"].values())
            assert total == pytest.approx(acct2["wall_s"], abs=1e-4)
            kinds = [(e["subsystem"], e["kind"])
                     for e in sess2.journal.events()]
            assert ("ckpt", "restored") in kinds
            assert ("ops", "ledger_restored") in kinds
        finally:
            sess2.close()

    def test_flight_dump_embeds_journal_ops_alerts(self, tmp_path):
        sess = _session(journal_path=str(tmp_path / "j.jsonl"))
        try:
            sess.run(feed_dict=simple.make_batch(np.random.default_rng(0),
                                                 32))
            sess.journal.emit("test", "marker", note="breadcrumb")
            doc = json.load(open(sess.dump_flight(
                path=str(tmp_path / "f.json"))))
            assert any(e["kind"] == "marker" for e in doc["journal_tail"])
            assert doc["ops"]["wall_s"] > 0
            assert "goodput_fraction" in doc["ops"]
            assert doc["alerts"]["rules"] >= 5
            assert doc["alerts"]["firing"] == []
            ev = [e for e in sess.journal.events()
                  if e["subsystem"] == "flight"]
            assert ev and ev[-1]["incident_id"] == doc["incident_id"]
        finally:
            sess.close()

    def test_session_close_journals_and_stops_alerts(self, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        sess = _session(journal_path=jp)
        sess.run(feed_dict=simple.make_batch(np.random.default_rng(0), 32))
        sess.close()
        assert [e for e in read_journal(jp)
                if (e["subsystem"], e["kind"]) == ("session", "close")]
        assert sess.alerts._thread is None

    def test_ckpt_saves_journal(self, tmp_path):
        sess = _session(
            journal_path=str(tmp_path / "j.jsonl"),
            ckpt_config=tparallax.CheckPointConfig(
                ckpt_dir=str(tmp_path / "ck"), save_ckpt_steps=2))
        rng = np.random.default_rng(0)
        try:
            for _ in range(4):
                sess.run(feed_dict=simple.make_batch(rng, 32))
            kinds = [(e["subsystem"], e["kind"])
                     for e in sess.journal.events()]
            assert kinds.count(("ckpt", "save")) == 2
        finally:
            sess.close()

    def test_killswitch_removes_journal_ledger_alerts(self):
        obs.disable()
        try:
            sess = _session()
            try:
                assert sess.journal is None and sess.ledger is None
                assert sess.alerts is None and sess.ops_account() is None
                sess.run(feed_dict=simple.make_batch(
                    np.random.default_rng(0), 32))
                assert sess.memwatch.total_samples == 0
                assert sess.timeline.total_rows == 0
            finally:
                sess.close()
        finally:
            obs.enable()

    @pytest.mark.parametrize("kw", [dict(journal_capacity=0),
                                    dict(journal_max_bytes=-1),
                                    dict(alert_interval_s=0),
                                    dict(goodput_floor=1.5)])
    def test_config_validation_matches_jax(self, kw):
        with pytest.raises(ValueError):
            jparallax.Config(**kw)
        with pytest.raises(ValueError):
            tparallax.Config(**kw)


# -- checkpoint extras across packages ----------------------------------------------


LM1B = dict(sparse_grad_mode="slices")


def _jax_lm1b(ck):
    cfg = jlm1b.tiny_config(**LM1B, compute_dtype=jnp.float32)
    sess, *_ = jparallax.parallel_run(
        jlm1b.build_model(cfg), parallax_config=jparallax.Config(
            run_option="HYBRID", sparse_grad_mode="slices",
            search_partitions=False, monitor_health=True,
            ckpt_config=jparallax.CheckPointConfig(
                ckpt_dir=ck, save_ckpt_steps=4)), seed=0)
    return sess


def _port_lm1b(ck):
    cfg = tlm1b.tiny_config(**LM1B, compute_dtype=torch.float32,
                            lstm_impl="kernel")
    sess, *_ = tparallax.parallel_run(
        tlm1b.build_model(cfg), parallax_config=tparallax.Config(
            run_option="HYBRID", sparse_grad_mode="slices",
            monitor_health=True,
            ckpt_config=tparallax.CheckPointConfig(
                ckpt_dir=ck, save_ckpt_steps=4)), seed=0, device="cpu")
    return sess


def _lm1b_batches(n=4):
    rng = np.random.default_rng(5)
    return [jlm1b.make_batch(rng, 8, 5, 1000) for _ in range(n)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ckpt_extras_restore_across_packages(writer, tmp_path):
    """One package trains four steps and saves at step 4; the other
    restores that checkpoint: its anomaly baselines, health accounting
    and goodput account are the writer's (the account one attempt on)."""
    ck = str(tmp_path / "ck")
    batches = _lm1b_batches()
    make_w, make_r = (_jax_lm1b, _port_lm1b) if writer == "jax" else \
        (_port_lm1b, _jax_lm1b)
    w = make_w(ck)
    try:
        for b in batches:
            float(w.run("loss", feed_dict=b))
    finally:
        w.close()
    from parallax_tpu_torch.ckpt.store import CheckpointStore
    extras_want = CheckpointStore(ck).restore_extras(4)
    assert extras_want["anomaly"]["step_time_ms"]["n"] == 4
    r = make_r(ck)
    try:
        assert r.prepare(batches[0]) == 4
        assert r.anomaly.snapshot().keys() == extras_want["anomaly"].keys()
        for sig, det in extras_want["anomaly"].items():
            got = r.anomaly.snapshot()[sig]
            assert got["n"] == det["n"] and got["window"] == \
                pytest.approx(det["window"], rel=1e-6)
        assert r.health.snapshot() == extras_want["health"]
        acct = r.ops_account()
        assert acct["attempts"] == extras_want["ops"]["attempts"] + 1 == 2
        assert acct["steps"] == extras_want["ops"]["steps"] == 4
        assert acct["badput_s"]["restore_replay"] > 0
    finally:
        r.close()


# -- the chaos guard ----------------------------------------------------------------


CHILD = textwrap.dedent('''
    import json, os, signal, sys, time
    import numpy as np
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import simple
    args = json.loads(sys.argv[1])

    def batch(i, nan=False):
        b = simple.make_batch(np.random.default_rng(1000 + i), 32)
        if nan:
            b["x"] = b["x"] * np.nan
        return b

    cfg = pt.Config(
        run_option="AR", flight_dir=args.get("flight_dir"),
        journal_path=args.get("journal"),
        ckpt_config=pt.CheckPointConfig(
            ckpt_dir=args.get("ckpt_dir"),
            save_ckpt_steps=4 if args.get("ckpt_dir") else None),
        recovery_config=pt.RecoveryConfig(
            enabled=bool(args.get("recovery")), snapshot_every_steps=2,
            max_retries=2))
    sess, *_ = pt.parallel_run(simple.build_model(0.1),
                               parallax_config=cfg, device="cpu")
    sess.prepare(batch(0))
    i = sess.data_cursor
    while i < 12:
        sess.run("loss", feed_dict=batch(i, nan=i == args.get("nan_at")))
        if args.get("crash_at") is not None and i + 1 >= args["crash_at"]:
            os.kill(os.getpid(), signal.SIGKILL)
        i += 1
    doc = {"account": sess.ops_account(), "alerts": sess.alerts.summary(),
           "t_end": time.time()}
    with open(args["out"], "w") as f:
        json.dump(doc, f, default=str)
    sess.close()
''')


def _child(tmp, **args):
    epoch = time.time()
    env = dict(os.environ, PARALLAX_RUN_EPOCH=f"{epoch:.6f}",
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(args)],
                          env=env, cwd=str(tmp), capture_output=True,
                          text=True, timeout=300)
    return proc, epoch


def _doc(path):
    with open(path) as f:
        return json.load(f)


def _sums(acct):
    total = acct["productive_s"] + sum(acct["badput_s"].values())
    return abs(total - acct["wall_s"]) < 1e-4


def test_goodput_chaos_guard(tmp_path):
    """Clean run: sums to the wall, within 5 % of the parent's wall
    (spawn epoch to the child's end stamp), zero alerts. SIGKILL after
    the second checkpoint and a resume: one account over both attempts,
    restore and eviction time attributed, within 5 % of the parent's
    wall from the first spawn. A NaN rollback: the discarded steps in
    ``rollback_discarded``, journaled after the rollback event."""
    # clean
    out1 = str(tmp_path / "clean.json")
    p1, e1 = _child(tmp_path, out=out1, journal=str(tmp_path / "j1.jsonl"))
    assert p1.returncode == 0, p1.stderr[-2000:]
    d1 = _doc(out1)
    a1 = d1["account"]
    assert _sums(a1)
    wall1 = d1["t_end"] - e1
    assert abs(a1["wall_s"] - wall1) / wall1 <= 0.05
    assert d1["alerts"]["firings_total"] == 0
    assert read_journal(str(tmp_path / "j1.jsonl"))
    # SIGKILL mid-run, then resume
    ck = str(tmp_path / "ck")
    out2 = str(tmp_path / "kill.json")
    p2a, e2 = _child(tmp_path, out=out2, ckpt_dir=ck, crash_at=9)
    assert p2a.returncode == -signal.SIGKILL
    p2b, _ = _child(tmp_path, out=out2, ckpt_dir=ck)
    assert p2b.returncode == 0, p2b.stderr[-2000:]
    d2 = _doc(out2)
    a2 = d2["account"]
    assert a2["attempts"] == 2 and _sums(a2)
    assert a2["badput_s"]["restore_replay"] > 0
    assert a2["badput_s"]["eviction_downtime"] > 0
    wall2 = d2["t_end"] - e2
    assert abs(a2["wall_s"] - wall2) / wall2 <= 0.05
    # NaN rollback
    out3 = str(tmp_path / "nan.json")
    j3 = str(tmp_path / "j3.jsonl")
    p3, _ = _child(tmp_path, out=out3, journal=j3, nan_at=6, recovery=True,
                   flight_dir=str(tmp_path / "fl"))
    assert p3.returncode == 0, p3.stderr[-2000:]
    a3 = _doc(out3)["account"]
    assert a3["badput_s"]["rollback_discarded"] > 0 and _sums(a3)
    kinds = [(e["subsystem"], e["kind"]) for e in read_journal(j3)]
    assert kinds.index(("recovery", "nonfinite_rollback")) < \
        kinds.index(("ops", "rollback_discarded"))
