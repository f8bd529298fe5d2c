"""The port's numerics observatory held to the JAX package's
(``tests/test_numerics.py`` but its JAX-only internals):

* ``tree_prefix_stats`` on one seeded param/grad tree through both
  packages, every stat within 1e-6 relative (the hand-computed cases
  too); ``step_numerics``' gate; the ``[layers, 6]`` stats tensor read
  lazily (``StatsTree``);
* ``NumericsMonitor`` on one seeded stream of samples through both
  packages: samples, skips, trail and gauges equal;
* ``provenance_report`` naming the same poisoned feed, param or grad as
  JAX's on the same inputs;
* the drift pairs: the port's references held to JAX's within 1e-5 (the
  LSTM weight gradient through the plain backward against JAX's scan;
  the paged decode's plain gather against JAX's einsum, at JAX's head
  dim 16 and at 64, the smallest the B7 kernel takes on the card); a
  perturbed pair flagged in both packages; on the CPU the kernels' plain
  versions run, so the port's clean pairs agree exactly;
* the session: the sampled gauges, trail and flight section; the
  structural killswitch (``numerics_interval=0``, ``obs.disable()`` or
  ``PARALLAX_OBS=0`` in a fresh process: no second graph, no
  ``numerics`` output, no monitor); the reserved
  output name; the on-demand drift sweep; ``engine.recompiles`` 0 with
  numerics on.

The card's route through the kernels (fp32 B2/B3 and B7 launched by the
sentinels) is held by chip_smoke's ``obs-train`` phase.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as tparallax
from parallax_tpu.obs import numwatch as jnum
from parallax_tpu.obs.metrics import MetricsRegistry as JRegistry
from parallax_tpu.ops import pallas_paged_attention as jppa
from parallax_tpu_torch import obs
from parallax_tpu_torch.core import optim
from parallax_tpu_torch.models import lm1b as tlm1b
from parallax_tpu_torch.models import simple
from parallax_tpu_torch.obs import numwatch
from parallax_tpu_torch.obs.export import render_prometheus
from parallax_tpu_torch.obs.health import HealthMonitor
from parallax_tpu_torch.obs.metrics import MetricsRegistry
from parallax_tpu_torch.obs.numwatch import (SAMPLED_KEY, STAT_NAMES,
                                             DriftSentinel, NumericsMonitor,
                                             provenance_report,
                                             step_numerics, stat_prefixes,
                                             tree_prefix_stats)

REL = 1e-6          # tree stats against JAX
REF_TOL = 1e-5      # drift pair references against JAX


def _trees(seed=0):
    """One seeded param/grad tree: two layers (nested dict and list), an
    integer leaf, tiny and large gradient entries, a NaN and an Inf."""
    rng = np.random.default_rng(seed)
    pb = {"enc": {"w": rng.standard_normal((6, 5)).astype(np.float32),
                  "b": rng.standard_normal(5).astype(np.float32)},
          "dec": [rng.standard_normal((4, 3)).astype(np.float32)],
          "steps": np.int32(3)}
    g = {"enc": {"w": (rng.standard_normal((6, 5)) * 1e-3).astype(
        np.float32), "b": rng.standard_normal(5).astype(np.float32)},
         "dec": [rng.standard_normal((4, 3)).astype(np.float32)],
         "steps": np.int32(0)}
    g["dec"][0][1, 1] = np.nan
    g["dec"][0][2, 0] = np.inf
    g["enc"]["w"][0, :2] = 0.0
    pa = {"enc": {"w": pb["enc"]["w"] - 0.1 * g["enc"]["w"],
                  "b": pb["enc"]["b"] * 0.5},
          "dec": [pb["dec"][0] + 0.01], "steps": np.int32(3)}
    return pb, pa, g


def _fixture_trees():
    pb = {"w": np.array([3.0, 4.0], np.float32)}
    grads = {"w": np.array([0.001, -2.0], np.float32)}
    pa = {"w": pb["w"] - 0.1 * grads["w"]}
    return pb, pa, grads


def _close(a, b):
    if math.isnan(b):
        return math.isnan(a)
    return a == pytest.approx(b, rel=REL, abs=1e-12)


class TestTreeStats:
    def test_seeded_tree_equals_jax(self):
        pb, pa, g = _trees()
        got = tree_prefix_stats(pb, pa, g)
        want = jnum.tree_prefix_stats(pb, pa, g)
        assert sorted(got) == sorted(want) == ["dec", "enc"]
        for layer in want:
            for s in STAT_NAMES:
                assert _close(float(got[layer][s]),
                              float(want[layer][s])), (layer, s)
        assert stat_prefixes(pb) == jnum.stat_prefixes(pb)

    def test_hand_computed_values(self):
        pb, pa, grads = _fixture_trees()
        s = {k: float(v) for k, v in tree_prefix_stats(pb, pa,
                                                       grads)["w"].items()}
        assert s["grad_norm"] == pytest.approx(math.sqrt(0.001 ** 2 + 4.0),
                                               rel=1e-6)
        assert s["grad_absmax"] == 2.0
        assert s["nonfinite"] == 0.0
        assert s["underflow_frac"] == 0.5
        assert s["param_norm"] == pytest.approx(5.0, rel=1e-6)
        assert s["update_ratio"] == pytest.approx(
            0.1 * math.sqrt(0.001 ** 2 + 4.0) / 5.0, rel=1e-5)

    def test_nonfinite_counted_and_excluded_from_underflow(self):
        pb = {"w": np.ones(3, np.float32)}
        grads = {"w": np.array([np.nan, np.inf, 0.5], np.float32)}
        s = {k: float(v)
             for k, v in tree_prefix_stats(pb, pb, grads)["w"].items()}
        assert s["nonfinite"] == 2.0
        assert s["underflow_frac"] == 0.0
        assert s["update_ratio"] == 0.0

    def test_torch_leaves_on_the_stats_matrix(self):
        pb, pa, g = _trees(1)
        as_t = lambda t: {k: as_t(v) for k, v in t.items()} \
            if isinstance(t, dict) else ([as_t(v) for v in t]
                                         if isinstance(t, list)
                                         else torch.as_tensor(t))
        got = tree_prefix_stats(as_t(pb), as_t(pa), as_t(g))
        want = jnum.tree_prefix_stats(pb, pa, g)
        for layer in want:
            for s in STAT_NAMES:
                assert _close(float(got[layer][s]), float(want[layer][s]))


class TestStepNumerics:
    def test_sampling_gate_and_flag(self):
        pb, pa, grads = _fixture_trees()
        on = step_numerics(pb, pa, grads, step=4, interval=2)
        off = step_numerics(pb, pa, grads, step=5, interval=2)
        assert float(on[SAMPLED_KEY]) == 1.0
        assert float(on["w"]["grad_absmax"]) == 2.0
        assert float(off[SAMPLED_KEY]) == 0.0
        assert float(off["w"]["grad_absmax"]) == 0.0
        assert set(on) == set(off)
        assert set(on["w"]) == set(off["w"]) == set(STAT_NAMES)

    def test_force_overrides_off_step(self):
        pb, pa, grads = _fixture_trees()
        out = step_numerics(pb, pa, grads, step=5, interval=2,
                            force=torch.tensor(True))
        assert float(out[SAMPLED_KEY]) == 1.0
        assert float(out["w"]["underflow_frac"]) == 0.5

    def test_interval_validated(self):
        pb, pa, grads = _fixture_trees()
        with pytest.raises(ValueError, match="interval"):
            step_numerics(pb, pa, grads, step=0, interval=0)

    def test_stats_tree_reads_like_the_jax_tree(self):
        pb, pa, g = _trees(2)
        t = tree_prefix_stats(pb, pa, g)
        names = sorted(t)
        mat = torch.stack([torch.stack([t[p][s] for s in STAT_NAMES])
                           for p in names])
        tree = numwatch.StatsTree(names, mat)
        assert tree.is_ready()
        assert tree[SAMPLED_KEY] == 1.0
        assert sorted(tree) == sorted(names + [SAMPLED_KEY])
        assert tree.get("enc")["grad_norm"] == pytest.approx(
            float(t["enc"]["grad_norm"]))


class TestNumericsMonitor:
    @staticmethod
    def _stats(sampled, absmax=2.0, ratio=0.0):
        t = {SAMPLED_KEY: np.float32(sampled)}
        t["w"] = {s: np.float32(0.0) for s in STAT_NAMES}
        t["w"]["grad_absmax"] = np.float32(absmax)
        t["w"]["update_ratio"] = np.float32(ratio)
        return t

    def test_seeded_stream_equals_jax(self):
        rng = np.random.default_rng(4)
        stream = [(i, self._stats(float(i % 3 == 0),
                                  float(rng.uniform(0, 3)),
                                  float(rng.uniform(0, 1e-2))))
                  for i in range(30)]
        got = NumericsMonitor(MetricsRegistry(), 3, trail_capacity=5)
        want = jnum.NumericsMonitor(JRegistry(), 3, trail_capacity=5)
        for i, st in stream:
            got.observe(i, st)
            want.observe(i, st)
        assert got.report() == want.report()
        assert got.trail() == want.trail()
        g, w = got.registry.snapshot(), want.registry.snapshot()
        assert {k: g[k] for k in g if k.startswith("numerics.")} == \
            {k: w[k] for k in w if k.startswith("numerics.")}

    def test_consume_skip_and_gauges(self):
        reg = MetricsRegistry()
        mon = NumericsMonitor(reg, interval=2)
        mon.observe(0, self._stats(1.0, absmax=2.0))
        mon.observe(1, self._stats(0.0))
        mon.observe(2, self._stats(1.0, absmax=3.0))
        mon.poll(block=True)
        assert mon.total_samples == 2 and mon.total_skipped == 1
        assert reg.gauge("numerics.w.grad_absmax").value == 3.0
        assert [r["step"] for r in mon.trail()] == [0, 2]

    def test_trail_bounded(self):
        mon = NumericsMonitor(MetricsRegistry(), 1, trail_capacity=4)
        for i in range(10):
            mon.observe(i, self._stats(1.0))
        mon.poll(block=True)
        assert [r["step"] for r in mon.trail()] == [6, 7, 8, 9]

    def test_pending_until_the_copy_is_ready(self):
        class Pending(dict):
            ready = False

            def is_ready(self):
                return self.ready

        mon = NumericsMonitor(MetricsRegistry(), 1)
        st = Pending(self._stats(1.0))
        mon.observe(0, st)
        assert mon.total_samples == 0
        st.ready = True
        mon.poll()
        assert mon.total_samples == 1

    def test_killswitch_collects_nothing(self):
        mon = NumericsMonitor(MetricsRegistry(), 1)
        obs.disable()
        try:
            mon.observe(0, self._stats(1.0))
            mon.poll(block=True)
        finally:
            obs.enable()
        assert mon.total_samples == 0 and mon.total_skipped == 0

    def test_anomaly_feed_bounded_class_counters(self):
        reg = MetricsRegistry()
        mon = NumericsMonitor(reg, 1, anomaly=obs.AnomalyMonitor(reg))
        for i in range(20):
            mon.observe(i, self._stats(1.0, ratio=0.01))
        mon.observe(20, self._stats(1.0, ratio=50.0))
        mon.poll(block=True)
        assert reg.counter("anomaly.events.spike").value >= 1
        assert reg.counter("anomaly.events.total").value >= 1


class TestProvenance:
    CASES = {
        "param": dict(params={"w": [np.nan, 1.0], "b": [1.0]},
                      loss=np.nan),
        "feed": dict(feeds={"x": [np.inf, 0.0], "y": [0.0]},
                     params={"w": [np.nan]}, loss=np.nan),
        "grad": dict(trip=(1.0, 4.0), loss=1.0),
        "unsampled": dict(trip=(0.0, 0.0), loss=np.nan),
        "clean": dict(feeds={"x": [1.0]}, params={"w": [2.0]}, loss=0.5),
    }

    @staticmethod
    def _inputs(case, as_torch):
        arr = (lambda v: torch.tensor(v, dtype=torch.float32)) \
            if as_torch else (lambda v: np.asarray(v, np.float32))
        kw = {}
        for k in ("feeds", "params"):
            if k in case:
                kw[k] = {n: arr(v) for n, v in case[k].items()}
        if "trip" in case:
            flag, bad = case["trip"]
            t = {SAMPLED_KEY: np.float32(flag),
                 "w": {s: np.float32(0.0) for s in STAT_NAMES}}
            t["w"]["nonfinite"] = np.float32(bad)
            kw["trip_stats"] = t
        kw["loss"] = arr(case["loss"])
        return kw

    @pytest.mark.parametrize("name", sorted(CASES))
    def test_names_the_same_stage_as_jax(self, name):
        case = self.CASES[name]
        got = provenance_report(**self._inputs(case, True), step=7,
                                kind="loss")
        want = jnum.provenance_report(**self._inputs(case, False), step=7,
                                      kind="loss")
        assert got == want
        assert got["culprit"] == {"param": "param/w", "feed": "feed/x",
                                  "grad": "grad/w", "unsampled": "loss",
                                  "clean": None}[name]


# -- drift sentinels --------------------------------------------------------------


class TestDriftSentinels:
    def test_custom_pair_clean_and_drifted(self):
        reg = MetricsRegistry()
        ref = np.linspace(0.0, 1.0, 16, dtype=np.float32)
        r = DriftSentinel("toy", lambda: (ref, ref), registry=reg,
                          rel_err_tol=1e-3).check()
        assert not r["flagged"] and r["rel_err"] == 0.0
        assert reg.gauge("numerics.drift.toy.rel_err").value == 0.0
        assert DriftSentinel("toy2", lambda: (ref * 1.1, ref),
                             registry=reg, rel_err_tol=1e-3).check()[
            "flagged"]
        assert reg.counter("numerics.drift.toy2.alerts").value == 1

    def test_check_results_equal_jax(self):
        rng = np.random.default_rng(8)
        ref = rng.standard_normal((5, 7)).astype(np.float32)
        cand = ref + rng.standard_normal((5, 7)).astype(np.float32) * 1e-3
        cand[2] = ref[2] * 3
        kw = dict(rel_err_tol=1e-2, argmax_axis=-1, argmax_margin=1e-3)
        drop = ("check_ms",)
        got = {k: v for k, v in DriftSentinel(
            "x", lambda: (cand, ref), **kw).check().items()
            if k not in drop}
        want = {k: v for k, v in jnum.DriftSentinel(
            "x", lambda: (cand, ref), **kw).check().items()
            if k not in drop}
        assert got == want

    def test_argmax_flips_respect_tie_margin(self):
        ref = np.array([[0.0, 1.0, 0.5], [0.0, 0.50001, 0.5]], np.float32)
        cand = ref.copy()
        cand[1, 2] = 0.51
        assert DriftSentinel("tie", lambda: (cand, ref), rel_err_tol=1e9,
                             argmax_axis=-1, argmax_margin=1e-3).check()[
            "argmax_flip_frac"] == 0.0
        cand2 = ref.copy()
        cand2[0, 2] = 2.0
        assert DriftSentinel("flip", lambda: (cand2, ref), rel_err_tol=1e9,
                             argmax_axis=-1, argmax_margin=1e-3).check()[
            "argmax_flip_frac"] == pytest.approx(0.5)

    def test_lstm_pair_reference_equals_jax(self):
        jc, jr = jnum.lstm_drift_pair()()
        tc, tr = numwatch.lstm_drift_pair(device="cpu")()
        scale = np.abs(jr).max()
        assert np.abs(tr - jr).max() / scale < REF_TOL
        # the CPU runs B3's plain version as the candidate
        np.testing.assert_array_equal(tc, tr)
        assert np.abs(jc - jr).max() / scale < REF_TOL

    def test_paged_pair_reference_equals_jax_at_jax_shape(self):
        jc, jr = jnum.paged_attn_drift_pair()()
        tc, tr = numwatch.paged_attn_drift_pair(device="cpu")()
        assert tr.shape == jr.shape == (3, 3, 32)
        assert np.abs(tr - jr).max() / np.abs(jr).max() < REF_TOL
        np.testing.assert_array_equal(tc, tr)

    def test_paged_pair_at_the_cards_head_dim_equals_jax_einsum(self):
        q, k, v, pages, pos, live = numwatch.paged_drift_inputs(0, 64)
        c = numwatch.PAGED_PAIR
        want = np.asarray(jppa.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(pages), jnp.asarray(pos), num_heads=c["H"],
            page_size=c["page_size"], impl="einsum"))[:live]
        _, got = numwatch.paged_attn_drift_pair(device="cpu",
                                                head_dim=64)()
        assert got.shape == (3, 3, 128)
        assert np.abs(got - want).max() / np.abs(want).max() < REF_TOL
        assert numwatch.PAGED_PAIR_HEAD_DIM["cuda"] == 64

    def test_builtin_pairs_clean_silent_perturbed_flagged(self):
        reg = MetricsRegistry()
        for s in numwatch.default_sentinels(reg, device="cpu"):
            r = s.check()
            assert not r["flagged"], s.name
            assert r["rel_err"] == 0.0
        for s in numwatch.default_sentinels(perturb=0.05, device="cpu"):
            assert s.check()["flagged"], s.name
        assert reg.gauge("numerics.drift.lstm_bwd.accuracy").value == 1.0

    def test_perturbed_pairs_flagged_like_jax(self):
        """The same injected drift on the same inputs: JAX's sentinels
        and the port's give the same verdicts and tolerances."""
        got = [s.check() for s in numwatch.default_sentinels(
            perturb=0.05, device="cpu")]
        want = [s.check() for s in jnum.default_sentinels(perturb=0.05)]
        assert [(r["name"], r["flagged"], r["rel_err_tol"]) for r in got] \
            == [(r["name"], r["flagged"], r["rel_err_tol"]) for r in want]
        for g, w in zip(got, want):
            assert g["rel_err"] == pytest.approx(w["rel_err"], rel=1e-3)


class TestInstabilityScore:
    def test_events_raise_decay_lowers(self):
        reg = MetricsRegistry()
        hm = HealthMonitor(reg)
        assert hm.instability == 0.0
        hm.record_instability_event(0.5)
        one = hm.instability
        assert 0.0 < one < 1.0
        hm.record_instability_event(0.5)
        assert one < hm.instability < 1.0
        assert reg.snapshot()["health.instability"] == pytest.approx(
            hm.instability, abs=1e-6)

    def test_scrape_surface_carries_numerics_telemetry(self):
        reg = MetricsRegistry()
        hm = HealthMonitor(reg)
        hm.record_instability_event(1.0)
        reg.counter("anomaly.events.spike").inc(3)
        reg.counter("anomaly.events.total").inc(3)
        text = render_prometheus({"replica0": reg.snapshot()})
        assert "parallax_anomaly_events_total" in text
        assert "parallax_anomaly_events_spike" in text
        assert "parallax_health_instability" in text


# -- session end to end -------------------------------------------------------------


def _session(**cfg_kw):
    sess, *_ = tparallax.parallel_run(
        simple.build_model(learning_rate=0.1),
        parallax_config=tparallax.Config(run_option="AR", **cfg_kw),
        device="cpu")
    return sess


def _batch(i, nan=False):
    b = simple.make_batch(np.random.default_rng(100 + i), 32)
    if nan:
        b["x"] = b["x"] * np.nan
    return b


class TestSessionNumerics:
    def test_sampled_gauges_trail_and_flight_section(self, tmp_path):
        sess = _session(numerics_interval=2)
        try:
            for i in range(6):
                sess.run("loss", feed_dict=_batch(i))
            sess.numerics.poll(block=True)
            assert sess.numerics.total_samples == 3
            assert sess.numerics.total_skipped == 3
            snap = sess.metrics_snapshot()
            for stat in STAT_NAMES:
                assert f"numerics.w.{stat}" in snap
                assert f"numerics.b.{stat}" in snap
            doc = json.load(open(sess.dump_flight(str(tmp_path / "f.json"))))
            assert doc["numerics"]["samples"] == 3
            assert len(doc["numerics"]["trail"]) == 3
            assert sess.metrics_snapshot()["engine.recompiles"] == 0
        finally:
            sess.close()

    def test_session_stats_equal_the_tree_function(self):
        """A sampled step's in-step stats equal ``tree_prefix_stats`` of
        the step's own before/after parameters and gradients."""
        cfg = tlm1b.tiny_config(sparse_grad_mode="slices",
                                lstm_impl="kernel",
                                compute_dtype=torch.float32)
        sess, *_ = tparallax.parallel_run(
            tlm1b.build_model(cfg), parallax_config=tparallax.Config(
                run_option="HYBRID", sparse_grad_mode="slices",
                numerics_interval=1), device="cpu")
        try:
            b = tlm1b.make_batch(np.random.default_rng(3), 8, 5,
                                 cfg.vocab_size)
            sess.prepare(b)
            before = {p: t.detach().clone() for p, t in
                      numwatch.flatten(sess.state.params)}
            out = sess.run(None, feed_dict=b)
            tree = out["numerics"].result()
            after = dict(numwatch.flatten(sess.state.params))
            grads = {p: sess.engine._last_grads.get(
                p, torch.zeros_like(after[p])) for p in after}
            want = tree_prefix_stats(before, after, grads)
            assert sorted(k for k in tree if k != SAMPLED_KEY) == \
                sorted(want) == ["emb", "lstm", "softmax_b", "softmax_w"]
            for layer in want:
                for s in STAT_NAMES:
                    assert tree[layer][s] == pytest.approx(
                        float(want[layer][s]), rel=1e-5, abs=1e-9), \
                        (layer, s)
            assert tree["emb"]["update_ratio"] > 0      # sliced rows moved
            assert tree["emb"]["grad_norm"] == 0.0      # no dense grad
        finally:
            sess.close()

    def test_nonfinite_rollback_artifact_names_poisoned_feed(self, tmp_path):
        fdir = str(tmp_path / "fl")
        sess = _session(
            numerics_interval=2, flight_dir=fdir,
            recovery_config=tparallax.RecoveryConfig(
                enabled=True, snapshot_every_steps=2, max_retries=2))
        try:
            for i in range(8):
                sess.run("loss", feed_dict=_batch(i, nan=(i == 5)))
            import os
            arts = [p for p in os.listdir(fdir)
                    if p.startswith("flight_nonfinite_rollback_")]
            assert arts
            doc = json.load(open(os.path.join(fdir, arts[0])))
            prov = doc["detail"]["provenance"]
            assert prov["culprit"] == "feed/x"
            assert prov["trip_stats_sampled"] is True
            assert len(doc["detail"]["stats_trail"]) >= 1
            assert doc["detail"]["trip_stats_basis"]["snapshot_step"] == 4
            assert sess.health.instability > 0.0
        finally:
            sess.close()

    @pytest.mark.parametrize("how", ["interval0", "killswitch"])
    def test_structural_killswitch(self, how):
        """No second graph, no ``numerics`` output, no monitor, nothing
        kept for the trip: zero cost, not cheap cost."""
        if how == "killswitch":
            obs.disable()
        try:
            sess = _session(numerics_interval=0 if how == "interval0"
                            else 1)
            try:
                assert sess.numerics is None
                out = sess.run(None, feed_dict=_batch(0))
                assert "numerics" not in out
                eng = sess.engine
                assert eng._numerics is False
                assert eng._num_executables == {}
                assert eng.captured_graphs(numerics=True) == []
                assert eng._step_grads is None
                assert "numerics_graphs" not in sess.compile_stats()
            finally:
                sess.close()
        finally:
            obs.enable()

    def test_env_killswitch_is_structural(self):
        """``PARALLAX_OBS=0`` at import: the same absence, in a fresh
        process (the flag is read when ``obs._state`` is imported)."""
        import os
        import subprocess
        import sys
        from pathlib import Path
        code = (
            "import numpy as np\n"
            "import parallax_tpu_torch as pt\n"
            "from parallax_tpu_torch.models import simple\n"
            "sess, *_ = pt.parallel_run(simple.build_model(0.1),\n"
            "    parallax_config=pt.Config(run_option='AR',\n"
            "    numerics_interval=1), device='cpu')\n"
            "out = sess.run(None, feed_dict=simple.make_batch(\n"
            "    np.random.default_rng(0), 8))\n"
            "assert sess.numerics is None and 'numerics' not in out\n"
            "assert not sess.engine._numerics and sess.journal is None\n"
            "assert sess.engine.captured_graphs(numerics=True) == []\n"
            "sess.close()\n")
        root = Path(__file__).resolve().parent.parent
        env = dict(os.environ, PARALLAX_OBS="0", PYTHONPATH=str(root))
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]

    def test_numerics_on_keeps_recompiles_zero(self):
        sess = _session(numerics_interval=3)
        try:
            for i in range(7):
                sess.run("loss", feed_dict=_batch(i))
            assert sess.metrics_snapshot()["engine.recompiles"] == 0
            stats = sess.compile_stats()
            assert stats["numerics_graphs"]["captures"] == 0   # the CPU
        finally:
            sess.close()

    def test_reserved_output_name_rejected(self):
        def init_fn(gen, device):
            return {"w": torch.randn((1,), generator=gen, device=device)}

        def loss_fn(params, batch):
            loss = ((params["w"] * batch["x"] - batch["y"]) ** 2).mean()
            return loss, {"numerics": loss}

        model = tparallax.Model(init_fn, loss_fn, optimizer=optim.sgd(0.1))
        sess, *_ = tparallax.parallel_run(
            model, parallax_config=tparallax.Config(
                run_option="AR", numerics_interval=2), device="cpu")
        try:
            with pytest.raises(ValueError, match="numerics"):
                sess.run("loss", feed_dict=_batch(0))
        finally:
            sess.close()

    def test_drift_sweep_on_demand_and_on_cadence(self):
        sess = _session(numerics_interval=2, numerics_drift_interval=2)
        try:
            results = sess.run_drift_sentinels()
            assert {r["name"] for r in results} == {"lstm_bwd",
                                                    "paged_attn"}
            assert not any(r["flagged"] for r in results)
            snap = sess.metrics_snapshot()
            assert snap["numerics.drift.lstm_bwd.accuracy"] >= 0.999
            assert snap["numerics.drift.paged_attn.accuracy"] >= 0.99
            for i in range(5):
                sess.run("loss", feed_dict=_batch(i))
            # steps 2 and 4 swept, plus the explicit call
            assert sess.metrics_snapshot()[
                "numerics.drift.lstm_bwd.checks"] == 3
        finally:
            sess.close()

    def test_drift_sweep_off_without_numerics(self):
        sess = _session()
        try:
            assert sess.run_drift_sentinels() is None
        finally:
            sess.close()


class TestConfigValidation:
    @pytest.mark.parametrize("kw", [dict(numerics_interval=-1),
                                    dict(numerics_drift_interval=-2)])
    def test_negative_intervals_rejected_like_jax(self, kw):
        with pytest.raises(ValueError):
            jparallax.Config(**kw)
        with pytest.raises(ValueError):
            tparallax.Config(**kw)

    def test_numerics_auto_enables_health(self):
        assert tparallax.Config(numerics_interval=4).monitor_health is True
        assert jparallax.Config(numerics_interval=4).monitor_health is True
