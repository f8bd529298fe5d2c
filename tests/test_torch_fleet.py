"""The port's serving fleet against the JAX package's
(``tests/test_fleet.py``): replicated sessions, the health-aware router,
the chaos harness, live weight hot-swap and the autoscaler.

* the error taxonomy and the request done-callbacks, class by class
  against JAX's;
* the router's state machine driven with explicit clocks: every
  scenario runs through both packages' ``Router`` and each step's
  (state, probation, ejections, reopen time) sequence must be equal;
* the fault injector, through both packages' classes;
* a one-shot fleet of tiny linear replicas (failover on crash and NaN,
  saturation spill, hot swap with nothing captured again, scale-up onto
  pushed weights, deadlines across failover), outputs equal to JAX's
  ``infer_fn``; ``ParallaxSession.push_weights`` into it;
* the autoscaler over fake replicas;
* paged decode failover: a crash on a replica mid-traffic, each request
  retried on the survivor, tokens equal to JAX's ``greedy_decode`` on
  the same parameters, one ``serve.request`` span a request;
* a program serves one live session: a second session on it is refused
  until the first closes (a fleet builds one program per replica).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu.serve as jserve
import parallax_tpu.serve.router as jrouter
from parallax_tpu.models import nmt as jnmt
import parallax_tpu_torch as tpx
import parallax_tpu_torch.serve as tserve
import parallax_tpu_torch.serve.router as trouter
from parallax_tpu_torch.core import optim
from parallax_tpu_torch.models import nmt as tnmt
from parallax_tpu_torch.obs import trace
from parallax_tpu_torch.serve import (DeadlineExceeded, FaultInjector,
                                      FleetConfig, HealthPolicy,
                                      ReplicaCrash, ReplicaUnavailable,
                                      Request, ServeClosed,
                                      ServeError, ServeFleet,
                                      ServeOverloaded, ServeSession)
from parallax_tpu_torch.serve.router import DEGRADED, EJECTED, HEALTHY
from parallax_tpu_torch.weights import params_from_jax

PACKAGES = {"port": (tserve, trouter), "jax": (jserve, jrouter)}


# -- error taxonomy (declared, not pattern-matched) -------------------------


ERRORS = ("ServeError", "ServeOverloaded", "TenantQuotaExceeded",
          "DeadlineExceeded", "ServeClosed", "ReplicaUnavailable",
          "PagePoolExhausted", "InjectedFault", "ReplicaCrash")


@pytest.mark.parametrize("name", ERRORS)
def test_error_taxonomy_matches_jax(name):
    t, j = getattr(tserve, name), getattr(jserve, name)
    assert bool(getattr(t, "retryable", False)) \
        == bool(getattr(j, "retryable", False))
    assert bool(getattr(t, "fatal", False)) \
        == bool(getattr(j, "fatal", False))
    assert [c.__name__ for c in t.__mro__] == \
        [c.__name__ for c in j.__mro__]


def test_retryable_and_fatal_flags():
    assert ServeOverloaded.retryable and ReplicaUnavailable.retryable
    assert tserve.PagePoolExhausted.retryable and ReplicaCrash.retryable
    assert not (DeadlineExceeded.retryable or ServeClosed.retryable
                or ServeError.retryable)
    assert ReplicaCrash.fatal
    for exc in (ServeOverloaded, DeadlineExceeded, ServeClosed,
                ReplicaUnavailable, tserve.PagePoolExhausted):
        assert getattr(exc, "fatal", False) is False, exc


# -- request done-callbacks -------------------------------------------------


def test_callback_fires_on_completion_and_failure():
    seen = []
    r = Request({"x": 1})
    r.add_done_callback(lambda req: seen.append(("done", req.id)))
    r._complete(42)
    assert seen == [("done", r.id)]
    r2 = Request({"x": 2})
    r2.add_done_callback(lambda req: seen.append("failed"))
    r2._fail(ServeError("boom"))
    assert seen[-1] == "failed"


def test_callback_on_already_done_request_fires_immediately():
    r = Request({"x": 1})
    r._complete("y")
    seen = []
    r.add_done_callback(lambda req: seen.append(req._result))
    assert seen == ["y"]


def test_broken_callback_does_not_break_delivery():
    r = Request({"x": 1})
    r.add_done_callback(lambda req: 1 / 0)
    r._complete("ok")
    assert r.result(timeout=1.0) == "ok"


# -- the router state machine (explicit clocks, both packages) ---------------


class _FakeSession:
    """A duck-typed replica for router and autoscaler units: load,
    heartbeat and alive set directly by the test."""

    def __init__(self, load=0.0):
        self._load = float(load)
        self.alive = True
        self.heartbeat = 0.0
        self.closed = False

    def load(self):
        return self._load

    def idle(self):
        return self._load == 0.0

    def close(self, drain=True):
        self.closed = True


def _policy(mod, **kw):
    base = dict(window=4, min_outcomes=2, degrade_error_rate=0.25,
                eject_error_rate=0.5, recovery_idle_s=100.0,
                heartbeat_timeout_s=1.0, backoff_initial_s=1.0,
                backoff_max_s=8.0, probation_successes=2)
    base.update(kw)
    return mod.HealthPolicy(**base)


class _Rig:
    """One package's router under a scenario, recording every
    replica's (state, probation owed, ejections, reopen time) after each
    step."""

    def __init__(self, pkg, **policy_kw):
        self.serve, self.router_mod = PACKAGES[pkg]
        self.events = []
        self.r = self.serve.Router(
            _policy(self.serve, **policy_kw),
            on_state_change=lambda h, o, n, why:
            self.events.append((h.rid, o, n)))
        self.trail = []

    def add(self, rid, load=0.0):
        return self.r.add(rid, _FakeSession(load))

    def err(self):
        return self.serve.ServeError("x")

    def snap(self):
        self.trail.append(tuple(
            (h.rid, h.state, h.probation_left, h.ejections,
             None if h.reopen_at is None else round(h.reopen_at, 9))
            for h in self.r.handles()))


def _s_least_loaded(rig):
    from_a = rig.add("a", 5.0)
    b = rig.add("b", 1.0)
    h = rig.r.place()
    assert h is b
    rig.r.done_placing(h)
    b.session._load = 0.0
    from_a.session._load = 0.0
    h1, h2 = rig.r.place(), rig.r.place()
    assert {h1.rid, h2.rid} == {"a", "b"}
    rig.r.done_placing(h1)
    rig.r.done_placing(h2)
    rig.snap()


def _s_draining_excluded(rig):
    rig.add("a")
    rig.add("b")
    rig.r.set_draining("a", True)
    rig.snap()
    for _ in range(4):
        h = rig.r.place()
        assert h.rid == "b"
        rig.r.done_placing(h)
    with pytest.raises(Exception, match="no serving replica"):
        rig.r.place(exclude=("b",))
    rig.r.set_draining("a", False)
    rig.snap()
    assert rig.r.get("a").state == "healthy"


def _s_drain_restore_keeps_probation(rig):
    h = rig.add("a")
    rig.r.record_error(h, rig.err(), now=0.0)
    rig.r.record_error(h, rig.err(), now=0.0)
    h.session.heartbeat = 1.1
    rig.r.tick(now=1.1)
    assert h.state == "degraded" and h.probation_left == 2
    rig.r.set_draining("a", True, now=1.2)
    rig.snap()
    rig.r.set_draining("a", False, now=1.3)
    rig.snap()
    assert h.state == "degraded" and h.probation_left == 2
    rig.r.record_success(h, now=1.4)
    rig.r.record_success(h, now=1.5)
    rig.snap()
    assert h.state == "healthy" and h.ejections == 0


def _s_degraded_only_when_healthy_unavailable(rig):
    a = rig.add("a", 100.0)
    b = rig.add("b", 0.0)
    rig.r.record_error(b, rig.err(), now=0.0)
    rig.r.record_error(b, rig.err(), now=0.0)
    rig.snap()
    assert b.state == "ejected"
    h = rig.r.place()
    assert h is a
    rig.r.done_placing(h)


def _s_error_rate_degrades_then_ejects(rig):
    h = rig.add("a")
    for _ in range(6):
        rig.r.record_success(h, now=0.0)
    rig.r.record_error(h, rig.err(), now=0.0)
    rig.r.record_error(h, rig.err(), now=0.0)
    rig.snap()
    assert h.state == "degraded"
    for _ in range(3):
        rig.r.record_error(h, rig.err(), now=0.0)
        rig.snap()
    assert h.state == "ejected"
    assert h.reopen_at == pytest.approx(1.0)


def _s_circuit_reopens_into_probation(rig):
    h = rig.add("a")
    rig.r.record_error(h, rig.err(), now=0.0)
    rig.r.record_error(h, rig.err(), now=0.0)
    rig.snap()
    h.session.heartbeat = 0.5
    rig.r.tick(now=0.5)
    rig.snap()
    assert h.state == "ejected"
    h.session.heartbeat = 1.1
    rig.r.tick(now=1.1)
    rig.snap()
    assert h.state == "degraded" and h.probation_left == 2
    rig.r.record_success(h, now=1.2)
    rig.snap()
    rig.r.record_success(h, now=1.3)
    rig.snap()
    assert h.state == "healthy" and h.ejections == 0


def _s_probation_error_doubles_backoff(rig):
    h = rig.add("a")
    rig.r.record_error(h, rig.err(), now=0.0)
    rig.r.record_error(h, rig.err(), now=0.0)
    h.session.heartbeat = 1.1
    rig.r.tick(now=1.1)
    rig.r.record_error(h, rig.err(), now=1.2)
    rig.snap()
    assert h.state == "ejected" and h.ejections == 2
    assert h.reopen_at == pytest.approx(3.2)
    for _ in range(3, 9):
        # the clock at the circuit's reopen (tick clears reopen_at)
        t = h.reopen_at
        h.session.heartbeat = t
        rig.r.tick(now=t)
        rig.r.record_error(h, rig.err(), now=t)
        rig.snap()
    assert h.reopen_at - h.last_error_at <= 8.0 + 1e-9


def _s_stale_heartbeat(rig):
    h = rig.add("a")
    h.session.heartbeat = 0.0
    rig.r.tick(now=1.5)
    rig.snap()
    assert h.state == "degraded"
    rig.r.tick(now=3.5)
    rig.snap()
    assert h.state == "ejected"
    reopen = h.reopen_at
    h.session.heartbeat = reopen
    rig.r.tick(now=reopen)
    rig.r.record_success(h, now=reopen)
    rig.r.record_success(h, now=reopen)
    rig.snap()
    assert h.state == "healthy"


def _s_heartbeat_recovery(rig):
    h = rig.add("a")
    h.session.heartbeat = 0.0
    rig.r.tick(now=1.5)
    rig.snap()
    h.session.heartbeat = 2.0
    rig.r.tick(now=2.1)
    rig.snap()
    assert h.state == "healthy"


def _s_latency_straggler(rig):
    a, b = rig.add("a"), rig.add("b")
    for _ in range(4):
        rig.r.record_success(a, latency_ms=10.0, now=0.0)
        rig.r.record_success(b, latency_ms=100.0, now=0.0)
    a.session.heartbeat = b.session.heartbeat = 0.1
    rig.r.tick(now=0.1)
    rig.snap()
    assert a.state == "healthy" and b.state == "degraded"
    assert "latency" in b.state_reason


def _s_probation_probes(rig):
    a, b = rig.add("a"), rig.add("b")
    rig.r.record_error(b, rig.err(), now=0.0)
    rig.r.record_error(b, rig.err(), now=0.0)
    b.session.heartbeat = 1.1
    rig.r.tick(now=1.1)
    placed = []
    for _ in range(12):
        h = rig.r.place()
        placed.append(h.rid)
        rig.r.record_success(h, now=1.2)
        rig.r.done_placing(h)
        rig.snap()
    rig.trail.append(tuple(placed))
    assert placed.count("b") >= 2, placed
    assert b.state == "healthy"


def _s_dead_session(rig):
    h = rig.add("a")
    h.session.alive = False
    rig.r.tick(now=0.0)
    rig.snap()
    assert h.state == "ejected" and h.dead and h.reopen_at is None
    rig.r.tick(now=1e9)
    rig.snap()
    assert h.state == "ejected"


def _s_callback(rig):
    h = rig.add("a")
    rig.r.record_error(h, rig.err(), now=0.0)
    rig.r.record_error(h, rig.err(), now=0.0)
    assert rig.events == [("a", "healthy", "ejected")]


SCENARIOS = {
    "least_loaded": (_s_least_loaded, {}),
    "draining_excluded": (_s_draining_excluded, {}),
    "drain_restore_keeps_probation": (_s_drain_restore_keeps_probation,
                                      {}),
    "degraded_only_when_healthy_unavailable": (
        _s_degraded_only_when_healthy_unavailable,
        {"degraded_penalty": 1e6}),
    "error_rate_degrades_then_ejects": (
        _s_error_rate_degrades_then_ejects,
        {"window": 8, "min_outcomes": 4}),
    "circuit_reopens_into_probation": (_s_circuit_reopens_into_probation,
                                       {}),
    "probation_error_doubles_backoff": (_s_probation_error_doubles_backoff,
                                        {}),
    "stale_heartbeat": (_s_stale_heartbeat, {}),
    "heartbeat_recovery": (_s_heartbeat_recovery, {}),
    "latency_straggler": (_s_latency_straggler,
                          {"latency_degrade_ratio": 3.0}),
    "probation_probes": (_s_probation_probes, {"probe_every": 4}),
    "dead_session": (_s_dead_session, {}),
    "state_change_callback": (_s_callback, {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_state_sequence_matches_jax(name):
    fn, kw = SCENARIOS[name]
    rigs = {}
    for pkg in PACKAGES:
        rigs[pkg] = _Rig(pkg, **kw)
        fn(rigs[pkg])
    assert rigs["port"].trail == rigs["jax"].trail
    assert rigs["port"].events == rigs["jax"].events
    assert rigs["port"].r.counts() == rigs["jax"].r.counts()


def test_health_policy_validation_matches_jax():
    for bad in (dict(degrade_error_rate=0.6, eject_error_rate=0.5),
                dict(backoff_initial_s=0.0), dict(window=2,
                                                  min_outcomes=4)):
        with pytest.raises(ValueError):
            HealthPolicy(**bad)
        with pytest.raises(ValueError):
            jserve.HealthPolicy(**bad)


# -- the fault injector (both packages) ---------------------------------------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_fault_injector(pkg):
    mod = PACKAGES[pkg][0]
    inj = mod.FaultInjector()
    inj.arm(0, "crash")
    with pytest.raises(mod.ReplicaCrash):
        inj.on_dispatch(0)
    assert inj.on_dispatch(0) is None    # dead is dead: one shot
    assert inj.fired("crash") == 1
    inj.arm(1, "nan")
    assert inj.on_dispatch(0) is None
    assert inj.on_dispatch(1) == "nan"
    assert inj.on_dispatch(1) is None    # times=1 default
    inj.arm(0, "stall", seconds=0.05)
    t0 = time.perf_counter()
    inj.on_dispatch(0)
    assert time.perf_counter() - t0 >= 0.04
    inj.arm(0, "saturate", times=None)
    for _ in range(2):
        with pytest.raises(mod.ServeOverloaded):
            inj.on_admission(0)
    inj.clear(0, "saturate")
    inj.on_admission(0)
    with pytest.raises(ValueError, match="kind"):
        inj.arm(0, "gremlins")
    with pytest.raises(ValueError, match="seconds"):
        inj.arm(0, "stall")
    assert [k for _, k, _ in inj.log] == ["crash", "nan", "stall",
                                           "saturate", "saturate"]


# -- one-shot fleet integration ---------------------------------------------


_DIM = 8


def _jax_infer(p, b):
    """``tests/test_fleet.py``'s one-shot ``infer_fn``, through JAX."""
    return {"y": (jnp.asarray(b["x"]) @ jnp.asarray(p["w"])).mean(
        axis=(1, 2))}


def _infer(p, b):
    return {"y": (b["x"] @ p["w"]).mean(dim=(1, 2))}


def _mlp_fleet(replicas=2, faults=None, w_scale=1.0, fleet_kw=None,
               serve_kw=None):
    params = {"w": torch.eye(_DIM) * w_scale}
    cfg = tpx.Config(serve_config=tpx.ServeConfig(
        max_batch=2, max_wait_ms=1.0, **(serve_kw or {})))

    def make_replica(rid, **kw):
        return ServeSession(
            _infer, params,
            example_feed={"x": np.zeros((4, _DIM), np.float32)},
            config=cfg, device="cpu", **kw)

    # the maintenance loop's probes stay off (the router moves only on
    # request outcomes and deaths, which these tests drive): on the CPU a
    # replica's sub-millisecond latencies make the latency-straggler probe
    # flip on scheduling noise alone
    fleet_kw = {"tick_interval_s": 3600.0, **(fleet_kw or {})}
    fc = FleetConfig(num_replicas=replicas, **fleet_kw)
    return ServeFleet(make_replica, config=fc, faults=faults), params


def _feed(v):
    return {"x": np.full((4, _DIM), float(v), np.float32)}


def _want(v, w_scale=1.0):
    """JAX's infer_fn on the same feed and weights."""
    out = _jax_infer({"w": np.eye(_DIM, dtype=np.float32) * w_scale},
                     {"x": _feed(v)["x"][None]})
    return float(np.asarray(out["y"])[0])


def test_fleet_serves_correctly_across_replicas():
    fleet, _ = _mlp_fleet()
    try:
        reqs = [fleet.submit(_feed(i)) for i in range(10)]
        for i, r in enumerate(reqs):
            np.testing.assert_allclose(r.result(timeout=30.0)["y"],
                                       _want(i), rtol=1e-5)
        s = fleet.stats()
        assert s["fleet.completed"] == 10
        assert s["fleet.replicas_healthy"] == 2
        assert fleet.recompiles() == 0
        assert {len(r.replicas) for r in reqs} == {1}
    finally:
        fleet.close()


def test_crash_fails_over_without_losing_requests():
    inj = FaultInjector()
    fleet, _ = _mlp_fleet(faults=inj)
    try:
        inj.arm(0, "crash")
        reqs = [fleet.submit(_feed(i)) for i in range(8)]
        for i, r in enumerate(reqs):
            np.testing.assert_allclose(r.result(timeout=30.0)["y"],
                                       _want(i), rtol=1e-5)
        s = fleet.stats()
        assert s["replicas"]["0"]["state"] == EJECTED
        assert s["replicas"]["0"]["dead"] is True
        assert s["fleet.ejections"] >= 1
        assert s["fleet.failovers"] >= 1
        assert s["fleet.failed"] == 0
        # the requests replica 0 held show the two-hop trail, and their
        # lifecycle records carry it with the retry
        assert any(r.replicas == [0, 1] for r in reqs), \
            [r.replicas for r in reqs]
        recs = {r["id"]: r for r in fleet.request_records()}
        for r in reqs:
            if r.replicas == [0, 1]:
                assert recs[r.id]["hops"] == [0, 1]
                assert recs[r.id]["retries"] == 1
                assert "failover_ms" in recs[r.id]["phases_ms"]
    finally:
        fleet.close()


def test_whole_fleet_death_fails_fast_and_retryably():
    inj = FaultInjector()
    fleet, _ = _mlp_fleet(faults=inj)
    try:
        inj.arm(0, "crash")
        inj.arm(1, "crash")
        reqs = []
        for i in range(4):
            try:
                reqs.append(fleet.submit(_feed(i)))
            except ReplicaUnavailable:
                # the whole fleet died before this submit: a refusal at
                # admission is also correct
                pass
        for r in reqs:
            with pytest.raises(ReplicaUnavailable):
                r.result(timeout=30.0)
    finally:
        fleet.close()


def test_nan_output_is_detected_and_retried():
    inj = FaultInjector()
    fleet, _ = _mlp_fleet(faults=inj)
    try:
        inj.arm(0, "nan", times=1)
        inj.arm(1, "nan", times=1)
        reqs = [fleet.submit(_feed(i)) for i in range(8)]
        for i, r in enumerate(reqs):
            out = r.result(timeout=30.0)
            assert np.isfinite(out["y"]).all()
            np.testing.assert_allclose(out["y"], _want(i), rtol=1e-5)
        assert fleet.stats()["fleet.retries"] >= 1
    finally:
        fleet.close()


def test_saturation_spills_then_sheds_fleet_wide():
    inj = FaultInjector()
    fleet, _ = _mlp_fleet(faults=inj)
    try:
        inj.arm(0, "saturate", times=None)
        reqs = [fleet.submit(_feed(i)) for i in range(4)]
        for i, r in enumerate(reqs):
            np.testing.assert_allclose(r.result(timeout=30.0)["y"],
                                       _want(i), rtol=1e-5)
        assert all(r.replicas == [1] for r in reqs)
        inj.arm(1, "saturate", times=None)
        with pytest.raises(ServeOverloaded):
            fleet.submit(_feed(0))
        assert fleet.stats()["fleet.shed"] == 1
    finally:
        fleet.close()


def test_hot_swap_takes_effect_with_nothing_captured():
    fleet, _ = _mlp_fleet()
    try:
        r = fleet.submit(_feed(3))
        np.testing.assert_allclose(r.result(timeout=30.0)["y"], _want(3),
                                   rtol=1e-5)
        outcome = fleet.push_weights({"w": torch.eye(_DIM) * 2.0})
        assert set(outcome.values()) == {"swapped"}
        r = fleet.submit(_feed(3))
        np.testing.assert_allclose(r.result(timeout=30.0)["y"],
                                   _want(3, 2.0), rtol=1e-5)
        s = fleet.stats()
        assert s["fleet.hotswaps"] == 2
        assert s["fleet.drain_seconds"]["count"] == 2
        assert s["fleet.replicas_healthy"] == 2
        assert fleet.recompiles() == 0
        assert all(v["serve"]["serve.hotswaps"] == 1
                   for v in s["replicas"].values())
    finally:
        fleet.close()


def test_scale_up_after_push_serves_pushed_weights():
    fleet, _ = _mlp_fleet(fleet_kw={"max_replicas": 3})
    try:
        fleet.push_weights({"w": torch.eye(_DIM) * 2.0})
        rid = fleet.scale_up()
        assert rid == 2
        sub = fleet._router.get(rid).session.submit(_feed(3))
        np.testing.assert_allclose(sub.result(timeout=30.0)["y"],
                                   _want(3, 2.0), rtol=1e-5)
        assert fleet.recompiles() == 0
    finally:
        fleet.close()


def test_one_bad_batch_does_not_eject_a_replica():
    inj = FaultInjector()
    fleet, _ = _mlp_fleet(faults=inj)
    try:
        for i in range(12):
            fleet.submit(_feed(i)).result(timeout=30.0)
        inj.arm(0, "nan", times=1)
        inj.arm(1, "nan", times=1)
        reqs = [fleet.submit(_feed(i)) for i in range(4)]
        for i, r in enumerate(reqs):
            np.testing.assert_allclose(r.result(timeout=30.0)["y"],
                                       _want(i), rtol=1e-5)
        s = fleet.stats()
        assert s["fleet.ejections"] == 0, s["replicas"]
        assert all(v["state"] in (HEALTHY, DEGRADED)
                   for v in s["replicas"].values()), s["replicas"]
    finally:
        fleet.close()


def test_swap_refuses_architecture_change():
    fleet, _ = _mlp_fleet()
    try:
        with pytest.raises(RuntimeError, match="hot-swap failed"):
            fleet.push_weights({"w": torch.zeros(_DIM, _DIM + 1)})
        s = fleet.stats()
        assert s["fleet.hotswap_failures"] == 2
        assert all(v["state"] == EJECTED for v in s["replicas"].values())
    finally:
        fleet.close()


def test_deadline_respected_across_failover():
    inj = FaultInjector()
    fleet, _ = _mlp_fleet(faults=inj)
    try:
        inj.arm(0, "crash")
        inj.arm(1, "crash")
        admitted = 0
        for i in range(4):
            try:
                r = fleet.submit(_feed(i), deadline_ms=5000.0)
            except ReplicaUnavailable:
                continue
            admitted += 1
            with pytest.raises((ReplicaUnavailable, DeadlineExceeded)):
                r.result(timeout=30.0)
        assert admitted >= 1
    finally:
        fleet.close()


def test_submit_after_close_raises():
    fleet, _ = _mlp_fleet()
    fleet.close()
    with pytest.raises(ServeClosed):
        fleet.submit(_feed(0))


def test_training_session_push_weights_into_fleet(rng):
    """``ParallaxSession.push_weights(fleet)``: the trained parameters
    hot-swap into every replica; served outputs equal JAX's infer_fn on
    the trained weights, and nothing is captured again."""

    def init_fn(gen, device):
        return {"w": torch.randn((_DIM, _DIM), generator=gen,
                                 device=device) * 0.1}

    def loss_fn(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    sess, *_ = tpx.parallel_run(
        tpx.Model(init_fn, loss_fn, optimizer=optim.sgd(0.05)),
        parallax_config=tpx.Config(run_option="AR"), device="cpu")
    fleet, _ = _mlp_fleet()
    try:
        with pytest.raises(ValueError, match="built engine"):
            sess.push_weights(fleet)
        batch = {"x": rng.standard_normal((16, _DIM)).astype(np.float32),
                 "y": rng.standard_normal((16, _DIM)).astype(np.float32)}
        for _ in range(3):
            sess.run("loss", feed_dict=batch)
        assert set(sess.push_weights(fleet).values()) == {"swapped"}
        w = sess.gather_params()["w"].detach().numpy()
        for i in range(4):
            got = fleet.submit(_feed(i)).result(timeout=30.0)["y"]
            want = np.asarray(_jax_infer({"w": w}, {"x": _feed(i)["x"][
                None]})["y"])[0]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        assert fleet.stats()["fleet.hotswaps"] == 2
        assert fleet.recompiles() == 0
    finally:
        fleet.close()
        sess.close()


# -- the autoscaler (fake replicas, deterministic) ------------------------------


def _autoscale_fleet():
    sessions = []

    def make_replica(rid, **kw):
        s = _FakeSession(load=0.0)
        s.heartbeat = time.perf_counter()
        sessions.append(s)
        return s

    fc = FleetConfig(num_replicas=1, min_replicas=1, max_replicas=3,
                     autoscale=True, autoscale_high_load=4.0,
                     autoscale_low_load=0.5, autoscale_sustain_ticks=2,
                     tick_interval_s=3600.0)  # the test drives ticks
    return ServeFleet(make_replica, config=fc), sessions


def _settle(fleet, n, timeout=5.0):
    """Scale actions run off the maintenance thread: wait for the
    spawned action to land."""
    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        if fleet.num_replicas == n and not fleet._autoscale_busy:
            return
        time.sleep(0.005)
    raise AssertionError(f"fleet did not settle at {n} replicas "
                         f"(at {fleet.num_replicas})")


def test_autoscaler_scales_up_on_sustained_pressure_only():
    fleet, sessions = _autoscale_fleet()
    try:
        sessions[0]._load = 10.0
        fleet._autoscale_tick()          # 1 tick: not sustained
        assert fleet.num_replicas == 1
        fleet._autoscale_tick()          # sustained -> scale up
        _settle(fleet, 2)
        assert fleet.stats()["fleet.scale_ups"] == 1
        # a blip does not scale: the counter resets between
        sessions[0]._load = sessions[1]._load = 1.0
        fleet._autoscale_tick()
        sessions[0]._load = sessions[1]._load = 10.0
        fleet._autoscale_tick()
        _settle(fleet, 2)
        assert fleet.stats()["fleet.mean_load"] == 10.0
    finally:
        fleet.close()


def test_autoscaler_scales_down_via_drain_never_below_min():
    fleet, sessions = _autoscale_fleet()
    try:
        sessions[0]._load = 10.0
        fleet._autoscale_tick()
        fleet._autoscale_tick()
        _settle(fleet, 2)
        sessions[0]._load = 0.0
        fleet._autoscale_tick()
        fleet._autoscale_tick()
        _settle(fleet, 1)
        assert any(s.closed for s in sessions)
        fleet._autoscale_tick()
        fleet._autoscale_tick()
        _settle(fleet, 1)                # the min_replicas floor
        assert fleet.stats()["fleet.scale_downs"] == 1
    finally:
        fleet.close()


def test_scale_up_bounded_by_max_replicas():
    fleet, _ = _autoscale_fleet()
    try:
        assert fleet.scale_up() is not None
        assert fleet.scale_up() is not None
        assert fleet.scale_up() is None  # at max_replicas=3
        assert fleet.num_replicas == 3
    finally:
        fleet.close()


def test_fleet_config_validation_matches_jax():
    for bad in (dict(num_replicas=0), dict(min_replicas=3,
                                           num_replicas=2),
                dict(max_retries=-1),
                dict(autoscale_low_load=5.0, autoscale_high_load=4.0)):
        with pytest.raises(ValueError):
            FleetConfig(**bad)
        with pytest.raises(ValueError):
            jserve.FleetConfig(**bad)


# -- decode: failover token identity, and one program a live session -------


T, TS, SLOTS, PAGE = 8, 6, 2, 4


def _nmt_fixture():
    """JAX's tiny fp32 decode-fleet NMT (tools/loadgen.py's
    ``demo_decode_fleet`` widths) and its params carried to the port."""
    import jax.numpy as jnp
    jcfg = jnmt.tiny_config(vocab_size=64, model_dim=16, num_heads=4,
                            mlp_dim=32, num_layers=2, max_len=max(T, TS),
                            num_partitions=1, compute_dtype=jnp.float32)
    jparams = jnmt.build_model(jcfg).init_fn(jax.random.PRNGKey(0))
    tcfg = tnmt.tiny_config(vocab_size=64, model_dim=16, num_heads=4,
                            mlp_dim=32, num_layers=2, max_len=max(T, TS),
                            num_partitions=1, compute_dtype=torch.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _program(tcfg):
    return tpx.NMTDecodeProgram(tcfg, max_src_len=TS, max_len=T,
                                page_size=PAGE,
                                pool_pages=SLOTS * (T // PAGE),
                                device="cpu")


def _decode_factory(tcfg, tparams, shared=None):
    pcfg = tpx.Config(serve_config=tpx.ServeConfig(max_batch=SLOTS,
                                                   max_queue=4096))

    def make_replica(rid, **serve_kw):
        prog = shared if shared is not None else _program(tcfg)
        return ServeSession(program=prog, params=tparams, config=pcfg,
                            device="cpu", **serve_kw)
    return make_replica


def _make_feed(i):
    r = np.random.default_rng(100 + i)
    return {"src": r.integers(3, 64, (int(r.integers(2, TS + 1)),))
            .astype(np.int32)}


def test_decode_failover_token_identity_paged():
    """A crash on a replica holding requests: each is retried on the
    survivor, in another slot beside other neighbours, and every
    request's tokens equal JAX's ``greedy_decode``. The dead replica's
    pages go with it; the survivor ends with none in use. One
    ``serve.request`` span a request, from the delivering replica, with
    its id and hop count."""
    jcfg, jparams, tcfg, tparams = _nmt_fixture()
    inj = FaultInjector()
    fleet = ServeFleet(_decode_factory(tcfg, tparams),
                       config=FleetConfig(num_replicas=2), faults=inj)
    n = 8
    col = trace.TraceCollector(capacity=4096)
    prev = trace.set_collector(col)
    try:
        # park replica 0's loop inside a stall, so it holds the requests
        # placed on it when the crash is armed: the crash then fires on
        # its first pass after the stall, deterministically
        inj.arm(0, "stall", seconds=0.3)
        t_end = time.perf_counter() + 5.0
        while inj.fired("stall") == 0 and time.perf_counter() < t_end:
            time.sleep(0.002)
        reqs = [fleet.submit(_make_feed(i)) for i in range(n)]
        inj.arm(0, "crash")
        outs = [r.result(timeout=60.0) for r in reqs]
        retried = [r for r in reqs if len(r.replicas) > 1]
        assert retried, "the crash caused no failover"
        assert {len(r.replicas) for r in retried} == {2}
        assert fleet.recompiles() == 0
        s = fleet.stats()
        assert s["replicas"]["0"]["dead"] and s["fleet.failed"] == 0
    finally:
        fleet.close()
        trace.set_collector(prev)
    assert s["replicas"]["1"]["serve"]["serve.kv_pages_in_use"] == 0
    for i, (r, out) in enumerate(zip(reqs, outs)):
        src = _make_feed(i)["src"]
        ref = np.asarray(jnmt.greedy_decode(
            jparams, jcfg, src[None], max_len=T))[0].tolist()
        if jnmt.EOS_ID in ref:
            ref = ref[:ref.index(jnmt.EOS_ID) + 1]
        assert list(out) == ref, (i, r.replicas, list(out), ref)
    spans = {}
    for ev in col.events():
        if ev.name == "serve.request":
            spans.setdefault(ev.args["rid"], []).append(ev)
    for r in reqs:
        assert len(spans.get(r.id, [])) == 1, (r.id, r.replicas)
        args = spans[r.id][0].args
        assert args["replica"] == r.replicas[-1], (args, r.replicas)
        assert args["hops"] == len(r.replicas), (args, r.replicas)


def test_one_program_serves_one_live_session():
    """Fault C4: a decode program's captured graphs and staging buffers
    belong to the scheduler that warmed it. A second live session on
    the same program is refused (before, it silently took the program
    over: the first session's graphs were replaced, so on the card it
    replayed nothing and ran every step eagerly, and both threads
    staged into one buffer). Closing — or the death of the holder —
    releases the program; a fleet factory sharing one program fails at
    construction."""
    _, _, tcfg, tparams = _nmt_fixture()
    prog = _program(tcfg)
    make = _decode_factory(tcfg, tparams, shared=prog)
    a = make(0)
    try:
        with pytest.raises(ValueError, match="one program per replica"):
            make(1)
        assert a.alive
        first = a.submit(_make_feed(0)).result(timeout=30)
    finally:
        a.close()
    b = make(2)                      # released at close
    try:
        assert list(b.submit(_make_feed(0)).result(timeout=30)) == \
            list(first)
        # a dead holder releases the program too
        inj = FaultInjector()
        b._scheduler._faults = inj
        inj.arm(b.replica_id, "crash")
        t_end = time.perf_counter() + 5.0
        while b.alive and time.perf_counter() < t_end:
            time.sleep(0.005)
        assert not b.alive
        c = make(3)
        c.close()
    finally:
        b.close()
    built = []
    shared = _decode_factory(tcfg, tparams, shared=_program(tcfg))

    def make_replica(rid, **kw):
        built.append(shared(rid, **kw))
        return built[-1]

    try:
        with pytest.raises(ValueError, match="one program per replica"):
            ServeFleet(make_replica, config=FleetConfig(num_replicas=2))
    finally:
        for sess in built:
            sess.close()
    assert len(built) == 1
