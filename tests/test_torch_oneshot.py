"""The port's one-shot micro-batched serving against the JAX package's.

``ServeSession(infer_fn, params, example_feed=...)`` micro-batches
single requests onto a declared (batch bucket, length bucket) signature
set. Held to ``tests/test_serve.py``: the queue's group formation
(``RequestQueue.form_group``) on the same request streams through both
packages' classes, and ``TestOneShotServing``'s contract with the same
tiny tanh-MLP, whose served outputs equal JAX's ``infer_fn`` on the same
padded inputs within 1e-5. On the CPU ``warmup`` registers the
signatures and dispatch runs ``infer_fn`` eagerly (the card captures one
graph a signature: tests/test_torch_fleet_gpu.py); a dispatch outside
the registered set is counted in ``serve.recompiles``. Plus
``ParallaxSession.serve``, the train -> serve handoff.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.common.config import ServeConfig as JServeConfig
from parallax_tpu.compile import bucketing as jbucketing
from parallax_tpu.serve import Request as JRequest
from parallax_tpu.serve import RequestQueue as JRequestQueue
import parallax_tpu_torch as tpx
from parallax_tpu_torch.core import optim
from parallax_tpu_torch.serve import (DeadlineExceeded, MicroBatcher,
                                      Request, RequestQueue, ServeClosed,
                                      ServeOverloaded, ServeSession)

DIM = 8
PACKAGES = {"port": (Request, RequestQueue),
            "jax": (JRequest, JRequestQueue)}


# -- group formation: the same streams through both packages' queues ---------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_form_group_batches_by_key_in_fifo_order(pkg):
    Req, Queue = PACKAGES[pkg]
    q = Queue(max_queue=16)
    reqs = [Req({"x": i}, group_key=("a" if i % 2 else "b"))
            for i in range(6)]
    for r in reqs:
        q.put(r)
    stop = threading.Event()
    # the oldest request (i=0, key "b") picks the group
    g1 = q.form_group(4, max_wait_s=0.0, stop=stop)
    assert [r.feed["x"] for r in g1] == [0, 2, 4]
    g2 = q.form_group(4, max_wait_s=0.0, stop=stop)
    assert [r.feed["x"] for r in g2] == [1, 3, 5]
    assert q.form_group(4, max_wait_s=0.0, stop=stop, poll_s=0.01) == []


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_form_group_waits_for_fill_or_age(pkg):
    Req, Queue = PACKAGES[pkg]
    q = Queue(max_queue=16)
    stop = threading.Event()
    q.put(Req({"x": 0}))
    t0 = time.perf_counter()
    got = q.form_group(4, max_wait_s=0.05, stop=stop)
    waited = time.perf_counter() - t0
    assert len(got) == 1 and waited >= 0.04
    # a full group dispatches without aging
    for i in range(4):
        q.put(Req({"x": i}))
    t0 = time.perf_counter()
    got = q.form_group(4, max_wait_s=10.0, stop=stop)
    assert len(got) == 4
    assert time.perf_counter() - t0 < 5.0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_closed_queue_rejects_and_drains(pkg):
    Req, Queue = PACKAGES[pkg]
    q = Queue(max_queue=8)
    r = Req({"x": 1})
    q.put(r)
    q.close()
    with pytest.raises(Exception, match="closed"):
        q.put(Req({"x": 2}))
    # draining still serves the accepted request, immediately
    got = q.form_group(4, max_wait_s=10.0, stop=threading.Event())
    assert got == [r]
    assert q.fail_all(RuntimeError("gone")) == 0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_expiry_is_shed_and_reported_outside_the_lock(pkg):
    """A request expired in the queue fails with DeadlineExceeded; the
    ``on_timeout`` hook hears of it once, and a hook that raises never
    reaches the caller. Tenant accounting releases on the failure."""
    Req, Queue = PACKAGES[pkg]
    seen = []

    def hook(n):
        seen.append(n)
        raise RuntimeError("a broken recorder")

    q = Queue(max_queue=8, on_timeout=hook, default_tenant_quota=4)
    dead = Req({"x": 1}, deadline=time.perf_counter() - 0.01, tenant="t")
    live = Req({"x": 2}, tenant="t")
    q.put(dead)
    q.put(live)
    assert q.tenant_outstanding("t") == 2
    assert q.form_group(4, 0.0, threading.Event()) == [live]
    with pytest.raises(Exception, match="deadline"):
        dead.result(timeout=1.0)
    assert seen == [1]
    assert q.tenant_outstanding("t") == 1


def test_micro_batcher_fails_the_batch_not_the_loop():
    """A non-fatal batch failure fails that batch only; a fatal one
    fails the queue with the retryable ReplicaUnavailable, closes
    admission and reports on_fatal."""
    from parallax_tpu_torch.serve import ReplicaCrash, ReplicaUnavailable
    calls, fatal, errors = [], [], []

    def run(batch):
        calls.append([r.feed["x"] for r in batch])
        if batch[0].feed["x"] == 1:
            raise ValueError("bad batch")
        if batch[0].feed["x"] == 3:
            raise ReplicaCrash("dead")
        for r in batch:
            r._complete(r.feed["x"] * 10)

    q = RequestQueue(max_queue=16)
    mb = MicroBatcher(q, run, max_batch=1, max_wait_ms=0.0,
                      on_error=lambda e, n: errors.append(type(e)),
                      on_fatal=fatal.append)
    reqs = [Request({"x": i}) for i in range(3)]
    for r in reqs:
        q.put(r)
    assert reqs[0].result(timeout=10) == 0
    with pytest.raises(ValueError, match="bad batch"):
        reqs[1].result(timeout=10)
    assert reqs[2].result(timeout=10) == 20
    assert mb.alive
    crash = Request({"x": 3})
    q.put(crash)
    with pytest.raises(ReplicaUnavailable, match="dead"):
        crash.result(timeout=10)
    mb.drain(1.0)
    assert not mb.alive and q.closed
    assert [type(e) for e in fatal] == [ReplicaCrash]
    assert errors == [ValueError, ReplicaCrash]


# -- one-shot serving --------------------------------------------------------


def _jparams():
    return {"w": np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                              (DIM, DIM)) / np.sqrt(DIM))}


def jax_infer_fn(params, batch):
    h = jnp.tanh(batch["x"] @ params["w"])
    return {"score": h.mean(axis=(1, 2)),
            "norm": jnp.linalg.norm(h.reshape(h.shape[0], -1), axis=-1)}


def infer_fn(params, batch):
    h = torch.tanh(batch["x"] @ params["w"])
    return {"score": h.mean(dim=(1, 2)),
            "norm": torch.linalg.norm(h.reshape(h.shape[0], -1), dim=-1)}


def _mlp_serve(max_batch=4, length_buckets=(8, 16), max_wait_ms=2.0,
               warmup=True, **sc_kw):
    params = {"w": torch.from_numpy(_jparams()["w"].copy())}
    cfg = tpx.Config(serve_config=tpx.ServeConfig(
        max_batch=max_batch, max_wait_ms=max_wait_ms,
        length_buckets=list(length_buckets), **sc_kw))
    sess = ServeSession(
        infer_fn, params,
        example_feed={"x": np.zeros((length_buckets[-1], DIM),
                                    np.float32)},
        config=cfg, ragged_feeds=("x",), warmup=warmup, device="cpu")
    return sess


def test_results_match_jax_infer_fn(rng):
    sess = _mlp_serve()
    jparams = _jparams()
    try:
        feeds = [{"x": rng.standard_normal((L, DIM)).astype(np.float32)}
                 for L in (5, 8, 13, 3, 16, 7)]
        reqs = [sess.submit(f) for f in feeds]
        for f, r in zip(feeds, reqs):
            got = r.result(timeout=30.0)
            # the reference: the same padded example through JAX's fn
            L = jbucketing.length_bucket(f["x"].shape[0], (8, 16))
            x = jbucketing.pad_axis0(f["x"], L)[None]
            want = jax.tree.map(np.asarray,
                                jax_infer_fn(jparams, {"x": x}))
            for k in ("score", "norm"):
                assert got[k].shape == () and got[k].dtype == np.float32
                np.testing.assert_allclose(got[k], want[k][0], rtol=1e-5,
                                           atol=1e-6)
    finally:
        sess.close()


def test_mixed_length_traffic_never_recaptures(rng):
    """The acceptance invariant: the declared (batch x length) signature
    set is closed — mixed ragged traffic dispatches registered
    signatures only."""
    sess = _mlp_serve()
    try:
        # 3 batch buckets (1, 2, 4) x 2 lengths
        assert len(sess.warmup_seconds) == 6
        reqs = [sess.submit(
            {"x": rng.standard_normal((int(rng.integers(1, 17)), DIM))
             .astype(np.float32)}) for _ in range(24)]
        for r in reqs:
            r.result(timeout=30.0)
        assert sess.stats()["serve.recompiles"] == 0
        assert len(sess._signatures) == 6
    finally:
        sess.close()


def test_signature_missed_at_serve_time_is_counted(rng):
    """Without the warmup every first dispatch of a signature misses
    the set: it is prepared then (captured, on the card) and counted,
    and served all the same."""
    sess = _mlp_serve(warmup=False, max_batch=1)
    try:
        for L in (5, 6, 12):
            x = rng.standard_normal((L, DIM)).astype(np.float32)
            sess.submit({"x": x}).result(timeout=30.0)
        # lengths 5 and 6 share the bucket-8 signature
        assert sess.stats()["serve.recompiles"] == 2
    finally:
        sess.close()


def test_oversize_length_refused_at_submit():
    sess = _mlp_serve()
    try:
        with pytest.raises(ValueError, match="length bucket"):
            sess.submit({"x": np.zeros((17, DIM), np.float32)})
    finally:
        sess.close()


def test_off_signature_request_refused_not_captured():
    """A feed outside the declared serving set is REFUSED at admission
    (it could only be served by a capture at serve time): wrong
    non-ragged dims and wrong dtypes alike."""
    sess = _mlp_serve()
    try:
        with pytest.raises(ValueError, match="declared serving"):
            sess.submit({"x": np.zeros((8, DIM + 1), np.float32)})
        with pytest.raises(ValueError, match="declared serving"):
            sess.submit({"x": np.zeros((8, DIM), np.float64)})
        with pytest.raises(ValueError, match="example names"):
            sess.submit({"y": np.zeros((8, DIM), np.float32)})
        assert sess.stats()["serve.recompiles"] == 0
    finally:
        sess.close()


def test_deadline_sheds_instead_of_serving_late():
    sess = _mlp_serve(max_wait_ms=200.0)
    try:
        r = sess.submit({"x": np.zeros((8, DIM), np.float32)},
                        deadline_ms=0.001)
        with pytest.raises(DeadlineExceeded):
            r.result(timeout=10.0)
        assert sess.stats()["serve.timeouts"] >= 1
    finally:
        sess.close()


def test_overload_sheds_at_admission():
    sess = _mlp_serve(max_batch=2, max_wait_ms=100.0, max_queue=2)
    try:
        shed, accepted = 0, []
        for _ in range(16):
            try:
                accepted.append(sess.submit(
                    {"x": np.zeros((8, DIM), np.float32)}))
            except ServeOverloaded:
                shed += 1
        assert shed > 0
        for r in accepted:
            r.result(timeout=30.0)
        assert sess.stats()["serve.shed"] == shed
    finally:
        sess.close()


def test_close_drains_then_rejects():
    sess = _mlp_serve(max_wait_ms=50.0)
    try:
        reqs = [sess.submit({"x": np.zeros((8, DIM), np.float32)})
                for _ in range(6)]
    finally:
        sess.close()  # drain: accepted requests still complete
    for r in reqs:
        assert r.result(timeout=1.0) is not None
    with pytest.raises(ServeClosed):
        sess.submit({"x": np.zeros((8, DIM), np.float32)})


def test_close_without_drain_fails_queued_requests():
    """close(drain=False) is the fast path: queued requests FAIL with
    ServeClosed instead of being served during shutdown. The first
    batch is held in flight (its infer_fn waits on a gate) until the
    close has landed, so exactly it is served."""
    gate = threading.Event()

    def gated(p, b):
        gate.wait(10.0)
        return infer_fn(p, b)

    sess = ServeSession(
        gated, {"w": torch.eye(DIM)},
        example_feed={"x": np.zeros((8, DIM), np.float32)},
        config=tpx.Config(serve_config=tpx.ServeConfig(
            max_batch=2, max_wait_ms=5000.0, max_queue=32)),
        device="cpu")
    reqs = [sess.submit({"x": np.zeros((8, DIM), np.float32)})
            for _ in range(8)]
    t_end = time.perf_counter() + 10.0
    while not sess._batcher.busy and time.perf_counter() < t_end:
        time.sleep(0.001)
    closer = threading.Thread(target=sess.close, kwargs={"drain": False})
    closer.start()
    while not sess._batcher._stop.is_set() and time.perf_counter() < t_end:
        time.sleep(0.001)
    gate.set()
    closer.join(20.0)
    outcomes = []
    for r in reqs:
        try:
            r.result(timeout=5.0)
            outcomes.append("served")
        except ServeClosed:
            outcomes.append("closed")
    assert outcomes == ["served"] * 2 + ["closed"] * 6, outcomes


def test_batch_occupancy_and_latency_metrics_flow(rng):
    sess = _mlp_serve()
    try:
        reqs = [sess.submit({"x": rng.standard_normal((8, DIM))
                             .astype(np.float32)}) for _ in range(8)]
        for r in reqs:
            r.result(timeout=30.0)
        stats = sess.stats()
        assert stats["serve.completed"] == 8
        assert stats["serve.request_latency_ms"]["count"] == 8
        assert stats["serve.batch_occupancy"]["count"] >= 1
        assert 0 < stats["serve.batch_occupancy"]["max"] <= 1.0
        assert stats["serve.step_ms"]["count"] >= 1
        recs = sess.request_records()
        assert len(recs) == 8 and all(
            r["hops"] == [None] and "service_ms" in r["phases_ms"]
            for r in recs)
    finally:
        sess.close()


def test_scalar_outputs_fan_out_to_every_request(rng):
    """A 0-d output leaf goes to every request of the batch unchanged;
    batched leaves are split by row."""
    params = {"w": torch.ones(())}

    def fn(p, b):
        return {"rows": b["x"].sum(-1) * p["w"], "scale": p["w"] * 3}

    sess = ServeSession(fn, params, example_feed={"x": np.zeros(
        (4,), np.float32)}, config=tpx.Config(serve_config=tpx.ServeConfig(
            max_batch=4, max_wait_ms=20.0)), device="cpu")
    try:
        xs = [np.full((4,), float(i), np.float32) for i in range(4)]
        got = [r.result(timeout=30) for r in [sess.submit({"x": x})
                                              for x in xs]]
    finally:
        sess.close()
    for i, g in enumerate(got):
        assert float(g["rows"]) == 4.0 * i and float(g["scale"]) == 3.0


def test_serve_config_bucket_resolution_matches_jax():
    for kw in (dict(max_batch=8), dict(max_batch=6),
               dict(max_batch=4, batch_buckets=[4, 2]),
               dict(max_batch=1)):
        assert tpx.ServeConfig(**kw).resolved_batch_buckets() == \
            JServeConfig(**kw).resolved_batch_buckets(), kw


def test_construction_refusals():
    params = {"w": torch.zeros(2)}
    ex = {"x": np.zeros((4,), np.float32)}
    with pytest.raises(ValueError, match="exactly one"):
        ServeSession(params=params, example_feed=ex, device="cpu")
    with pytest.raises(ValueError, match="length_buckets"):
        ServeSession(lambda p, b: b["x"], params, example_feed=ex,
                     ragged_feeds=("x",), warmup=False, device="cpu")
    with pytest.raises(ValueError, match="not in example_feed"):
        ServeSession(lambda p, b: b["x"], params, example_feed=ex,
                     ragged_feeds=("y",), warmup=False, device="cpu")
    with pytest.raises(ValueError, match="example_feed"):
        ServeSession(lambda p, b: b["x"], params, device="cpu")


def test_parallax_session_serve_handoff(rng):
    """``ParallaxSession.serve()``: the trained params go behind a queue
    on the session's device, ``serve.*`` lands in the session's
    registry, and the served value equals JAX's ``infer_fn`` on the
    trained params."""

    def init_fn(gen, device):
        return {"w": torch.randn((DIM, DIM), generator=gen,
                                 device=device) * 0.1}

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2)

    def t_infer(params, batch):
        return (batch["x"] @ params["w"]).sum(-1).sum(-1)

    def j_infer(params, batch):
        return (batch["x"] @ params["w"]).sum(-1).sum(-1)

    sess, *_ = tpx.parallel_run(
        tpx.Model(init_fn, loss_fn, optimizer=optim.sgd(0.05)),
        parallax_config=tpx.Config(
            run_option="AR", serve_config=tpx.ServeConfig(
                max_batch=2, max_wait_ms=2.0)), device="cpu")
    try:
        with pytest.raises(ValueError, match="built engine"):
            sess.serve(t_infer, example_feed={"x": np.zeros((4, DIM),
                                                            np.float32)})
        batch = {"x": rng.standard_normal((16, DIM)).astype(np.float32),
                 "y": rng.standard_normal((16, DIM)).astype(np.float32)}
        for _ in range(3):
            sess.run("loss", feed_dict=batch)
        serve = sess.serve(
            t_infer, example_feed={"x": np.zeros((4, DIM), np.float32)})
        try:
            x = rng.standard_normal((4, DIM)).astype(np.float32)
            got = serve.submit({"x": x}).result(timeout=30.0)
            w = sess.gather_params()["w"].detach().numpy()
            want = float(np.asarray(j_infer({"w": w}, {"x": x[None]}))[0])
            np.testing.assert_allclose(got, want, rtol=1e-5)
            assert sess.metrics_snapshot()["serve.completed"] == 1
        finally:
            serve.close()
    finally:
        sess.close()
