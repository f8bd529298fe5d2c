"""The port's compile-ahead engine against the JAX package's ``compile/``.

* Bucketing: ``resolve_buckets``, ``bucket_batch`` (padding, the added
  mask, the zeroed mask tail, the oversize pass-through, the empty-batch
  and bad-mask errors), ``bucket_shape``, ``bucket_signatures``,
  ``length_bucket`` and ``batch_signature`` on the same numpy inputs as
  ``parallax_tpu.compile.bucketing``: the results are equal.
* Signatures: the simple model on a ragged stream through both packages'
  sessions, with and without ``shape_buckets``; the port's
  ``engine.recompiles`` equals the JAX engine's, and with buckets the
  per-step losses agree to 1e-5 relative. The JAX sessions shard dim 0
  over the 8 emulated CPU devices, so every size is a multiple of 8 (the
  stream 8, 8, 5, 8, 3 with buckets 4 and 8, times 8).
* ``compile_stats()``, ``warmup`` and ``EngineCache``: the JAX keys and
  counts.
* The static ``combine_slices`` and ``SliceAdagrad`` against the JAX
  ``_combine_slices`` and ``SliceAdagrad`` at 1e-6 relative, with
  duplicate ids, ids outside [0, V), both ``average`` modes; rows no
  valid id names (the padded vocabulary rows among them) stay bitwise.
* The in-place invariant a captured graph needs: after a step every
  tensor of the optimizer, model and slice states, and every parameter,
  keeps its storage. NMT and a small ResNet here; LM1B in
  ``test_torch_train.py``.
* On the CPU ``warmup`` captures nothing and leaves the state bitwise;
  ``warmup(background=True)`` returns its thread and the losses of the
  steps that overlap it are bitwise a foreground warmup's.

All in float32 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as tparallax
from parallax_tpu.compile import bucketing as jb
from parallax_tpu.compile import cache as jcache
from parallax_tpu.models import simple as jsimple
from parallax_tpu.ops import sparse_optim as jso
from parallax_tpu_torch.compile import bucketing as tb
from parallax_tpu_torch.compile import cache as tcache
from parallax_tpu_torch.compile import graphs as tgraphs
from parallax_tpu_torch.core import engine as tengine
from parallax_tpu_torch.models import cnn as tcnn
from parallax_tpu_torch.models import nmt as tnmt
from parallax_tpu_torch.models import resnet as tresnet
from parallax_tpu_torch.models import simple as tsimple
from parallax_tpu_torch.obs.metrics import MetricsRegistry
from parallax_tpu_torch.ops import _cuda
from parallax_tpu_torch.ops import sparse_optim as tso
from parallax_tpu_torch.weights import simple_params_from_jax


def _mk(rng, B, dim=4, w=True):
    b = {"x": rng.standard_normal((B, dim)).astype(np.float32),
         "y": rng.integers(0, 9, (B, 3)).astype(np.int32)}
    if w:
        b["w"] = np.ones((B,), np.float32)
    return b


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# -- bucketing ------------------------------------------------------------


@pytest.mark.parametrize("arg,lead,div", [
    (None, 32, 1), ("auto", 24, 1), ([32, 8, 8], 1, 1), ((4, 16), 7, 4),
    ([1], 5, 1)])
def test_resolve_buckets_equals_jax(arg, lead, div):
    assert tb.resolve_buckets(arg, lead, div) == \
        jb.resolve_buckets(arg, lead, div)


@pytest.mark.parametrize("arg,div,match", [
    ("pow2", 1, "'auto'"), ([0, 8], 1, "positive"), ([], 1, "positive"),
    ([12], 8, "divisible")])
def test_resolve_buckets_refuses_as_jax(arg, div, match):
    for mod in (tb, jb):
        with pytest.raises(ValueError, match=match):
            mod.resolve_buckets(arg, 1, div)
    if div == 1:
        with pytest.raises(ValueError, match=match):
            tparallax.Config(shape_buckets=arg)


@pytest.mark.parametrize("B,buckets,mask,with_w", [
    (10, (16, 32), "w", True),      # ragged: pad, zero the mask tail
    (16, (16, 32), "w", True),      # full: passes through as it is
    (10, (16,), "mask", False),     # absent mask feed: one is added
    (16, (16,), "mask", False),     # full, added mask all ones
    (64, (16, 32), "w", True),      # oversize: passes through
    (64, (16, 32), "mask", False),  # oversize, mask still added
    (3, (4, 8), "w", False)],       # an unused mask name: added
    ids=["ragged", "full", "added_mask", "added_full", "oversize",
         "oversize_added", "added_w"])
def test_bucket_batch_equals_jax(B, buckets, mask, with_w):
    rng = np.random.default_rng(B)
    batch = _mk(rng, B, w=with_w)
    batch["scale"] = np.float32(2.0)          # a 0-d feed passes through
    got, gb = tb.bucket_batch(batch, buckets, mask)
    want, wb = jb.bucket_batch(batch, buckets, mask)
    assert gb == wb
    _same_batch(got, want)
    if wb is not None and wb > B and mask in want:
        assert (np.asarray(got[mask])[B:] == 0).all()
    # the input batch is never written
    assert batch["x"].shape == (B, 4) and set(batch) == (
        {"x", "y", "w", "scale"} if with_w else {"x", "y", "scale"})


def test_bucket_batch_errors_equal_jax():
    rng = np.random.default_rng(0)
    empty = {"x": np.zeros((0, 4), np.float32)}
    bad = {"x": rng.standard_normal((10, 4)).astype(np.float32),
           "w": np.ones((40,), np.float32)}
    for mod in (tb, jb):
        with pytest.raises(ValueError, match="empty batch"):
            mod.bucket_batch(empty, (8,), "w")
        with pytest.raises(ValueError, match="leading dim"):
            mod.bucket_batch(bad, (16,), "w")
    # a full batch has nothing to zero and passes through
    full = dict(bad, x=rng.standard_normal((16, 4)).astype(np.float32))
    assert tb.bucket_batch(full, (16,), "w")[0] is full


@pytest.mark.parametrize("shape,lead,b,scale", [
    ((8, 4), 8, 16, 1), ((8,), 8, 4, 1), ((3, 2), 8, 16, 1), ((), 8, 16, 1),
    ((8, 5), 8, 16, 2), ((3, 2), 8, 16, 2)])
def test_bucket_shape_equals_jax(shape, lead, b, scale):
    assert tb.bucket_shape(shape, lead, b, scale) == \
        jb.bucket_shape(shape, lead, b, scale)


def test_signatures_and_length_bucket_equal_jax():
    rng = np.random.default_rng(1)
    batch = _mk(rng, 8)
    batch["c"] = np.zeros((3,), np.int64)
    assert tb.batch_signature(batch) == jb.batch_signature(batch)
    reordered = dict(reversed(list(batch.items())))
    assert tb.batch_signature(reordered) == tb.batch_signature(batch)
    for scale in (1, 2, lambda name: 1 if name == "c" else 2):
        assert tb.bucket_signatures(batch, 8, (4, 8, 16), scale) == \
            jb.bucket_signatures(batch, 8, (4, 8, 16), scale)
    for n in (0, 1, 5, 8, 9, 17):
        assert tb.length_bucket(n, (16, 8, 1)) == \
            jb.length_bucket(n, (16, 8, 1))
    a = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(tb.pad_axis0(a, 5, -1),
                                  jb.pad_axis0(a, 5, -1))


# -- signatures through both sessions -------------------------------------

STREAM = [64, 64, 40, 64, 24]
BUCKETS = [32, 64]


def _stream():
    rng = np.random.default_rng(0)
    return [jsimple.make_batch(rng, B) for B in STREAM]


def _jax_session(**kw):
    sess, *_ = jparallax.parallel_run(
        jsimple.build_model(0.1), parallax_config=jparallax.Config(
            run_option="AR", search_partitions=False, **kw), seed=0)
    return sess


def _torch_session(jsess, first, **kw):
    import jax
    sess, *_ = tparallax.parallel_run(
        tsimple.build_model(0.1),
        parallax_config=tparallax.Config(run_option="AR", **kw),
        device="cpu")
    sess.prepare(first)
    init = jax.tree.map(np.asarray, jsess.state.params)
    with torch.no_grad():
        for k, v in simple_params_from_jax(init, "cpu").items():
            sess.state.params[k].copy_(v)
    return sess


@pytest.mark.parametrize("buckets", [None, BUCKETS],
                         ids=["unbucketed", "bucketed"])
def test_recompiles_equal_jax_on_a_ragged_stream(buckets):
    batches = _stream()
    jsess = _jax_session(shape_buckets=buckets)
    try:
        jsess.prepare(batches[0])
        tsess = _torch_session(jsess, batches[0], shape_buckets=buckets)
        jlosses = [float(jsess.run("loss", feed_dict=b)) for b in batches]
        jrec = jsess.metrics.counter("engine.recompiles").value
    finally:
        jsess.close()
    tlosses = [float(tsess.run("loss", feed_dict=b)) for b in batches]
    trec = tsess.metrics.counter("engine.recompiles").value
    assert trec == jrec == (0 if buckets else 2)
    if buckets:
        np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
        assert tsess.engine._buckets == tuple(BUCKETS)
    tsess.close()


def test_compile_stats_and_engine_cache_equal_jax():
    batches = _stream()
    jsess = _jax_session(shape_buckets=BUCKETS)
    try:
        jwarm = jsess.warmup(feed_dict=batches[0])
        jsess._build_engine(batches[0], jsess._plan)     # the same plan
        jstats = jsess.compile_stats()
    finally:
        jsess.close()
    tsess, *_ = tparallax.parallel_run(
        tsimple.build_model(0.1), parallax_config=tparallax.Config(
            run_option="AR", shape_buckets=BUCKETS), device="cpu")
    twarm = tsess.warmup(feed_dict=batches[0])
    engine = tsess.engine
    tsess._build_engine(batches[0])
    assert tsess.engine is engine
    tstats = tsess.compile_stats()
    assert sorted(twarm) == sorted(jwarm) == BUCKETS
    assert tstats.keys() == jstats.keys()
    for k in ("executable_cache", "engine_cache"):
        assert tstats[k].keys() == jstats[k].keys()
    assert tstats["engine_cache"] == jstats["engine_cache"] == \
        {"hits": 1, "misses": 1}
    assert tstats["shape_buckets"] == jstats["shape_buckets"] == BUCKETS
    assert sorted(tstats["warmup_compile_seconds"]) == \
        sorted(jstats["warmup_compile_seconds"])
    assert tsess.warmup() == {}                      # idempotent
    snap = tsess.metrics.snapshot()
    assert snap["engine.compile_seconds"]["count"] == 2
    tsess.close()


def test_background_warmup_overlaps_and_lands():
    """``tests/test_compile.py``'s background case: a ``Thread`` comes
    back, both buckets land in ``warmup_seconds`` and no step after it
    recompiles; steps dispatched while the thread runs give losses
    bitwise equal to a foreground-warmed session's on the same
    batches."""
    import threading
    batches = _stream()
    losses = {}
    for background in (False, True):
        sess, *_ = tparallax.parallel_run(
            tsimple.build_model(0.1), parallax_config=tparallax.Config(
                run_option="AR", shape_buckets=BUCKETS), device="cpu")
        sess.prepare(batches[0])
        t = sess.warmup(background=background)
        if background:
            assert isinstance(t, threading.Thread)
        losses[background] = [sess.run("loss", feed_dict=b).item()
                              for b in batches]
        if background:
            t.join(timeout=120)
            assert not t.is_alive() and t.error is None
        assert sorted(sess.engine.warmup_seconds) == BUCKETS
        assert sess.metrics.counter("engine.recompiles").value == 0
        sess.run("loss", feed_dict=batches[2])
        assert sess.metrics.counter("engine.recompiles").value == 0
        assert sess.warmup() == {}
        sess.close()
    assert losses[True] == losses[False]


def test_engine_cache_counts_equal_jax():
    counts = []
    for mod, registry in ((tcache, MetricsRegistry()), (jcache, None)):
        c = mod.EngineCache(registry)
        a, b = object(), object()
        assert c.get(("p", 1)) is None
        c.put(("p", 1), a)
        c.put(("p", 2), b)
        assert c.get(("p", 1)) is a and c.get(("p", 2)) is b
        assert len(c) == 2 and c.prune(keep=a) == 1 and c.engines() == [a]
        counts.append((c._hits.value, c._misses.value))
    assert counts[0] == counts[1] == (2, 1)


def test_warmup_refusals():
    sess, *_ = tparallax.parallel_run(tsimple.build_model(0.1),
                                      device="cpu")
    with pytest.raises(ValueError, match="needs an engine"):
        sess.warmup()
    batch = _stream()[0]
    with pytest.raises(ValueError, match="shape_buckets"):
        sess.warmup(feed_dict=batch)
    # explicit sizes need no declared buckets
    assert sorted(sess.warmup(batch_sizes=[16, 64])) == [16, 64]
    sess.close()


def test_capture_switch_and_launch_counters():
    """Only a CUDA device captures, and not inside ``disable_capture``;
    the counters a graph replays are the wrappers' own."""
    from parallax_tpu_torch.ops import flash_attention as fa, lstm
    assert not tgraphs.capture_enabled("cpu")
    assert tgraphs.capture_enabled("cuda")
    with tgraphs.disable_capture():
        assert not tgraphs.capture_enabled("cuda")
        with tgraphs.disable_capture():
            pass
        assert not tgraphs.capture_enabled("cuda")
    assert tgraphs.capture_enabled("cuda")
    before = tgraphs.read_counters()
    assert len(before) == 8
    fa0, bwd0 = fa.launches, lstm.launches_bwd
    key = ("parallax_tpu_torch.ops.lstm", "launches_bwd")
    tgraphs.add_counters({key: 3})
    assert lstm.launches_bwd == bwd0 + 3 and fa.launches == fa0
    tgraphs.add_counters({key: -3})
    assert tgraphs.read_counters() == before


def test_persistent_cache_points_the_kernel_build(tmp_path):
    old = _cuda.BUILD_DIR
    try:
        assert tcache.enable_persistent_cache(str(tmp_path / "kern"))
        assert _cuda.BUILD_DIR == tmp_path / "kern"
        assert _cuda.library_path("lstm").parent == tmp_path / "kern"
        blocker = tmp_path / "file"
        blocker.write_text("")
        assert not tcache.enable_persistent_cache(str(blocker / "sub"))
        assert _cuda.BUILD_DIR == tmp_path / "kern"
    finally:
        _cuda.BUILD_DIR = old


# -- the static combine_slices ------------------------------------------------

V, D = 12, 3          # a table of 12 rows; 10 real, 2 of vocabulary padding
IDS = {
    "duplicates": [3, 1, 3, 7, 1, 3, 0, 9],
    "out_of_range": [3, -1, 12, 5, 40, 5, -7, 11],
    "all_dropped": [12, -1, 15, 12],
    "one": [4],
}


@pytest.mark.parametrize("average", [False, True], ids=["sum", "mean"])
@pytest.mark.parametrize("case", sorted(IDS))
def test_combine_slices_equals_jax(case, average):
    ids = np.asarray(IDS[case], np.int32)
    rows = np.random.default_rng(len(ids)).standard_normal(
        (len(ids), D)).astype(np.float32)
    juids, jsum = jso._combine_slices(jnp.asarray(ids), jnp.asarray(rows),
                                      V, jnp.float32, average, 0.5)
    tuids, tsum = tso.combine_slices(torch.from_numpy(ids),
                                     torch.from_numpy(rows), V, average, 0.5)
    np.testing.assert_array_equal(tuids.numpy(), np.asarray(juids))
    np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("average", [False, True], ids=["sum", "mean"])
@pytest.mark.parametrize("case", sorted(IDS))
def test_slice_adagrad_equals_jax_and_leaves_other_rows(case, average):
    rng = np.random.default_rng(7)
    ids = np.asarray(IDS[case], np.int32)
    rows = rng.standard_normal((len(ids), D)).astype(np.float32)
    param = rng.standard_normal((V, D)).astype(np.float32)
    param[10:] = [[0.0, -0.0, 1.5]] * 2           # the padded rows
    acc = np.full((V, D), 0.25, np.float32)
    jnew_p, jnew_acc = jso.SliceAdagrad(0.3, 0.25).update(
        jnp.asarray(param), jnp.asarray(acc), jnp.asarray(ids),
        jnp.asarray(rows), average)
    tp, tacc = torch.from_numpy(param.copy()), torch.from_numpy(acc.copy())
    tso.SliceAdagrad(0.3, 0.25).update(tp, tacc, torch.from_numpy(ids),
                                       torch.from_numpy(rows), average)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jnew_p), rtol=1e-6)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jnew_acc),
                               rtol=1e-6)
    named = {int(i) for i in ids if 0 <= i < V}
    others = [r for r in range(V) if r not in named]
    assert tp.numpy()[others].tobytes() == param[others].tobytes()
    assert tacc.numpy()[others].tobytes() == acc[others].tobytes()


# -- the in-place invariant and warmup on the CPU ---------------------------


def _storages(state):
    return [(t, t.data_ptr()) for t in tengine.state_tensors(state)]


def _nmt_session():
    cfg = tnmt.tiny_config(use_pallas_attention=True, warmup_steps=2)
    sess, *_ = tparallax.parallel_run(
        tnmt.build_model(cfg), parallax_config=tparallax.Config(
            run_option="HYBRID"), device="cpu")
    rng = np.random.default_rng(0)
    return sess, [tnmt.make_batch(rng, 4, 12, 10, cfg.vocab_size)
                  for _ in range(2)]


def _resnet_session():
    module = tresnet.ResNet(stage_sizes=[1, 1], num_filters=8,
                            num_classes=10, dtype=torch.float32)
    sess, *_ = tparallax.parallel_run(
        tcnn.module_model(module, 32), parallax_config=tparallax.Config(
            run_option="AR"), device="cpu")
    rng = np.random.default_rng(0)
    return sess, [tcnn.make_batch(rng, 4, 32, 10) for _ in range(2)]


@pytest.mark.parametrize("make", [_nmt_session, _resnet_session],
                         ids=["nmt", "resnet"])
def test_step_keeps_every_state_tensor_in_place(make):
    sess, batches = make()
    sess.prepare(batches[0])
    before = _storages(sess.state)
    opt_leaves = [t for t in tengine.state_tensors(sess.state)]
    for b in batches:
        sess.run("loss", feed_dict=b)
    after = _storages(sess.state)
    assert len(after) == len(before) == len(opt_leaves)
    for (t0, p0), (t1, p1) in zip(before, after):
        assert t0 is t1 and p0 == p1
    if make is _resnet_session:
        assert sess.state.model_state["batch_stats"]
    sess.close()


def test_cpu_warmup_leaves_the_state_bitwise_and_the_first_step_as_is():
    sess, batches = _nmt_session()
    sess.prepare(batches[0])
    before = [t.detach().clone() for t in tengine.state_tensors(sess.state)]
    stats = sess.warmup(batch_sizes=[4, 8])
    assert sorted(stats) == [4, 8]
    for t0, t1 in zip(before, tengine.state_tensors(sess.state)):
        assert torch.equal(t0, t1)
    cold, _ = _nmt_session()
    for b in batches:
        got = float(sess.run("loss", feed_dict=b))
        want = float(cold.run("loss", feed_dict=b))
        assert got == want
    for a, b in zip(tengine.state_tensors(sess.state),
                    tengine.state_tensors(cold.state)):
        assert torch.equal(a, b)
    assert sess.metrics.counter("engine.recompiles").value == 0
    sess.close()
    cold.close()
