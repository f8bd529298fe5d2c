"""The port's input pipeline (``parallax_tpu_torch/data``) against the
JAX package's: the prefetcher's semantics, the native token loader (its
C++ source byte for byte, its batches over three epochs and two shards),
the numpy backend, NMT vocab, corpus and bucketed batches, and the
session's feed surface (``run_iter`` prefetched, ``placed=True``,
``skip=``, ``run_async``) against the sequential loop, bit for bit.
"""

import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import parallax_tpu_torch as tparallax
from parallax_tpu.data import loader as jloader
from parallax_tpu.data import nmt_data as jnmt_data
from parallax_tpu_torch.data import loader as tloader
from parallax_tpu_torch.data import nmt_data as tnmt_data
from parallax_tpu_torch.data import (Prefetcher, TokenDataset,
                                     prefetch_to_device, write_token_file)
from parallax_tpu_torch.data.prefetch import skip_items
from parallax_tpu_torch.models import lm1b as tlm1b
from parallax_tpu_torch.models import simple as tsimple

ROOT = Path(__file__).resolve().parent.parent
NMT_DATA = ROOT / "tests" / "data" / "nmt"
N_TOKENS = 10_000
B, T = 8, 9            # window = 10 tokens


# -- Prefetcher ---------------------------------------------------------------


def test_prefetcher_order_and_completeness():
    assert list(Prefetcher(iter(range(50)), lambda x: x * 2, depth=3)) == \
        [2 * i for i in range(50)]


def test_prefetcher_bounded_depth():
    placed = []

    def place(x):
        placed.append(x)
        return x

    p = Prefetcher(iter(range(100)), place, depth=2)
    time.sleep(0.3)
    # depth finished items queued + one in the worker's hand
    assert len(placed) <= 3
    assert next(p) == 0
    p.close()


@pytest.mark.parametrize("where", ["source", "place_fn"])
def test_prefetcher_error_surfaces_at_its_item(where):
    def source():
        for i in range(5):
            if where == "source" and i == 3:
                raise RuntimeError("boom at 3")
            yield i

    def place(x):
        if where == "place_fn" and x == 3:
            raise RuntimeError("boom at 3")
        return x

    p = Prefetcher(source(), place, depth=2)
    assert [next(p), next(p), next(p)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="boom at 3"):
        next(p)
    with pytest.raises(StopIteration):
        next(p)


def test_prefetcher_close_stops_worker_promptly():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    p = Prefetcher(endless(), None, depth=2)
    next(p)
    t0 = time.perf_counter()
    p.close()
    assert time.perf_counter() - t0 < 2.0
    assert not p.alive
    with pytest.raises(StopIteration):
        next(p)


def test_prefetcher_close_drops_every_placed_item():
    """``close()`` with the queue full and the worker blocked putting one
    more: no placed item stays referenced (on the card a placed batch
    holds a staging slot until it is dropped)."""
    import weakref

    class Item:
        pass

    made = []

    def place(x):
        item = Item()
        made.append(weakref.ref(item))
        return item

    p = Prefetcher(iter(range(100)), place, depth=2)
    deadline = time.monotonic() + 5
    while len(made) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)            # the worker now waits to put the third
    p.close()
    assert not p.alive
    assert len(made) >= 3 and all(r() is None for r in made)


def test_skip_items_and_prefetcher_skip():
    assert list(skip_items(iter(range(10)), 4)) == [4, 5, 6, 7, 8, 9]
    with pytest.raises(ValueError, match="cursor"):
        skip_items(iter(range(3)), 5)
    assert list(Prefetcher(iter(range(6)), lambda x: x * 10, skip=2)) == \
        [20, 30, 40, 50]
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter(()), depth=0)


def test_prefetch_to_device_places_each_item():
    out = prefetch_to_device(iter(range(5)), lambda x: -x, depth=1)
    assert list(out) == [0, -1, -2, -3, -4]
    assert out.alive is False or out.close() is None


# -- the token loader ---------------------------------------------------------


def test_dataloader_source_is_the_jax_packages_byte_for_byte():
    assert tloader.SOURCE.read_bytes() == \
        (ROOT / "parallax_tpu" / "data" / "cpp" / "dataloader.cc").read_bytes()


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokens") / "tokens.bin")
    # a Zipf stream, as examples/lm1b_driver.py's synthetic feed
    tokens = np.random.default_rng(3).zipf(1.3, N_TOKENS) % 1000
    write_token_file(path, tokens)
    return path


def _batches(ds, n):
    out = []
    for _ in range(n):
        b = ds.next_batch()
        out.append(({k: np.array(v) for k, v in b.items()}, ds.epoch))
    return out


@pytest.mark.parametrize("shard_id", [0, 1])
def test_native_batches_match_jax_native_over_three_epochs(token_file,
                                                           shard_id):
    if tloader._native_lib() is None or jloader._native_lib() is None:
        pytest.fail("the native loader did not build (g++ missing?)")
    per_epoch = (N_TOKENS // (T + 1)) // 2 // B
    n = 3 * per_epoch + 1
    t = TokenDataset(token_file, B, T, num_shards=2, shard_id=shard_id,
                     seed=11)
    j = jloader.TokenDataset(token_file, B, T, num_shards=2,
                             shard_id=shard_id, seed=11)
    assert t.backend == j.backend == "native"
    assert t.num_tokens == j.num_tokens == N_TOKENS
    got, want = _batches(t, n), _batches(j, n)
    t.close()
    j.close()
    assert [e for _, e in got] == [e for _, e in want]
    assert got[-1][1] == 3
    for (a, _), (b, _) in zip(got, want):
        assert set(a) == set(b) == {"x", "y", "w"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_numpy_backend_matches_jax_numpy_backend(token_file, monkeypatch):
    monkeypatch.setenv("PARALLAX_DATA_BACKEND", "numpy")
    for mod in (tloader, jloader):
        monkeypatch.setattr(mod, "_lib_tried", False)
        monkeypatch.setattr(mod, "_lib", None)
    n = 2 * ((N_TOKENS // (T + 1)) // B) + 3
    t = TokenDataset(token_file, B, T, seed=5)
    j = jloader.TokenDataset(token_file, B, T, seed=5)
    assert t.backend == j.backend == "numpy"
    for (a, ea), (b, eb) in zip(_batches(t, n), _batches(j, n)):
        assert ea == eb
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_native_library_is_built_under_build_dir():
    if tloader._native_lib() is None:
        pytest.fail("the native loader did not build")
    path = tloader.library_path()
    assert path.exists()
    assert path.parent.name == "parallax_tpu_torch"
    assert path.parent.parent.name == "build"


def test_not_enough_data_raises(tmp_path):
    path = str(tmp_path / "few.bin")
    write_token_file(path, np.arange(30))
    with pytest.raises(ValueError, match="not enough tokens"):
        TokenDataset(path, 8, 9)


# -- NMT data -----------------------------------------------------------------


def test_vocab_matches_jax():
    path = str(NMT_DATA / "vocab.txt")
    t, j = tnmt_data.Vocab.load(path), jnmt_data.Vocab.load(path)
    assert t.id_to_token == j.id_to_token
    for text in ("a b zzz j", "c h d c h g g", ""):
        assert t.encode(text) == j.encode(text)
    ids = t.encode("a b zzz j") + [tnmt_data.EOS_ID, 9]
    assert t.decode(ids) == j.decode(ids) == ["a", "b", "<unk>", "j"]
    assert tnmt_data.Vocab(["x", "y"]).id_to_token == \
        jnmt_data.Vocab(["x", "y"]).id_to_token
    assert (tnmt_data.PAD_ID, tnmt_data.BOS_ID, tnmt_data.EOS_ID,
            tnmt_data.UNK_ID) == (jnmt_data.PAD_ID, jnmt_data.BOS_ID,
                                  jnmt_data.EOS_ID, jnmt_data.UNK_ID)


def _pairs(mod, max_len=16):
    v = mod.Vocab.load(str(NMT_DATA / "vocab.txt"))
    return mod.load_parallel_corpus(str(NMT_DATA / "train.src"),
                                    str(NMT_DATA / "train.tgt"), v,
                                    max_len=max_len)


@pytest.mark.parametrize("max_len", [16, 4])
def test_load_parallel_corpus_matches_jax(max_len):
    t, j = _pairs(tnmt_data, max_len), _pairs(jnmt_data, max_len)
    assert t == j and len(t) > 0


def test_corpus_line_count_mismatch_raises(tmp_path):
    (tmp_path / "a").write_text("a b\nc\n")
    (tmp_path / "b").write_text("a b\n")
    v = tnmt_data.Vocab(["a", "b", "c"])
    with pytest.raises(ValueError, match="line-count mismatch"):
        tnmt_data.load_parallel_corpus(str(tmp_path / "a"),
                                       str(tmp_path / "b"), v, 8)


@pytest.mark.parametrize("shards,drop", [(1, True), (1, False), (2, True),
                                         (2, False)])
def test_nmt_batches_match_jax(shards, drop):
    pairs = _pairs(tnmt_data)
    for epoch in (0, 1):
        for shard in range(shards):
            kw = dict(batch_size=8, max_len=16, bucket_width=4,
                      num_shards=shards, shard_index=shard, seed=3,
                      drop_remainder=drop)
            got = list(tnmt_data.NMTBatchIterator(pairs, **kw).epoch(epoch))
            want = list(jnmt_data.NMTBatchIterator(pairs, **kw).epoch(epoch))
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert set(a) == set(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
            if not drop:
                # the ragged tails are padded with zero-weight rows
                assert any((b["w"].sum(axis=1) == 0).any() for b in got)


# -- the session's feed surface ----------------------------------------------


def _lm1b_session(**cfg_kw):
    cfg = tlm1b.tiny_config(keep_prob=1.0, sparse_grad_mode="slices",
                            compute_dtype=torch.float32, lstm_impl="kernel")
    sess, *_ = tparallax.parallel_run(
        tlm1b.build_model(cfg), parallax_config=tparallax.Config(
            run_option="HYBRID", sparse_grad_mode="slices", **cfg_kw),
        seed=1, device="cpu")
    return sess


@pytest.fixture(scope="module")
def lm1b_stream(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm1b") / "tokens.bin")
    write_token_file(path, np.random.default_rng(0).zipf(1.3, 4000) % 1000)

    def batches(n):
        ds = TokenDataset(path, 8, 6, seed=2)
        out = [ds.next_batch() for _ in range(n)]
        ds.close()
        return out

    return batches


def _sequential(batches, **cfg_kw):
    sess = _lm1b_session(**cfg_kw)
    losses = [float(sess.run("loss", feed_dict=b)) for b in batches]
    sess.close()
    return losses


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_run_iter_prefetched_equals_sequential(lm1b_stream, depth):
    batches = lm1b_stream(6)
    want = _sequential(batches)
    sess = _lm1b_session(prefetch_depth=depth)
    got = [float(x) for x in sess.run_iter(iter(batches), fetches="loss")]
    assert got == want
    assert sess.data_cursor == 6
    assert sess.metrics.histogram("session.data_wait_ms").count == 6
    sess.close()


def test_run_iter_placed_equals_sequential(lm1b_stream):
    batches = lm1b_stream(6)
    want = _sequential(batches)
    sess = _lm1b_session()
    with prefetch_to_device(iter(batches), sess.place_batch) as placed:
        got = [float(x) for x in sess.run_iter(placed, fetches="loss",
                                               placed=True)]
    assert got == want
    sess.close()


def test_run_iter_skip_equals_sequential_tail(lm1b_stream):
    batches = lm1b_stream(6)
    sess = _lm1b_session()
    sess.prepare(batches[0])
    got = [float(x) for x in sess.run_iter(iter(batches), fetches="loss",
                                           skip=2)]
    sess.close()
    want = _sequential(batches[2:])
    assert got == want
    with pytest.raises(ValueError, match="cursor"):
        _lm1b_session().run_iter(iter(batches), skip=9)


def test_run_iter_skip_auto_before_engine_refuses():
    sess = _lm1b_session()
    with pytest.raises(ValueError, match="prepare"):
        sess.run_iter(iter([]), fetches="loss", skip="auto")
    sess.close()


def test_run_async_and_eager_fetch_equal_sequential(lm1b_stream):
    batches = lm1b_stream(4)
    want = _sequential(batches)
    sess = _lm1b_session()
    handles = [sess.run_async("loss", feed_dict=b) for b in batches]
    assert [h.result() for h in handles] == want
    assert all(h.done() for h in handles)
    sess.close()
    sess = _lm1b_session(eager_fetch=True)
    out = [sess.run("loss", feed_dict=b) for b in batches]
    assert all(isinstance(x, float) for x in out) and out == want
    sess.close()


def test_run_iter_errors_surface_and_close_stops_thread():
    def feed():
        rng = np.random.default_rng(0)
        for i in range(5):
            if i == 3:
                raise RuntimeError("feed broke at 3")
            yield tsimple.make_batch(rng, 16)

    sess, *_ = tparallax.parallel_run(tsimple.build_model(0.1),
                                      device="cpu")
    it = sess.run_iter(feed(), fetches="loss")
    assert len([next(it) for _ in range(3)]) == 3
    with pytest.raises(RuntimeError, match="feed broke at 3"):
        next(it)
    rng = np.random.default_rng(1)
    it = sess.run_iter((tsimple.make_batch(rng, 16) for _ in range(100)),
                       fetches="loss")
    next(it)
    worker = sess._prefetcher._thread
    sess.close()
    worker.join(5.0)
    assert not worker.is_alive()
    assert threading.active_count() >= 1


def test_prefetch_depth_validated():
    with pytest.raises(ValueError, match="prefetch_depth"):
        tparallax.Config(prefetch_depth=0)
    assert os.path.isdir(NMT_DATA)


def test_staging_ring_grows_instead_of_blocking(lm1b_stream):
    """More staged batches held unstepped than the ring has slots (a list
    of ``place_batch`` results, ``prefetch_to_device`` deeper than
    ``prefetch_depth``) take new slots instead of waiting for one that
    only a later step would free; freed slots are reused round robin, and
    a staged batch dropped unread frees its slot."""
    from parallax_tpu_torch.core.engine import StagedBatch
    sess = _lm1b_session()
    sess.prepare(lm1b_stream(1)[0])
    engine = sess.engine
    held = [engine._take_slot() for _ in range(7)]
    assert len(engine._stage_slots) == 7 and len(set(map(id, held))) == 7
    for slot in held[:2]:
        slot.free.set()                   # their steps were dispatched
    again = [engine._take_slot() for _ in range(2)]
    assert [id(x) for x in again] == [id(x) for x in held[:2]]
    assert len(engine._stage_slots) == 7
    assert engine._take_slot() not in held  # all 7 busy: an eighth
    assert len(engine._stage_slots) == 8
    staged = StagedBatch({}, None, held[3])
    del staged                            # dropped unread
    assert held[3].free.is_set()
    sess.close()


def test_nmt_length_buckets_count_as_recompiles_once_each():
    """An ``NMTBatchIterator`` epoch (length buckets 8 and 16, ragged tails
    padded with zero-weight rows) through NMT tiny with ``shape_buckets``:
    the declared buckets size the batch dimension only, so each length
    bucket after the first counts one ``engine.recompiles`` at its first
    sight, as in the JAX package, and a second epoch counts none."""
    from parallax_tpu_torch.models import nmt as tnmt
    pairs = _pairs(tnmt_data)
    batches = list(tnmt_data.NMTBatchIterator(
        pairs, batch_size=8, max_len=16, bucket_width=8, seed=0,
        drop_remainder=False).epoch(0))
    assert sorted({b["src"].shape[1] for b in batches}) == [8, 16]
    sess, *_ = tparallax.parallel_run(
        tnmt.build_model(tnmt.tiny_config()),
        parallax_config=tparallax.Config(run_option="HYBRID",
                                         shape_buckets=[8]),
        seed=0, device="cpu")
    sess.prepare(batches[0])
    sess.warmup()
    recompiles = sess.metrics.counter("engine.recompiles")
    losses = []
    for epoch in range(2):
        losses += [float(sess.run("loss", feed_dict=b)) for b in batches]
        assert recompiles.value == 1, epoch
    sess.close()
    assert all(np.isfinite(losses))
