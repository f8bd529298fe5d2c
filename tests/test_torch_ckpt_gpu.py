"""Checkpoints, rollback and prefetch on the card, under captured step
graphs.

LM1B tiny (slices, fp32, dropout on, ``lstm_impl="kernel"``: the LSTM
kernels B2 and B3 in every step) on the card:

* a checkpoint restored into a warmed session whose graphs are already
  captured (the restore copies into the tensors the graphs read), then
  four steps: the losses equal, bit for bit, an eager session's
  (``compile.disable_capture()``) restored from the same checkpoint;
* a NaN batch rolled back under captured graphs (recovery, snapshot
  every 2 steps, the NaN at step 4): the losses that follow equal, bit
  for bit, an eager run that never saw the batch;
* ``run_iter`` at prefetch depth 2 (staging ring, side-stream copies,
  the static inputs) against the sequential ``run`` loop: bitwise equal,
  captured both;
* BERT tiny prefetched (unfetched metrics freed on the step's stream
  beside the staging buffers) against the sequential loop, bitwise;
* placed batches dropped unread free their staging slots;
* a bfloat16 leaf through the store and through the async hook's pinned
  snapshot, bit for bit.

Every test needs a CUDA card and skips without one; run them with
``python -m pytest --noconftest tests/test_torch_ckpt_gpu.py -m gpu``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _session(cuda, **cfg_kw):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import lm1b
    cfg = lm1b.tiny_config(sparse_grad_mode="slices", lstm_impl="kernel",
                           compute_dtype=torch.float32)
    sess, *_ = pt.parallel_run(
        lm1b.build_model(cfg), parallax_config=pt.Config(
            run_option="HYBRID", sparse_grad_mode="slices", **cfg_kw),
        seed=2, device=cuda)
    return sess


def _batches(n, nan_at=None):
    from parallax_tpu_torch.models import lm1b
    rng = np.random.default_rng(0)
    out = [lm1b.make_batch(rng, 16, 6, 1000) for _ in range(n)]
    if nan_at is not None:
        out[nan_at] = dict(out[nan_at], w=out[nan_at]["w"] * np.nan)
    return out


def _losses(sess, batches):
    return [float(sess.run("loss", feed_dict=b)) for b in batches]


def test_restore_into_captured_session_replays_bitwise(cuda, tmp_path):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch import compile as compile_lib
    from parallax_tpu_torch.ckpt import CheckpointStore
    batches = _batches(8)
    ck = str(tmp_path / "ck")
    a = _session(cuda, ckpt_config=pt.CheckPointConfig(ckpt_dir=ck,
                                                       save_ckpt_steps=4))
    _losses(a, batches[:4])
    a.close()
    b = _session(cuda)
    b.prepare(batches[0])
    b.warmup(batch_sizes=[16])
    _losses(b, batches[:2])              # the graph runs on b's state
    graph_state = b.engine._captured_state
    CheckpointStore(ck).restore_latest(b._state_leaves())
    assert b.state.step == 4 and b.engine._captured_state is graph_state
    captured = _losses(b, batches[4:])
    assert b.metrics.counter("engine.executable_cache.hits").value >= 4
    b.close()
    with compile_lib.disable_capture():
        c = _session(cuda, ckpt_config=pt.CheckPointConfig(
            ckpt_dir=ck, save_ckpt_steps=100))
        assert c.prepare(batches[0]) == 4
        eager = _losses(c, batches[4:])
        c.close()
    assert captured == eager


def test_rollback_under_captured_graphs_equals_run_without_batch(cuda):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch import compile as compile_lib
    batches = _batches(9, nan_at=4)
    s = _session(cuda, recovery_config=pt.RecoveryConfig(
        enabled=True, snapshot_every_steps=2))
    calls = []
    s.set_rollback_hook(calls.append)
    s.prepare(batches[0])
    s.warmup(batch_sizes=[16])
    got = _losses(s, batches)
    assert calls == [1] and s.state.step == 8 and s.data_cursor == 9
    s.close()
    with compile_lib.disable_capture():
        e = _session(cuda)
        want = _losses(e, batches[:4] + batches[5:])
        e.close()
    assert got[:4] + got[5:] == want


def test_prefetch_depth_two_equals_sequential_captured(cuda):
    batches = _batches(8)
    s = _session(cuda)
    want = _losses(s, batches)
    s.close()
    p = _session(cuda, prefetch_depth=2)
    got = [float(x) for x in p.run_iter(iter(batches), fetches="loss")]
    assert len(p.engine._stage_slots) <= 4    # depth + 2 at most
    p.close()
    assert got == want


def test_prefetch_with_unfetched_metrics_equals_sequential(cuda):
    """BERT tiny, its loss gathering by the masked-position feed: the
    outputs a step does not fetch are freed at once on the step's stream,
    while their copies may still be pending there. Staging buffers
    allocated on that stream could reuse such a block and be overwritten
    after their copy from the host; allocated on the staging stream they
    cannot. Losses bitwise equal to the sequential loop, captured."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import bert
    cfg = bert.tiny_config(num_partitions=1)
    rng = np.random.default_rng(0)
    batches = [bert.make_batch(rng, 8, 32, 5, cfg.vocab_size)
               for _ in range(12)]
    losses = {}
    for depth in (None, 2):
        sess, *_ = pt.parallel_run(
            bert.build_model(cfg), parallax_config=pt.Config(
                run_option="HYBRID", prefetch_depth=depth or 2),
            seed=0, device=cuda)
        sess.prepare(batches[0])
        sess.warmup(batch_sizes=[8])
        losses[depth] = (
            [float(sess.run("loss", feed_dict=b)) for b in batches]
            if depth is None else
            [float(x) for x in sess.run_iter(iter(batches), "loss")])
        sess.close()
    assert losses[2] == losses[None]
    assert all(np.isfinite(losses[2]))


def test_placed_batches_dropped_unread_free_their_slots(cuda):
    """A ``prefetch_to_device`` pipeline closed with placed batches still
    queued: the next ``run_iter`` stages into the same ring without
    waiting on them."""
    import threading
    from parallax_tpu_torch.data import prefetch_to_device
    batches = _batches(12)
    s = _session(cuda, prefetch_depth=2)
    with prefetch_to_device(iter(batches), s.place_batch, depth=2) as placed:
        for _ in zip(range(2), s.run_iter(placed, "loss", placed=True)):
            pass
    out = []
    t = threading.Thread(target=lambda: out.extend(
        float(x) for x in s.run_iter(iter(batches[:6]), "loss")))
    t.start()
    t.join(120)
    assert not t.is_alive() and len(out) == 6
    s.close()


def test_bf16_leaf_round_trip(cuda, tmp_path):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.ckpt import CheckpointHook, CheckpointStore
    w = torch.randn(33, 17, device=cuda).to(torch.bfloat16)
    store = CheckpointStore(str(tmp_path / "s"))
    store.save(1, {"w": w, "n": torch.arange(5, device=cuda)})
    into = {"w": torch.zeros_like(w), "n": torch.zeros(5, dtype=torch.long,
                                                       device=cuda)}
    store.restore(1, into)
    assert torch.equal(into["w"].view(torch.int16), w.view(torch.int16))
    assert store.read_manifest(1)["leaves"]["w"]["dtype"] == "bfloat16"
    hook = CheckpointHook(pt.CheckPointConfig(
        ckpt_dir=str(tmp_path / "h"), save_ckpt_steps=1, async_save=True),
        worker_id=0)
    w0 = w.clone()
    hook.maybe_save(1, {"w": w})
    w.add_(1)          # ordered after the snapshot's copy on the stream
    hook.maybe_save(2, {"w": w})
    hook.close()
    got = {"w": torch.zeros_like(w)}
    CheckpointStore(str(tmp_path / "h")).restore(2, got)
    assert torch.equal(got["w"], w)
    CheckpointStore(str(tmp_path / "h")).restore(1, got)
    assert torch.equal(got["w"], w0)
