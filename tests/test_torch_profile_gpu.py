"""The profile window on the card: ``torch.profiler`` over replayed CUDA
graphs, and a window armed over a capture.

A small LM1B (fp32, ``lstm_impl="kernel"``: B2 as the persistent fp32
forward of ``csrc/lstm_f32_sm90.cu``, ``lstm_fwd_kernel_tf32x3``, one
launch a step, and B3 as the first kernel of ``csrc/lstm.cu``,
``lstm_bwd_cell_kernel`` one launch a time step) trains on the card,
each step a replay of its captured graph.

* A window over replayed steps (a warm-up step, then the traced ones)
  holds every replayed kernel of its traced steps: B2's once a step and
  B3's once a time step and step, the launch counters' count less the
  warm-up step's; the attribution reads the device track and joins kernels to
  their scopes (the sparse path's time is above 0).
* A window armed before the first step, which captures the graph, is
  deferred one step: the capture succeeds (the steps after it replay),
  and the window still covers its length in replays after its warm-up.
* ``tune_config`` on one card: the search trials AR's tp 1 plan (its
  OOM preflight captures the candidate on a fresh state, left bitwise as
  ``init_state`` made it) and settles.

Every test needs a CUDA card and skips without one; run them with
``python -m pytest --noconftest tests/test_torch_profile_gpu.py -m gpu``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

T, B = 5, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _session(cuda, **cfg):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import lm1b
    mcfg = lm1b.tiny_config(compute_dtype=torch.float32, lstm_impl="kernel",
                            sparse_grad_mode="slices")
    sess, *_ = pt.parallel_run(lm1b.build_model(mcfg), parallax_config=pt.
                               Config(run_option="HYBRID",
                                      sparse_grad_mode="slices", **cfg),
                               device=cuda)
    rng = np.random.default_rng(0)
    feeds = [lm1b.make_batch(rng, B, T, mcfg.vocab_size) for _ in range(3)]
    return sess, feeds


def _kernels(outdir):
    from parallax_tpu_torch.obs import xprof
    doc, _ = xprof.load_trace(outdir)
    return xprof.kernel_counts(doc)


def _count(kernels, name):
    return sum(n for k, n in kernels.items() if name in k)


def test_a_replayed_window_holds_the_kernels(cuda):
    from parallax_tpu_torch.ops import lstm
    sess, feeds = _session(cuda)
    try:
        sess.prepare(feeds[0])
        sess.warmup(batch_sizes=[B])
        sess.run("loss", feed_dict=feeds[0])
        steps = 3
        outdir = sess.profile_steps(steps)
        before = lstm.launches_fwd_res, lstm.launches_bwd
        for i in range(steps + 1):              # the warm-up, then 3
            sess.run("loss", feed_dict=feeds[i % 3])
        assert (lstm.launches_fwd_res - before[0],
                lstm.launches_bwd - before[1]) == (steps + 1, steps + 1)
        kernels = _kernels(outdir)
        assert _count(kernels, "lstm_fwd_kernel_tf32x3") == steps
        assert _count(kernels, "lstm_bwd_cell_kernel") == steps * T
        a = sess.profile_summary()
        assert a["track_basis"] == "device" and a["steps"] == steps
        assert a["coverage"] is not None and a["coverage"] > 0
        assert a["dense_sparse"]["sparse_self_ms"] > 0
        assert sess._profile.deferred_steps == 0
    finally:
        sess.close()


def test_a_window_over_a_capture_is_deferred(cuda):
    sess, feeds = _session(cuda)
    try:
        sess.prepare(feeds[0])
        assert not sess.engine.captured_graphs()
        outdir = sess.profile_steps(2)          # step 0 will capture
        for i in range(4):              # capture, warm-up, two traced
            sess.run("loss", feed_dict=feeds[i % 3])
        assert len(sess.engine.captured_graphs()) == 1
        assert sess.metrics.counter(
            "engine.executable_cache.hits").value == 3
        assert sess._profile.deferred_steps == 1
        assert _count(_kernels(outdir), "lstm_fwd_kernel_tf32x3") == 2
        assert sess.profile_summary()["steps"] == 2
    finally:
        sess.close()


def test_one_card_search_preflights_and_settles(cuda):
    import parallax_tpu_torch as pt
    sess, feeds = _session(cuda, tune_config=pt.TuneConfig(
        trial_steps=3, trial_warmup=1))
    try:
        sess.prepare(feeds[0])
        assert sess.plan.describe() == "dp1xtp1/AR"
        # the preflight's capture left the state as init_state made it
        fresh = sess.engine.init_state(0)
        from parallax_tpu_torch.core import engine as engine_lib
        for x, y in zip(engine_lib.state_tensors(sess.state),
                        engine_lib.state_tensors(fresh)):
            assert torch.equal(x, y)
        assert sess.engine.captured_graphs()
        for i in range(4):
            sess.run("loss", feed_dict=feeds[i % 3])
        s = sess.tune_summary()
        assert s["winner"]["plan"] == "dp1xtp1/AR"
        assert s["hbm_budget_bytes"] == torch.cuda.mem_get_info()[1]
        assert s["preflight_checked"] == 1 and s["pruned_oom"] == 0
        assert s["cost_basis"] == "device-peak" or \
            s["cost_basis"].startswith("nominal")
    finally:
        sess.close()
