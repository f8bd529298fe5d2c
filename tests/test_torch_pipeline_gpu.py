"""The pipeline schedules and skip-thoughts on the card: captured steps
against eager ones.

* A model whose stages are ``ops.pipeline``'s (two chunks of a tanh
  layer, D 256, bf16 activations, fp32 parameters and head) on a
  one-rank mesh (S 1, M 4, V 2), trained 3 steps eagerly
  (``compile.disable_capture()``) and 3 as replays of the captured step
  from fresh sessions of one seed: under 1F1B
  (``pipeline_value_and_grad`` as ``Model.value_and_grad_fn``) and under
  GPipe (``pipeline_apply`` through autograd), losses and every state
  tensor bitwise equal; the two schedules' losses within 1e-2 relative
  of each other (one computes in another order).
* Skip-thoughts (vocab 1000, E 64, H 128, bf16) at batch 8 x 10: the
  same, losses, ``words`` and every state tensor bitwise equal.

Every test needs a CUDA card and skips without one; run them with
``python -m pytest --noconftest tests/test_torch_pipeline_gpu.py -m gpu``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

D, M, V, B = 256, 4, 2, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pipe_model(schedule):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.core import optim
    from parallax_tpu_torch.ops import collectives, pipeline as pp

    def init_fn(gen, device):
        def normal(*shape):
            return (torch.randn(shape, generator=gen, device=gen.device)
                    * 0.05).to(device)
        return {"stages": {"w": normal(V, D, D), "b": normal(V, D)},
                "head": {"w": normal(D, D)}}

    def stage(p, x):
        return torch.tanh(x @ p["w"].to(x.dtype) + p["b"].to(x.dtype))

    def mb_loss(head, out, y):
        return ((out.float() @ head["w"] - y["y"]) ** 2).mean()

    def loss_fn(params, batch):
        out = pp.pipeline_apply(stage, params["stages"],
                                batch["x"].to(torch.bfloat16),
                                collectives.current_mesh(), M, V)
        return mb_loss(params["head"], out, batch)

    def vag(params, batch, gen):
        loss, (gs, gh, _) = pp.pipeline_value_and_grad(
            stage, mb_loss, params["stages"], batch["x"].to(torch.bfloat16),
            {"y": batch["y"]}, collectives.current_mesh(), M,
            head_params=params["head"], virtual_stages=V)
        return loss, {}, {"stages": gs, "head": gh}

    return pt.Model(init_fn, loss_fn, optimizer=optim.sgd(0.1),
                    value_and_grad_fn=vag if schedule == "1f1b" else None)


def _eager_and_graph(cuda, build, batches, fetches, batch_size):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.compile import graphs
    from parallax_tpu_torch.core.engine import state_tensors
    runs = {}
    for mode in ("eager", "graph"):
        sess, *_ = pt.parallel_run(build(), seed=0, device=cuda)
        sess.prepare(batches[0])
        if mode == "eager":
            with graphs.disable_capture():
                outs = [[float(v) for v in sess.run(fetches, feed_dict=b)]
                        for b in batches]
        else:
            sess.warmup(batch_sizes=[batch_size])
            outs = [[float(v) for v in sess.run(fetches, feed_dict=b)]
                    for b in batches]
            assert sess.compile_stats()["executable_cache"]["hits"] == 3
        torch.cuda.synchronize()
        runs[mode] = (outs, [t.detach().clone()
                             for t in state_tensors(sess.state)])
        sess.close()
    (oe, se), (og, sg) = runs["eager"], runs["graph"]
    assert all(np.isfinite(o[0]) for o in oe) and oe == og
    for a, b in zip(se, sg):
        assert torch.equal(a, b)
    return oe


def test_captured_pipeline_steps_replay_bitwise_against_eager(cuda):
    rng = np.random.default_rng(0)
    batches = [{"x": rng.standard_normal((B, D)).astype(np.float32),
                "y": rng.standard_normal((B, D)).astype(np.float32)}
               for _ in range(3)]
    losses = {s: _eager_and_graph(cuda, lambda s=s: _pipe_model(s), batches,
                                  ["loss"], B)
              for s in ("1f1b", "gpipe")}
    np.testing.assert_allclose(losses["1f1b"], losses["gpipe"], rtol=1e-2)


def test_captured_skip_thoughts_step_replays_bitwise_against_eager(cuda):
    from parallax_tpu_torch.models import skip_thoughts as st
    cfg = st.SkipThoughtsConfig(vocab_size=1000, emb_dim=64, hidden_dim=128)
    rng = np.random.default_rng(0)
    batches = [st.make_batch(rng, 8, 10, cfg.vocab_size) for _ in range(3)]
    outs = _eager_and_graph(cuda, lambda: st.build_model(cfg), batches,
                            ["loss", "words"], 8)
    assert [o[1] for o in outs] == [160.0] * 3
