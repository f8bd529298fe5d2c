"""The switch-MoE LM on the card: the captured training and decode steps
against eager ones.

* The MoE LM (8 experts, top-1, D 128, 2 heads, 2 layers, expert_dim
  256, vocab 1000, bf16) with the flash attention kernels, batch 4 x 256,
  trained 3 steps eagerly (``compile.disable_capture()``) and 3 as
  replays of the captured step from fresh sessions of one seed: losses,
  ``aux_loss`` and ``moe_dropped`` (0: one card runs the dense path) and
  every state tensor bitwise equal, and B4-B6 launched once a layer a
  step. Top-2 routing runs the same way.
* ``MoeLMDecodeProgram`` (paged, the B7 kernel) at the same widths: its
  captured decode step against the eager step on the same inserted
  requests, tokens and pools (less the spare page) bitwise equal.

Every test needs a CUDA card and skips without one; run them with
``python -m pytest --noconftest tests/test_torch_moe_gpu.py -m gpu``.
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


def _cfg(**kw):
    from parallax_tpu_torch.models import moe_lm
    return moe_lm.MoeLMConfig(vocab_size=1000, model_dim=128, num_heads=2,
                              expert_dim=256, num_experts=8, num_layers=2,
                              max_len=512, **kw)


@pytest.mark.parametrize("top_k", [1, 2])
def test_captured_moe_step_replays_bitwise_against_eager(cuda, top_k):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.compile import graphs
    from parallax_tpu_torch.core.engine import state_tensors
    from parallax_tpu_torch.models import moe_lm
    from parallax_tpu_torch.ops import flash_attention as fa
    cfg = _cfg(use_pallas_attention=True, top_k=top_k)
    rng = np.random.default_rng(0)
    batches = [moe_lm.make_batch(rng, 4, 256, cfg.vocab_size)
               for _ in range(3)]
    fetches = ["loss", "aux_loss", "moe_dropped"]
    runs = {}
    for mode in ("eager", "graph"):
        sess, *_ = pt.parallel_run(
            moe_lm.build_model(cfg), seed=0, device=cuda,
            parallax_config=pt.Config(run_option="HYBRID"))
        sess.prepare(batches[0])
        before = (fa.launches, fa.launches_dq, fa.launches_dkv)
        if mode == "eager":
            with graphs.disable_capture():
                outs = [[float(v) for v in sess.run(fetches, feed_dict=b)]
                        for b in batches]
        else:
            sess.warmup(batch_sizes=[4])
            before = (fa.launches, fa.launches_dq, fa.launches_dkv)
            outs = [[float(v) for v in sess.run(fetches, feed_dict=b)]
                    for b in batches]
        torch.cuda.synchronize()
        assert (fa.launches, fa.launches_dq, fa.launches_dkv) == tuple(
            n + 3 * cfg.num_layers for n in before)
        runs[mode] = (outs, [t.detach().clone()
                             for t in state_tensors(sess.state)])
        sess.close()
    (oe, se), (og, sg) = runs["eager"], runs["graph"]
    assert all(np.isfinite(o[0]) for o in oe) and oe == og
    assert all(o[2] == 0.0 for o in oe)
    for a, b in zip(se, sg):
        assert torch.equal(a, b)


def test_captured_moe_decode_step_matches_eager(cuda):
    from parallax_tpu_torch import serve
    from parallax_tpu_torch.models import moe_lm
    from parallax_tpu_torch.ops import paged_attention as pa
    cfg = _cfg()
    params = moe_lm.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in (5, 64, 33, 1)]
    results = {}
    for mode in ("eager", "graph"):
        prog = serve.MoeLMDecodeProgram(
            cfg, max_src_len=64, max_len=64, page_size=16, pool_pages=64,
            attn_impl="kernel", device=cuda)
        state = prog.init_state(params, 4)
        if mode == "graph":
            prog.capture(params, state)
            assert prog._graphs is not None
        pages = np.full((4, prog.pages_per_seq), prog.pool_pages, np.int32)
        for j, p in enumerate(prompts):
            feed = prog.prepare_feed({"ids": p})
            n = -(-(prog.kv_prefix_positions(feed) + 64) // 16)
            pages[j, :n] = 16 * j + np.arange(n)
            rs = prog.prefill(params, feed)
            prog.insert(state, j, rs, pages[j])
        tok = np.zeros((4,), np.int32)
        toks = []
        before = pa.launches
        for t in range(8):
            tok, state = prog.step(params, state, tok,
                                   np.full((4,), t, np.int32), pages)
            toks.append(tok.copy())
        torch.cuda.synchronize()
        assert pa.launches == before + 8 * cfg.num_layers
        # the spare page takes every sentinel write, duplicates in no set
        # order: it is never read, so the pools compare without it
        results[mode] = (np.stack(toks),
                         state["kc"][:, :prog.pool_pages].clone())
    np.testing.assert_array_equal(results["eager"][0], results["graph"][0])
    assert torch.equal(results["eager"][1], results["graph"][1])
