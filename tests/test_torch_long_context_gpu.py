"""The long-context LM on the card: B4-B6 at the ``lc-train`` attention
shape, and the captured training and decode steps against eager ones.

* The bf16 flash forward (B4), dq (B5) and dk/dv (B6) through
  ``flash_attention_lse`` at B 8, T 8192, 8 heads of 64, causal, with a
  nonzero lse cotangent (the ring's merge differentiates through lse):
  the kernels run on all 8 rows and are held to the plain versions on 4
  of them (the plain [T, T] scores of 8 rows would take 17 GB each)
  within 2e-2 of the plain result's peak; each counter advances by one a
  call. The backward kernels and the plain versions take the kernel
  forward's out and lse.
* The default ring model (one block on one card) at hd 64, 2 layers,
  D 128, batch 2 x 512, bf16, trained 3 steps eagerly
  (``compile.disable_capture()``) and 3 as replays of the captured step
  from fresh sessions of one seed: losses and every state tensor bitwise
  equal, and B4-B6 launched once a layer a step.
* ``CausalLMDecodeProgram`` (paged, the B7 kernel) at the same widths:
  its captured decode step against the eager step on the same inserted
  requests, tokens and pools (less the spare page) bitwise equal.

Every test needs a CUDA card and skips without one; run them with
``python -m pytest --noconftest tests/test_torch_long_context_gpu.py -m
gpu``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

BF16_REL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    peak = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_REL * max(peak, 1e-6), (err, peak)
    assert bool(torch.isfinite(got.float()).all())


def test_flash_kernels_at_the_lc_train_shape(cuda):
    from parallax_tpu_torch.ops import flash_attention as fa
    B, T, H, hd, rows = 8, 8192, 8, 64, 4
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, dout = (torch.randn((B, T, H, hd), generator=g, device=cuda,
                                 dtype=torch.bfloat16) for _ in range(4))
    dlse = torch.randn((B, H, T), generator=g, device=cuda)
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    sub = [t[:rows] for t in (q, k, v, dout)]
    ref, ref_lse = fa.flash_attention_plain(*sub[:3], causal=True)
    _close(out[:rows], ref)
    assert (lse[:rows] - ref_lse).abs().max().item() <= \
        1e-2 * max(ref_lse.abs().max().item(), 1.0)
    del ref, ref_lse
    delta = fa.flash_delta(out, dout, dlse)
    args = (q, k, v, None, dout, lse, delta, True, hd ** -0.5)
    dq = fa.flash_dq(*args)
    dk, dv = fa.flash_dkv(*args)
    torch.cuda.synchronize()
    plain = (sub[0], sub[1], sub[2], None, sub[3], lse[:rows].contiguous(),
             delta[:rows].contiguous(), True, hd ** -0.5)
    _close(dq[:rows], fa.flash_dq_plain(*plain))
    for got, want in zip((dk, dv), fa.flash_dkv_plain(*plain)):
        _close(got[:rows], want)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == tuple(
        n + 1 for n in before)


def _cfg(**kw):
    from parallax_tpu_torch.models import long_context as lc
    return lc.LongContextConfig(vocab_size=1000, model_dim=128, num_heads=2,
                                mlp_dim=256, num_layers=2, max_len=1024,
                                **kw)


def test_captured_ring_step_replays_bitwise_against_eager(cuda):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.compile import graphs
    from parallax_tpu_torch.core.engine import state_tensors
    from parallax_tpu_torch.models import long_context as lc
    from parallax_tpu_torch.ops import flash_attention as fa
    cfg = _cfg()
    rng = np.random.default_rng(0)
    batches = [lc.make_batch(rng, 2, 512, cfg.vocab_size) for _ in range(3)]
    runs = {}
    for mode in ("eager", "graph"):
        sess, *_ = pt.parallel_run(
            lc.build_model(cfg), seed=0, device=cuda,
            parallax_config=pt.Config(run_option="HYBRID"))
        sess.prepare(batches[0])
        assert sess.engine.batch_layout == "sequence"
        if mode == "eager":
            with graphs.disable_capture():
                before = (fa.launches, fa.launches_dq, fa.launches_dkv)
                losses = [float(sess.run("loss", feed_dict=b))
                          for b in batches]
                torch.cuda.synchronize()
                assert (fa.launches, fa.launches_dq, fa.launches_dkv) == \
                    tuple(n + 3 * cfg.num_layers for n in before)
        else:
            losses = [float(sess.run("loss", feed_dict=b)) for b in batches]
        runs[mode] = (losses, [t.detach().clone()
                               for t in state_tensors(sess.state)])
        sess.close()
    (le, se), (lg, sg) = runs["eager"], runs["graph"]
    assert all(np.isfinite(le)) and le == lg
    for a, b in zip(se, sg):
        assert torch.equal(a, b)


def test_captured_decode_step_matches_eager(cuda):
    from parallax_tpu_torch import serve
    from parallax_tpu_torch.models import long_context as lc
    cfg = _cfg()
    params = lc.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in (5, 64, 33, 1)]
    results = {}
    for mode in ("eager", "graph"):
        prog = serve.CausalLMDecodeProgram(
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
        for t in range(8):
            tok, state = prog.step(params, state, tok,
                                   np.full((4,), t, np.int32), pages)
            toks.append(tok.copy())
        # the spare page takes every sentinel write, duplicates in no set
        # order: it is never read, so the pools compare without it
        results[mode] = (np.stack(toks),
                         state["kc"][:, :prog.pool_pages].clone())
    np.testing.assert_array_equal(results["eager"][0], results["graph"][0])
    assert torch.equal(results["eager"][1], results["graph"][1])
