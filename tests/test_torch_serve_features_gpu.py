"""The serving features on the card: chunked prefill, speculative decode
and the params swap, as graph replays against eager runs.

An NMT of D 128 (2 heads of 64), 2 layers, vocab 1000, bf16, with the
flash-attention kernel in the encoder; sources padded to 32, 64 tokens,
pages of 16; and the long-context causal LM at the same widths.

* Each prefill chunk's graph (``prefill_chunk_layers=1``: three graphs,
  chunk k reading chunk k - 1's outputs) against the same chunks run
  eagerly (``compile.disable_capture()``): every request-state tensor
  bitwise equal, and equal to the whole prefill's graph. NMT and the
  causal LM.
* The speculative iteration's one graph (the draft's catch-up step, k =
  2 draft steps, the target's verify of 3 queries a slot through B7)
  against the same iteration run eagerly, 6 iterations on 4 inserted
  requests: ``y``, the proposals and the target pool (less its spare
  page) bitwise equal; B7 launched once a layer an iteration.
* ``swap_params`` on a session whose program captured its graphs: the
  replays after the swap serve what a fresh session on the new params
  serves, and nothing is captured again.

Every test needs a CUDA card and skips without one; run them with
``python -m pytest --noconftest tests/test_torch_serve_features_gpu.py -m
gpu``.
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


def _nmt(cuda, seed=0):
    from parallax_tpu_torch.models import nmt
    cfg = nmt.NMTConfig(vocab_size=1000, model_dim=128, num_heads=2,
                        mlp_dim=256, num_layers=2, max_len=64,
                        num_partitions=1, use_pallas_attention=True)
    params = nmt.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(seed), device=cuda)
    return cfg, params


def _srcs(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 1000, (int(rng.integers(4, 33)),))
            .astype(np.int32) for _ in range(n)]


def _chunks(prog, params, feed):
    carry = feed
    for k in range(prog.num_prefill_chunks):
        carry = prog.prefill_chunk(params, carry, k)
    return {k: v.clone() for k, v in carry.items()}


@pytest.mark.parametrize("model", ["nmt", "causal_lm"])
def test_chunk_graphs_replay_bitwise_against_eager(cuda, model):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.compile import graphs
    if model == "nmt":
        cfg, params = _nmt(cuda)
        make = pt.NMTDecodeProgram
        feeds = [{"src": s} for s in _srcs(4)]
    else:
        from parallax_tpu_torch.models import long_context as lc
        cfg = lc.LongContextConfig(vocab_size=1000, model_dim=128,
                                   num_heads=2, mlp_dim=256, num_layers=2,
                                   max_len=128)
        params = lc.init_params(
            cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
        make = pt.CausalLMDecodeProgram
        feeds = [{"ids": s} for s in _srcs(4)]
    kw = dict(max_src_len=32, max_len=64, page_size=16, pool_pages=64,
              attn_impl="kernel", device=cuda)
    chunked = make(cfg, prefill_chunk_layers=1, **kw)
    whole = make(cfg, **kw)
    for prog in (chunked, whole):
        prog.capture(params, prog.init_state(params, 4))
    assert len(chunked._graphs.chunks) == cfg.num_layers + 1
    assert whole._graphs.prefill is not None
    for feed in feeds:
        f = chunked.prepare_feed(feed)
        got = _chunks(chunked, params, f)
        w = {k: v.clone() for k, v in whole.prefill(params, f).items()}
        with graphs.disable_capture():
            want = _chunks(chunked, params, f)
        assert got.keys() == want.keys() == w.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), key
            assert torch.equal(got[key], w[key]), key


def test_spec_graph_replays_bitwise_against_eager(cuda):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.compile import graphs
    from parallax_tpu_torch.ops import paged_attention as pa
    cfg, params = _nmt(cuda)
    dcfg, dparams = pt.serve.layer_skip_draft(cfg, params, 1)
    srcs = _srcs(4, seed=2)
    results = {}
    for mode in ("eager", "graph"):
        prog = pt.NMTDecodeProgram(
            cfg, max_src_len=32, max_len=64, page_size=16, pool_pages=64,
            spec_tokens=2, draft_cfg=dcfg, draft_params=dparams,
            attn_impl="kernel", device=cuda)
        state = prog.init_state(params, 4)
        if mode == "graph":
            prog.capture(params, state)
            assert prog._graphs.spec is not None
        pages = np.arange(4 * prog.pages_per_seq, dtype=np.int32).reshape(
            4, prog.pages_per_seq)
        for j, s in enumerate(srcs):
            rs = prog.prefill(params, prog.prepare_feed({"src": s}))
            prog.insert(state, j, rs)
        tok = np.full((4,), prog.bos_id, np.int32)
        prev = tok.copy()
        t = np.zeros((4,), np.int32)
        out = []
        before = pa.launches
        ctx = graphs.disable_capture() if mode == "eager" else \
            __import__("contextlib").nullcontext()
        with ctx:
            for _ in range(6):
                y, p, state = prog.spec_step(params, state, tok, t, prev,
                                             pages)
                out.append((y.copy(), p.copy()))
                for s in range(4):
                    n = 1
                    while n <= 2 and p[s, n - 1] == y[s, n - 1]:
                        n += 1
                    prev[s] = y[s, n - 2] if n >= 2 else tok[s]
                    tok[s] = y[s, n - 1]
                    t[s] += n
        torch.cuda.synchronize()
        assert pa.launches == before + 6 * cfg.num_layers
        results[mode] = (out, state["kc"][:, :prog.pool_pages].clone())
    for (ye, pe), (yg, pg) in zip(results["eager"][0], results["graph"][0]):
        np.testing.assert_array_equal(ye, yg)
        np.testing.assert_array_equal(pe, pg)
    assert torch.equal(results["eager"][1], results["graph"][1])


def test_swap_params_replays_read_the_new_weights(cuda):
    import parallax_tpu_torch as pt
    cfg, params_a = _nmt(cuda, seed=0)
    _, params_b = _nmt(cuda, seed=1)
    srcs = _srcs(6, seed=3)

    def session(params):
        prog = pt.NMTDecodeProgram(cfg, max_src_len=32, max_len=64,
                                   page_size=16, pool_pages=64,
                                   prefill_chunk_layers=1,
                                   attn_impl="kernel", device=cuda)
        return pt.ServeSession(
            program=prog, params=params, device=cuda,
            config=pt.Config(serve_config=pt.ServeConfig(max_batch=4)))

    def serve(sess):
        return [sess.submit({"src": s}, max_new_tokens=16).result(120)
                .tolist() for s in srcs]

    with session(params_b) as fresh:
        want_b = serve(fresh)
    sess = session(params_a)
    try:
        got_a = serve(sess)
        captures = sess.stats()["serve.graph_captures"]
        assert captures == cfg.num_layers + 2      # the chunks and step
        sess.swap_params(params_b)
        got_b = serve(sess)
        stats = sess.stats()
    finally:
        sess.close()
    assert got_b == want_b
    assert got_a != got_b
    assert stats["serve.graph_captures"] == captures
    assert stats["serve.hotswaps"] == 1
