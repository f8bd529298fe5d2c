"""The DecodeProgram conformance battery over the port's adapter registry,
held to the JAX package's (``tests/test_adapters.py`` runs the same
battery over JAX's ``registered_adapters()``).

Every adapter in ``parallax_tpu_torch.serve.registered_adapters()`` — nmt,
causal_lm, moe_lm, lm1b — builds its tiny fp32 fixture on the CPU; for
the comparisons with JAX the port's program serves the JAX fixture's
parameters, carried across with ``weights.*_from_jax``. The battery:

* paged against dense, bit for bit (``standalone_greedy``);
* chunked against whole prefill: the request state bit for bit in the
  port (the same torch ops in the same order), and within 1e-5 of JAX's
  chunked request state. (JAX's own identity test,
  ``tests/test_paged_kv.py::TestChunkedPrefill::
  test_chunks_reproduce_whole_prefill``, is one of the reference's reds:
  XLA fuses differently across jit boundaries, up to 3.6e-7);
* served tokens (5 requests on 3 slots, the prefix cache on where the
  adapter pages) equal to the port's ``standalone_greedy`` and to JAX's
  served tokens, with no page left in use and no graph captured after
  the warmup;
* prefix replay and continuation past the cached tokens;
* ``prefill_only`` on one session, ``import_prefix_entry`` into another,
  then decode.

Plus the LM1B serving functions against JAX's within 1e-5, and
``swap_params``: serving after a swap equals a fresh session on the new
params, and a changed shape or dtype is refused.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jpx
from parallax_tpu.models import lm1b as jlm1b
from parallax_tpu.serve import adapters as jadapters
import parallax_tpu_torch as tpx
from parallax_tpu_torch import weights
from parallax_tpu_torch.models import lm1b as tlm1b
from parallax_tpu_torch.serve import adapters as tadapters

TADAPTERS = tadapters.registered_adapters()
JADAPTERS = jadapters.registered_adapters()
NAMES = sorted(TADAPTERS)
PAGED_NAMES = sorted(n for n in NAMES if TADAPTERS[n].paged)
CHUNKED_NAMES = sorted(n for n in NAMES if TADAPTERS[n].chunked)
CONVERT = {"nmt": weights.params_from_jax,
           "causal_lm": weights.long_context_params_from_jax,
           "moe_lm": weights.moe_lm_params_from_jax,
           "lm1b": weights.lm1b_params_from_jax}
CAP = 6


@functools.lru_cache(maxsize=None)
def _pair(name: str, paged: bool, chunked: bool):
    """(JAX program, JAX params, port program, the JAX params carried to
    the port). The port's fixture is built on the CPU; its own random
    params are set aside for JAX's."""
    jprog, jparams = JADAPTERS[name].build(paged=paged, chunked=chunked)
    tprog, _ = TADAPTERS[name].build(paged=paged, chunked=chunked,
                                     device="cpu")
    tparams = CONVERT[name](jax.tree.map(np.asarray, jparams), tprog.cfg,
                            device="cpu")
    return jprog, jparams, tprog, tparams


def _feeds(name: str, n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    return [TADAPTERS[name].make_feed(rng) for _ in range(n)]


def _config(pkg, spec, max_batch: int = 3):
    return pkg.Config(serve_config=pkg.ServeConfig(
        max_batch=max_batch, max_queue=64, prefix_cache=spec.paged))


def _serve_port(prog, params, feeds, spec, max_batch=3):
    with tpx.ServeSession(program=prog, params=params, device="cpu",
                          config=_config(tpx, spec, max_batch)) as sess:
        reqs = [sess.submit(f, max_new_tokens=CAP) for f in feeds]
        got = [[int(t) for t in r.result(timeout=120)] for r in reqs]
    return got, sess


def test_registry_matches_jax():
    assert NAMES == sorted(JADAPTERS)
    for name in NAMES:
        t, j = TADAPTERS[name], JADAPTERS[name]
        assert (t.paged, t.chunked) == (j.paged, j.chunked), name
        tprog, tparams = t.build(paged=t.paged, chunked=False, device="cpu")
        jprog, _ = j.build(paged=j.paged, chunked=False)
        assert (tprog.Ts, tprog.max_len, tprog.bos_id, tprog.eos_id,
                tprog.pad_id) == (jprog.Ts, jprog.max_len, jprog.bos_id,
                                  jprog.eos_id, jprog.pad_id), name
        assert all(v.device.type == "cpu" for v in
                   jax.tree.leaves(tparams, is_leaf=torch.is_tensor))
    assert set(tpx.registered_adapters()) == set(NAMES)


@pytest.mark.parametrize("name", PAGED_NAMES)
def test_paged_vs_dense_bit_identity(name):
    _, _, prog_p, params = _pair(name, True, False)
    _, _, prog_d, _ = _pair(name, False, False)
    for feed in _feeds(name, 3):
        got_p = tadapters.standalone_greedy(prog_p, params, feed, CAP)
        got_d = tadapters.standalone_greedy(prog_d, params, feed, CAP)
        assert got_p == got_d, (name, got_p, got_d)


@pytest.mark.parametrize("name", CHUNKED_NAMES)
def test_chunked_prefill_bit_identity(name):
    jprog_c, jparams, prog_c, params = _pair(name, True, True)
    _, _, prog_1, _ = _pair(name, True, False)
    assert prog_c.num_prefill_chunks == prog_c.cfg.num_layers + 1
    for feed in _feeds(name, 3):
        tfeed = prog_c.prepare_feed(feed)
        whole = {k: v.clone() for k, v in
                 prog_1.prefill(params, tfeed).items()}
        carry = tfeed
        for k in range(prog_c.num_prefill_chunks):
            carry = prog_c.prefill_chunk(params, carry, k)
        assert carry.keys() == whole.keys()
        for key in whole:
            assert torch.equal(carry[key], whole[key]), (name, key)
        jcarry = jprog_c.prepare_feed(feed)
        for k in range(jprog_c.num_prefill_chunks):
            jcarry = jprog_c.prefill_chunk(jparams, jcarry, k)
        for key in whole:
            np.testing.assert_allclose(
                carry[key].numpy(), np.asarray(jcarry[key]), rtol=1e-5,
                atol=1e-5, err_msg=f"{name} {key}")
        got_c = tadapters.standalone_greedy(prog_c, params, feed, CAP)
        got_1 = tadapters.standalone_greedy(prog_1, params, feed, CAP)
        assert got_c == got_1, (name, got_c, got_1)


@pytest.mark.parametrize("name", NAMES)
def test_served_tokens_match_standalone_greedy_and_jax(name):
    """5 requests through a 3-slot session force retire and refill;
    every stream equals the port's standalone reference and JAX's served
    stream for the same request; no page stays in use after close."""
    spec = TADAPTERS[name]
    jprog, jparams, prog, params = _pair(name, spec.paged, False)
    feeds = _feeds(name, 5, seed=11)
    want = [tadapters.standalone_greedy(prog, params, f, CAP)
            for f in feeds]
    got, sess = _serve_port(prog, params, feeds, spec)
    assert got == want, (name, got, want)
    jsess = jpx.ServeSession(program=jprog, params=jparams,
                             config=_config(jpx, spec))
    try:
        jreqs = [jsess.submit(f, max_new_tokens=CAP) for f in feeds]
        jgot = [[int(t) for t in r.result(timeout=120)] for r in jreqs]
    finally:
        jsess.close()
    assert got == jgot, (name, got, jgot)
    snap = sess.metrics.snapshot()
    assert snap["serve.recompiles"] == 0
    assert snap["serve.completed"] == 5
    if spec.paged:
        assert snap["serve.kv_pages_in_use"] == 0, name


@pytest.mark.parametrize("name", PAGED_NAMES)
def test_prefix_replay_continuation_bit_identity(name):
    """Same feed twice with a longer cap the second time: the second
    request hits, replays the cached tokens, then continues past them
    into fresh pages — and still matches the standalone stream."""
    spec = TADAPTERS[name]
    _, _, prog, params = _pair(name, True, False)
    feed = _feeds(name, 1, seed=13)[0]
    want = tadapters.standalone_greedy(prog, params, feed, CAP)
    with tpx.ServeSession(program=prog, params=params, device="cpu",
                          config=_config(tpx, spec, 2)) as sess:
        t1 = [int(t) for t in
              sess.submit(feed, max_new_tokens=4).result(timeout=120)]
        t2 = [int(t) for t in
              sess.submit(feed, max_new_tokens=CAP).result(timeout=120)]
    assert t1 == want[:len(t1)], (name, t1, want)
    assert t2 == want, (name, t2, want)
    snap = sess.metrics.snapshot()
    assert snap["serve.prefix.hits"] >= 1
    assert snap["serve.kv_pages_in_use"] == 0


@pytest.mark.parametrize("name", PAGED_NAMES)
def test_import_prefix_then_decode_bit_identity(name):
    """``prefill_only`` on one session, the request state imported into
    another session's prefix cache (a page-less entry), then the same
    feed submitted there: the hit admits with nothing replayed, the
    insert re-scatters the prompt K/V into fresh pages, and the stream
    equals the standalone one. Each session has its own program: a
    program serves one live session."""
    spec = TADAPTERS[name]
    _, _, prog, params = _pair(name, True, False)
    pre_prog, _ = spec.build(paged=True, chunked=False, device="cpu")
    feed = _feeds(name, 1, seed=17)[0]
    want = tadapters.standalone_greedy(prog, params, feed, CAP)
    cfg = _config(tpx, spec, 2)
    pre = tpx.ServeSession(program=pre_prog, params=params, device="cpu",
                           config=cfg)
    dec = tpx.ServeSession(program=prog, params=params, device="cpu",
                           config=cfg)
    try:
        prepared, key, rs = pre.prefill_only(feed)
        assert key == prog.prefix_key(prepared)
        assert dec.import_prefix_entry(None, key, rs, positions=0)
        toks = [int(t) for t in
                dec.submit(feed, max_new_tokens=CAP).result(timeout=120)]
    finally:
        pre.close()
        dec.close()
    assert toks == want, (name, toks, want)
    snap = dec.metrics.snapshot()
    assert snap["serve.prefix.hits"] == 1
    assert snap["serve.prefix.replayed_tokens"] == 0
    assert snap["serve.kv_pages_in_use"] == 0


# -- LM1B serving -------------------------------------------------------------


def test_lm1b_serving_functions_match_jax():
    jcfg = jlm1b.tiny_config(compute_dtype=jnp.float32)
    jparams = jlm1b.build_model(jcfg).init_fn(jax.random.PRNGKey(3))
    tcfg = tlm1b.tiny_config(compute_dtype=torch.float32)
    tparams = weights.lm1b_params_from_jax(jax.tree.map(np.asarray, jparams),
                                           tcfg, device="cpu")
    ids = np.zeros((1, 8), np.int32)
    ids[0, :5] = [17, 4, 999, 250, 3]
    jc, jh, jbase, jfirst = jlm1b._lstm_prefill(jcfg, jparams,
                                                jnp.asarray(ids))
    tc, th, tbase, tfirst = tlm1b._lstm_prefill(tcfg, tparams,
                                                torch.from_numpy(ids))
    for got, want in ((tc, jc), (th, jh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert tbase.tolist() == np.asarray(jbase).tolist() == [4]
    assert tfirst.tolist() == np.asarray(jfirst).tolist() == [3]
    tok = np.array([3, 500, 7], np.int32)
    rng = np.random.default_rng(0)
    c0 = rng.standard_normal((3, tcfg.hidden_dim)).astype(np.float32)
    h0 = rng.standard_normal((3, tcfg.proj_dim)).astype(np.float32)
    jl, jc, jh = jlm1b._lstm_decode_step(jcfg, jparams, jnp.asarray(tok),
                                         jnp.asarray(c0), jnp.asarray(h0))
    tl, tc, th = tlm1b._lstm_decode_step(tcfg, tparams,
                                         torch.from_numpy(tok),
                                         torch.from_numpy(c0),
                                         torch.from_numpy(h0))
    for got, want in ((tl, jl), (tc, jc), (th, jh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_lm1b_program_refusals_and_state():
    prog, params = TADAPTERS["lm1b"].build(device="cpu")
    assert not prog.paged and prog.eos_id == -1
    for ids, match in ((np.zeros((3,), np.int32), "PAD"),
                       (np.ones((9,), np.int32), "outside"),
                       (np.ones((2, 2), np.int32), "prompt row")):
        with pytest.raises(ValueError, match=match):
            prog.prepare_feed({"ids": ids})
    with pytest.raises(ValueError, match=">= 1"):
        tpx.LM1BDecodeProgram(prog.cfg, 0, 8, device="cpu")
    state = prog.init_state(params, 4)
    assert state["c"].shape == (4, prog.cfg.hidden_dim)
    assert state["h"].shape == (4, prog.cfg.proj_dim)


# -- swap_params ----------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_swap_params_serves_the_new_weights(name):
    """A session serving params A, swapped to B in place, serves what a
    fresh session on B serves; nothing is captured again, the caller's
    trees are untouched, and a changed shape or dtype is refused."""
    spec = TADAPTERS[name]
    prog, params_a = spec.build(paged=spec.paged, chunked=False,
                                device="cpu")
    _, params_b = spec.build(paged=spec.paged, chunked=False, device="cpu")
    gen = torch.Generator().manual_seed(5)
    params_b = jax.tree.map(
        lambda x: x + 0.05 * torch.randn(x.shape, generator=gen).to(x.dtype)
        if x.is_floating_point() else x, params_b, is_leaf=torch.is_tensor)
    a_copy = jax.tree.map(torch.clone, params_a, is_leaf=torch.is_tensor)
    feeds = _feeds(name, 4, seed=23)
    fresh, _ = _serve_port(prog, params_b, feeds, spec)
    sess = tpx.ServeSession(program=prog, params=params_a, device="cpu",
                            config=_config(tpx, spec))
    try:
        before = [[int(t) for t in sess.submit(f, max_new_tokens=CAP)
                   .result(timeout=120)] for f in feeds]
        captures = sess.stats()["serve.graph_captures"]
        assert sess.idle()
        sess.swap_params(params_b)
        if spec.paged:
            # the cache holds A's continuations: a swap serves B's
            sess._scheduler._prefix.clear()
        after = [[int(t) for t in sess.submit(f, max_new_tokens=CAP)
                  .result(timeout=120)] for f in feeds]
        leaves = jax.tree.leaves(params_a, is_leaf=torch.is_tensor)
        bad = leaves[0].clone()[..., :1]
        with pytest.raises(ValueError, match="changed"):
            sess.swap_params(jax.tree.map(
                lambda x: bad if x is leaves[0] else x, params_a,
                is_leaf=torch.is_tensor))
        with pytest.raises(ValueError, match="changed"):
            sess.swap_params(jax.tree.map(
                lambda x: x.double() if x is leaves[-1] else x, params_a,
                is_leaf=torch.is_tensor))
        with pytest.raises(ValueError, match="structure"):
            sess.swap_params({"emb": leaves[0]})
        stats = sess.stats()
    finally:
        sess.close()
    assert after == fresh, (name, after, fresh)
    assert before == [tadapters.standalone_greedy(prog, params_a, f, CAP)
                      for f in feeds]
    assert stats["serve.hotswaps"] == 1
    assert stats["serve.graph_captures"] == captures
    for x, y in zip(jax.tree.leaves(params_a, is_leaf=torch.is_tensor),
                    jax.tree.leaves(a_copy, is_leaf=torch.is_tensor)):
        assert torch.equal(x, y)
