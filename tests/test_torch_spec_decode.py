"""The port's speculative decoding against the JAX package's.

One tiny fp32 NMT (vocab 64, D 16, 2 heads, 2 layers, max_len 16) from
one JAX parameter tree carried across with ``params_from_jax``; sources
padded to 8, decode buffer 12, pages of 4.

* ``layer_skip_draft``: the same config and the same leaves as JAX's
  (the port's draft leaves are the target's own tensors).
* The verify's foundation: ``_decode_tokens_cached`` over G = 4 tokens
  equals G single steps of the same executor bit for bit (dense, paged
  with the kernel's plain version, paged einsum) and JAX's logits within
  1e-5; a window
  past the buffer's end drops its writes (dense: the positions it passes
  keep their values; paged: no foreign page is written), as JAX's
  ``mode="drop"``.
* One ``spec_step`` (then a second on its output) from the same state:
  ``y`` and the proposals equal JAX's, paged and dense.
* Served through ``ServeSession``: tokens, ``serve.spec_proposed`` and
  ``serve.spec_accepted`` equal JAX's session on the same requests, for a
  1-layer draft (paged, dense, and paged with chunked prefill), and a
  perfect draft (the target itself) accepts everything.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jpx
from parallax_tpu.models import nmt as jnmt
from parallax_tpu.serve import adapters as jadapters
import parallax_tpu_torch as tpx
from parallax_tpu_torch.models import nmt as tnmt
from parallax_tpu_torch.serve import adapters as tadapters
from parallax_tpu_torch.weights import params_from_jax

CFG = dict(vocab_size=64, model_dim=16, num_heads=2, mlp_dim=32,
           num_layers=2, max_len=16, num_partitions=1)
TS, T, PS = 8, 12, 4
SRC_LENS = (6, 4, 8, 5, 7, 3)
CAPS = (12, 5, 9, 12, 4, 8)


def _models():
    jcfg = jnmt.tiny_config(**CFG, compute_dtype=jnp.float32)
    jparams = jnmt.build_model(jcfg).init_fn(jax.random.PRNGKey(0))
    tcfg = tnmt.tiny_config(**CFG, compute_dtype=torch.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _programs(paged=True, chunked=False, layers=1, pool=36, k=2):
    jcfg, jparams, tcfg, tparams = _models()
    jd = jadapters.layer_skip_draft(jcfg, jparams, layers)
    td = tadapters.layer_skip_draft(tcfg, tparams, layers)
    kw = dict(max_src_len=TS, max_len=T, spec_tokens=k,
              prefill_chunk_layers=1 if chunked else None)
    if paged:
        kw.update(page_size=PS, pool_pages=pool)
    jprog = jadapters.NMTDecodeProgram(jcfg, **kw, draft_cfg=jd[0],
                                       draft_params=jd[1])
    tprog = tpx.NMTDecodeProgram(tcfg, **kw, draft_cfg=td[0],
                                 draft_params=td[1], device="cpu")
    return jprog, jparams, tprog, tparams


def _srcs(seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 64, (n,)).astype(np.int32) for n in SRC_LENS]


def test_layer_skip_draft_matches_jax():
    jcfg, jparams, tcfg, tparams = _models()
    jdcfg, jdparams = jadapters.layer_skip_draft(jcfg, jparams, 1)
    tdcfg, tdparams = tadapters.layer_skip_draft(tcfg, tparams, 1)
    assert tdcfg.num_layers == jdcfg.num_layers == 1
    assert dataclasses.replace(tdcfg, num_layers=2) == tcfg
    want = params_from_jax(jax.tree.map(np.asarray, jdparams), tdcfg,
                           device="cpu")
    got = jax.tree.leaves(tdparams, is_leaf=torch.is_tensor)
    assert len(got) == len(jax.tree.leaves(jdparams))
    for a, b in zip(got, jax.tree.leaves(want, is_leaf=torch.is_tensor)):
        assert torch.equal(a, b)
    assert tdparams["enc"][0]["attn"]["wq"] is tparams["enc"][0]["attn"]["wq"]
    assert tdparams["emb"] is tparams["emb"]
    for bad in (0, 3):
        with pytest.raises(ValueError, match="outside"):
            tadapters.layer_skip_draft(tcfg, tparams, bad)


def _encoded(cfg, params, src, pkg_nmt, to_arr):
    enc, sv = pkg_nmt._encode(cfg, params, to_arr(src))
    ck, cv = pkg_nmt._cross_kv(cfg, params, enc)
    return ck, cv, sv


def test_verify_bit_identical_to_single_steps_and_jax():
    jcfg, jparams, tcfg, tparams = _models()
    rng = np.random.default_rng(7)
    S, G, Tb, pool = 3, 4, 16, 32
    src = rng.integers(3, 64, (S, TS)).astype(np.int32)
    toks = rng.integers(3, 64, (S, G)).astype(np.int32)
    ck, cv, sv = _encoded(tcfg, tparams, src, tnmt,
                          lambda a: torch.from_numpy(a).long())
    jck, jcv, jsv = _encoded(jcfg, jparams, src, jnmt, jnp.asarray)
    pages = torch.from_numpy(
        np.arange(S * Tb // PS, dtype=np.int32).reshape(S, Tb // PS))
    jkc, jvc = jnmt._init_self_cache(jcfg, S, Tb)
    jl = np.asarray(jnmt._decode_tokens_cached(
        jcfg, jparams, jnp.asarray(toks), jnp.zeros((S,), jnp.int32), jkc,
        jvc, jck, jcv, jsv)[0])
    for impl in ("dense", "kernel", "einsum"):
        def caches():
            if impl == "dense":
                return tnmt._init_self_cache(tcfg, S, Tb, "cpu") + ({},)
            return tnmt._init_paged_self_cache(tcfg, pool, PS, "cpu") + (
                dict(pages=pages, page_size=PS, attn_impl=impl),)

        kc, vc, kw = caches()
        singles = [tnmt._decode_tokens_cached(
            tcfg, tparams, torch.from_numpy(toks[:, g:g + 1]).long(),
            torch.full((S,), g, dtype=torch.int32), kc, vc, ck, cv, sv,
            **kw)[0][:, 0] for g in range(G)]
        kc, vc, kw = caches()
        out = tnmt._decode_tokens_cached(
            tcfg, tparams, torch.from_numpy(toks).long(),
            torch.zeros((S,), dtype=torch.int32), kc, vc, ck, cv, sv,
            **kw)[0]
        for g in range(G):
            assert torch.equal(out[:, g], singles[g]), (impl, g)
        np.testing.assert_allclose(out.numpy(), jl, rtol=1e-5, atol=1e-5)


def test_overshoot_writes_drop():
    """A window past the buffer's end stays finite; the dense cache keeps
    what it held past its width (JAX's dropped writes: the caches agree
    with JAX's), and the paged pool's foreign pages are untouched."""
    jcfg, jparams, tcfg, tparams = _models()
    rng = np.random.default_rng(9)
    S, G, Tb, pool = 3, 4, 16, 32
    src = rng.integers(3, 64, (S, TS)).astype(np.int32)
    toks = rng.integers(3, 64, (S, G)).astype(np.int32)
    t = np.array([Tb - 2, Tb - 1, Tb - 3], np.int32)
    ck, cv, sv = _encoded(tcfg, tparams, src, tnmt,
                          lambda a: torch.from_numpy(a).long())
    jck, jcv, jsv = _encoded(jcfg, jparams, src, jnmt, jnp.asarray)
    kc, vc = tnmt._init_self_cache(tcfg, S, Tb, "cpu")
    kc.normal_(generator=torch.Generator().manual_seed(0))
    vc.normal_(generator=torch.Generator().manual_seed(1))
    jkc, jvc = jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy())
    tl, kc, vc = tnmt._decode_tokens_cached(
        tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(t),
        kc, vc, ck, cv, sv)
    jl, jkc, jvc = jnmt._decode_tokens_cached(
        jcfg, jparams, jnp.asarray(toks), jnp.asarray(t), jkc, jvc, jck,
        jcv, jsv)
    assert torch.isfinite(tl).all()
    np.testing.assert_allclose(kc.numpy(), np.asarray(jkc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(vc.numpy(), np.asarray(jvc), rtol=1e-5,
                               atol=1e-5)
    # every in-buffer query agrees with JAX (the rest are discarded)
    live = (t[:, None] + np.arange(G)[None]) < Tb
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=1e-5, atol=1e-5)
    pages = np.arange(S * Tb // PS, dtype=np.int32).reshape(S, Tb // PS)
    kp, vp = tnmt._init_paged_self_cache(tcfg, pool, PS, "cpu")
    before = kp.clone()
    _, kp, _ = tnmt._decode_tokens_cached(
        tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(t),
        kp, vp, ck, cv, sv, pages=torch.from_numpy(pages), page_size=PS)
    foreign = [p for p in range(pool) if p not in set(pages.ravel())]
    assert torch.equal(kp[:, foreign], before[:, foreign])


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_spec_step_matches_jax(paged):
    jprog, jparams, tprog, tparams = _programs(paged=paged)
    srcs = _srcs()[:3]
    S = 3
    jstate = jprog.init_state(jparams, S)
    tstate = tprog.init_state(tparams, S)
    rows = np.full((S, T // PS), 36, np.int32)
    for j, src in enumerate(srcs):
        jfeed = jprog.prepare_feed({"src": src})
        tfeed = tprog.prepare_feed({"src": src})
        jrs = jprog.prefill(jparams, jfeed)
        trs = tprog.prefill(tparams, tfeed)
        for key in ("ck", "cv", "d_ck", "d_cv"):
            np.testing.assert_allclose(trs[key].numpy(), np.asarray(jrs[key]),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
        jstate = jprog.insert(jstate, np.int32(j), jrs)
        tstate = tprog.insert(tstate, j, trs)
        rows[j] = 3 * j + np.arange(T // PS)
    pages = rows if paged else None
    tok = np.full((S,), tprog.bos_id, np.int32)
    prev = tok.copy()
    t = np.zeros((S,), np.int32)
    for _ in range(2):
        jy, jp, jstate = jprog.spec_step(jparams, jstate, tok, t, prev,
                                         pages)
        ty, tp, tstate = tprog.spec_step(tparams, tstate, tok, t, prev,
                                         pages)
        np.testing.assert_array_equal(ty, np.asarray(jy))
        np.testing.assert_array_equal(tp, np.asarray(jp))
        assert ty.shape == (S, 3) and tp.shape == (S, 2)
        # the scheduler's next input: accept the agreeing prefix
        for s in range(S):
            n = 1
            while n <= 2 and tp[s, n - 1] == ty[s, n - 1]:
                n += 1
            prev[s] = ty[s, n - 2] if n >= 2 else tok[s]
            tok[s] = ty[s, n - 1]
            t[s] += n


def _serve_both(jprog, jparams, tprog, tparams, srcs, caps, slots=3):
    outs = {}
    stats = {}
    for pkg, prog, params, kw in (
            (jpx, jprog, jparams, {}),
            (tpx, tprog, tparams, {"device": "cpu"})):
        sess = pkg.ServeSession(
            program=prog, params=params, **kw,
            config=pkg.Config(serve_config=pkg.ServeConfig(
                max_batch=slots, max_queue=64)))
        try:
            reqs = [sess.submit({"src": s}, max_new_tokens=c)
                    for s, c in zip(srcs, caps)]
            outs[pkg] = [r.result(timeout=120).tolist() for r in reqs]
        finally:
            sess.close()
        stats[pkg] = sess.stats()
    return outs[jpx], outs[tpx], stats[jpx], stats[tpx]


@pytest.mark.parametrize("paged,chunked", [(True, False), (False, False),
                                           (True, True)],
                         ids=["paged", "dense", "paged-chunked"])
def test_served_tokens_and_counters_match_jax(paged, chunked):
    jprog, jparams, tprog, tparams = _programs(paged=paged, chunked=chunked,
                                               pool=12)
    srcs = _srcs()
    jout, tout, jst, tst = _serve_both(jprog, jparams, tprog, tparams,
                                       srcs, CAPS)
    assert tout == jout
    for src, cap, out in zip(srcs, CAPS, tout):
        assert out == tadapters.standalone_greedy(tprog, tparams,
                                                  {"src": src}, cap)
    for key in ("serve.spec_proposed", "serve.spec_accepted",
                "serve.completed", "serve.tokens"):
        assert tst[key] == jst[key], key
    assert tst["serve.spec_accept_rate"] is None     # unhooked at close
    assert tst["serve.spec_proposed"] > 0
    if paged:
        assert tst["serve.kv_pages_in_use"] == 0
    if chunked:
        assert tst["serve.prefill_chunks"] == jst["serve.prefill_chunks"] \
            == len(srcs) * 3


def test_perfect_draft_accepts_everything():
    jcfg, jparams, tcfg, tparams = _models()
    prog = tpx.NMTDecodeProgram(tcfg, max_src_len=TS, max_len=T,
                                spec_tokens=3, draft_cfg=tcfg,
                                draft_params=tparams, device="cpu")
    srcs = _srcs(3)[:3]
    caps = [12, 12, 10]
    sess = tpx.ServeSession(program=prog, params=tparams, device="cpu",
                            config=tpx.Config(serve_config=tpx.ServeConfig(
                                max_batch=2, max_queue=64)))
    try:
        outs = [sess.submit({"src": s}, max_new_tokens=c).result(120)
                for s, c in zip(srcs, caps)]
        rate = sess.stats()["serve.spec_accept_rate"]
        stats = sess.stats()
    finally:
        sess.close()
    assert rate == pytest.approx(1.0)
    assert stats["serve.decode_steps"] * 2 < stats["serve.tokens"]
    for src, cap, out in zip(srcs, caps, outs):
        ref = tnmt.greedy_decode(tparams, tcfg, src[None],
                                 max_len=cap)[0].tolist()
        if tnmt.EOS_ID in ref:
            ref = ref[:ref.index(tnmt.EOS_ID) + 1]
        assert out.tolist() == ref
