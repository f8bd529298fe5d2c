"""The port's causal-LM serving against the JAX package's.

One tiny fp32 long-context LM (vocab 512, D 32, 2 heads, 2 layers) from
one JAX parameter tree carried across with
``long_context_params_from_jax``; prompts padded to 8, at most 12 new
tokens, pages of 4 (5 a slot).

(a) ``CausalLMDecodeProgram``, dense and paged, against JAX's on two
    requests of ragged prompt lengths: the prefill's K/V, ``base`` and
    ``first``; the caches after inserting both (the paged insert through
    each slot's page row, padded rows dropped: the JAX pool against the
    port's pool less its spare page), a ``copy_page``, and two decode
    steps' logits, within 1e-5.
(b) 24 requests of ragged prompt lengths (1-8) and caps (4-12) served by
    the port's ``ServeSession`` over 8 slots and a 16-page pool, so
    refills defer (``serve.kv_refill_deferred`` > 0): every request's
    tokens identical to the port's ``standalone_greedy`` and to JAX's
    (the fp32 exact-under-greedy contract, ``parallax_tpu/serve/
    adapters.py:886-896``), dense and paged; ``serve.kv_pages_in_use`` is
    0 after close.
(c) The refusals: ``prefill_chunk_layers`` and ``spec_tokens``
    (``ValueError``, not ported), the kernel without pages, a pipeline
    config, prompts outside [1, vocab), and JAX's shape errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.models import long_context as jlc
from parallax_tpu.serve import adapters as jadapters
import parallax_tpu_torch as tpx
from parallax_tpu_torch.models import long_context as tlc
from parallax_tpu_torch.serve import adapters as tadapters
from parallax_tpu_torch.weights import long_context_params_from_jax

TS, CAP, PS, POOL = 8, 12, 4, 16
PAGED = dict(page_size=PS, pool_pages=POOL)


def _models():
    jcfg = jlc.tiny_config(compute_dtype=jnp.float32, parallelism="data")
    jparams = jlc.build_model(jcfg).init_fn(jax.random.PRNGKey(0))
    tcfg = tlc.tiny_config(compute_dtype=torch.float32, parallelism="data")
    tparams = long_context_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _programs(paged):
    jcfg, jparams, tcfg, tparams = _models()
    kw = dict(PAGED, attn_impl="kernel") if paged else {}
    jkw = dict(PAGED, attn_impl="einsum") if paged else {}
    return (jadapters.CausalLMDecodeProgram(jcfg, TS, CAP, **jkw), jparams,
            tpx.CausalLMDecodeProgram(tcfg, TS, CAP, device="cpu", **kw),
            tparams)


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, (int(rng.integers(1, TS + 1)),))
            .astype(np.int32) for _ in range(n)]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_program_matches_jax(paged):
    jprog, jparams, tprog, tparams = _programs(paged)
    prompts = [np.arange(1, 6, dtype=np.int32) * 7,
               np.arange(1, 9, dtype=np.int32) * 5]
    jstate = jprog.init_state(jparams, 2)
    tstate = tprog.init_state(tparams, 2)
    P = TS + CAP
    rows = []
    for j, ids in enumerate(prompts):
        jfeed = jprog.prepare_feed({"ids": ids})
        tfeed = tprog.prepare_feed({"ids": ids})
        np.testing.assert_array_equal(jfeed["ids"], tfeed["ids"])
        assert tprog.kv_prefix_positions(tfeed) == \
            jprog.kv_prefix_positions(jfeed) == len(ids) - 1
        jrs = jprog.prefill(jparams, jfeed)
        trs = tprog.prefill(tparams, tfeed)
        for key in ("pk", "pv", "base", "first"):
            _close(trs[key], jrs[key], key)
        if paged:
            # slot j owns pages 3j.. (sentinel past its allocation)
            row = np.full((P // PS,), POOL, np.int32)
            n = -(-(len(ids) - 1 + CAP) // PS)
            row[:n] = 3 * j + np.arange(n)
            rows.append(row)
            jstate = jprog.insert(jstate, np.int32(j), jrs, row)
            tstate = tprog.insert(tstate, j, trs, row)
        else:
            jstate = jprog.insert(jstate, np.int32(j), jrs)
            tstate = tprog.insert(tstate, j, trs)
    for key in ("kc", "vc"):
        got = tstate[key][:, :POOL] if paged else tstate[key]
        _close(got, jstate[key], key)
    if paged:
        # the prefix cache's copy-on-write page copy, against JAX's
        jcopy = jprog.copy_page(jstate, 15, 3)
        tcopy = tprog.copy_page({k: v.clone() for k, v in tstate.items()},
                                15, 3)
        for key in ("kc", "vc"):
            _close(tcopy[key][:, :POOL], jcopy[key], f"copied {key}")
            assert torch.equal(tcopy[key][:, 15], tstate[key][:, 3])
    _close(tstate["base"], jstate["base"], "base")
    pages = np.stack(rows) if paged else None
    tok = np.zeros((2,), np.int32)
    for t in range(2):
        tt = np.full((2,), t, np.int32)
        kw = dict(pages=jnp.asarray(pages), page_size=PS,
                  attn_impl="einsum") if paged else {}
        jlog, jkc, jvc = jlc._decode_step_cached(
            jprog.cfg, jparams, jnp.asarray(tok), jnp.asarray(tt),
            jstate["base"], jstate["first"], jstate["kc"], jstate["vc"],
            **kw)
        jstate = dict(jstate, kc=jkc, vc=jvc)
        tkw = dict(pages=torch.from_numpy(pages), page_size=PS,
                   attn_impl="kernel") if paged else {}
        tlog, _, _ = tlc._decode_step_cached(
            tprog.cfg, tparams, torch.from_numpy(tok), torch.from_numpy(tt),
            tstate["base"], tstate["first"], tstate["kc"], tstate["vc"],
            **tkw)
        _close(tlog, jlog, f"logits step {t}")
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_served_tokens_equal_both_standalone_greedies(paged):
    jprog, jparams, tprog, tparams = _programs(paged)
    prompts = _prompts(24, 3)
    caps = [int(c) for c in np.random.default_rng(4).integers(4, CAP + 1,
                                                             24)]
    serve = tpx.ServeConfig(max_batch=8, max_queue=64)
    with tpx.ServeSession(program=tprog, params=tparams, device="cpu",
                          config=tpx.Config(serve_config=serve)) as sess:
        reqs = [sess.submit({"ids": p}, max_new_tokens=c)
                for p, c in zip(prompts, caps)]
        outs = [r.result(timeout=120) for r in reqs]
    stats = sess.stats()
    assert stats["serve.completed"] == 24
    if paged:
        assert stats["serve.kv_pages_in_use"] == 0
        assert stats["serve.kv_refill_deferred"] > 0
    for p, c, out in zip(prompts, caps, outs):
        want = jadapters.standalone_greedy(jprog, jparams, {"ids": p}, c)
        mine = tadapters.standalone_greedy(tprog, tparams, {"ids": p}, c)
        assert mine == want
        assert out.tolist() == want


def test_refusals():
    jcfg, _, tcfg, _ = _models()
    for kw in (dict(prefill_chunk_layers=1), dict(spec_tokens=2)):
        with pytest.raises(ValueError, match="not ported"):
            tpx.CausalLMDecodeProgram(tcfg, TS, CAP, device="cpu", **kw)
    bad = [(dict(attn_impl="kernel"), "requires the paged"),
           (dict(page_size=3, pool_pages=POOL), "must divide"),
           (dict(page_size=PS), "without pool_pages"),
           (dict(pool_pages=POOL), "without page_size"),
           (dict(page_size=PS, pool_pages=2), "cannot hold"),
           (dict(attn_impl="flash"), "expected")]
    for kw, match in bad:
        with pytest.raises(ValueError, match=match):
            jadapters.CausalLMDecodeProgram(jcfg, TS, CAP, **kw)
        with pytest.raises(ValueError, match=match):
            tpx.CausalLMDecodeProgram(tcfg, TS, CAP, device="cpu", **kw)
    with pytest.raises(ValueError, match="positional table"):
        tpx.CausalLMDecodeProgram(tcfg, 60, 8, device="cpu")
    pipe = tlc.tiny_config(parallelism="pipeline")
    with pytest.raises(ValueError, match="blocks_stacked"):
        tpx.CausalLMDecodeProgram(pipe, TS, CAP, device="cpu")
    prog = tpx.CausalLMDecodeProgram(tcfg, TS, CAP, device="cpu", **PAGED)
    for ids, match in ((np.zeros((3,), np.int32), "PAD"),
                       (np.ones((TS + 1,), np.int32), "outside"),
                       (np.ones((2, 2), np.int32), "prompt row")):
        with pytest.raises(ValueError, match=match):
            prog.prepare_feed({"ids": ids})
    assert prog.insert_pages and prog.pages_needed(CAP) == \
        -(-(TS - 1 + CAP) // PS)
