"""The port's prefix-aware KV reuse against the JAX package's
(``tests/test_prefix_cache.py``).

* The ref-counted allocator and the radix cache as pure units: each case
  drives the same operation sequence through both packages' classes,
  checks the port's outcome, and holds every recorded result and
  ``stats()`` snapshot equal to JAX's.
* Serving: one tiny fp32 NMT (vocab 64, D 16, 2 layers) from one JAX
  parameter tree (``params_from_jax``), sources padded to 8, 12 tokens,
  pages of 4, ``ServeConfig(prefix_cache=True)``. The same requests,
  submitted one after another, go through the JAX session and the
  port's: every request's tokens equal JAX's and the plain
  ``greedy_decode``'s, and the prefix counters (hits, full hits,
  copy-on-write copies, replayed tokens, evictions, deferred refills,
  decode steps, chunks) equal JAX's. Cases: warm replay with
  copy-on-write, a full hit with zero decode steps, eviction under
  pressure (an evicted prefix is a miss), composition with chunked
  prefill and with speculative decoding, shared pages counted once,
  tenant isolation, the lifecycle record's prefix fields, the causal LM
  (prompt positions ahead of the decoded ones), and the refusal of a
  dense program.
* A prefill's result lives in the program's buffer until the next
  prefill: prefill A, then prefill B, then a continuation of A must
  still decode from A's own cached request state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jpx
from parallax_tpu.models import long_context as jlc
from parallax_tpu.models import nmt as jnmt
from parallax_tpu.serve import adapters as jadapters
from parallax_tpu.serve import paging as jpaging
from parallax_tpu.serve import prefixcache as jprefix
import parallax_tpu_torch as tpx
from parallax_tpu_torch.models import long_context as tlc
from parallax_tpu_torch.models import nmt as tnmt
from parallax_tpu_torch.serve import adapters as tadapters
from parallax_tpu_torch.serve import paging as tpaging
from parallax_tpu_torch.serve import prefixcache as tprefix
from parallax_tpu_torch.weights import (long_context_params_from_jax,
                                        params_from_jax)

JAX = (jpaging.PageAllocator, jpaging.PagePoolExhausted,
       jprefix.RadixPrefixCache)
PORT = (tpaging.PageAllocator, tpaging.PagePoolExhausted,
        tprefix.RadixPrefixCache)


# -- the allocator and the radix cache, both packages -------------------------


def _entry(c, a, tenant, key, tokens, n):
    pages = a.alloc(n)
    c.insert(tenant, key, tokens, pages, None)
    return pages


def _share_free(Alloc, Exhausted, Cache):
    a = Alloc(8)
    pages = a.alloc(3)
    log = [(a.in_use, a.total_refs)]
    a.share(pages)
    log.append((a.in_use, a.total_refs, a.shared_pages, a.sharing_ratio()))
    a.free(pages)
    log.append((a.in_use, a.free_pages))
    a.free(pages)
    log.append((a.in_use, a.free_pages))
    assert a.in_use == 0 and a.free_pages == 8
    return log + [a.stats()]


def _refusals(Alloc, Exhausted, Cache):
    a = Alloc(4)
    pages = a.alloc(2)
    a.share(pages)
    a.free(pages)
    a.free(pages)
    log = []
    for op, arg, match in ((a.free, pages, "double-free"),
                           (a.share, pages, "not currently allocated")):
        with pytest.raises(ValueError, match=match):
            op(arg)
        log.append(match)
    got = a.alloc(1)
    with pytest.raises(ValueError, match="duplicate"):
        a.share([got[0], got[0]])
    a.alloc(2)
    with pytest.raises(Exhausted):
        a.alloc(2)
    assert a.free_pages == 1
    return log + [a.stats()]


def _churn(Alloc, Exhausted, Cache):
    a = Alloc(6)
    shadow = {}
    rng = np.random.default_rng(3)
    log = []
    for _ in range(400):
        op = rng.random()
        if op < 0.4 and a.can_alloc(1):
            (p,) = a.alloc(1)
            shadow[p] = 1
        elif op < 0.7 and shadow:
            p = int(rng.choice(sorted(shadow)))
            a.share([p])
            shadow[p] += 1
        elif shadow:
            p = int(rng.choice(sorted(shadow)))
            a.free([p])
            shadow[p] -= 1
            if shadow[p] == 0:
                del shadow[p]
        assert a.in_use == len(shadow)
        assert a.total_refs == sum(shadow.values())
        log.append((a.in_use, a.total_refs, a.shared_pages))
    for p, c in list(shadow.items()):
        for _ in range(c):
            a.free([p])
    assert a.in_use == 0 and a.free_pages == 6
    return log + [a.stats()]


def _lookup_exact(Alloc, Exhausted, Cache):
    a = Alloc(16)
    c = Cache(a)
    _entry(c, a, None, (1, 2, 3), [7, 8], 1)
    assert c.lookup(None, (1, 2, 3)).tokens == [7, 8]
    assert c.lookup(None, (1, 2)) is None
    assert c.lookup(None, (1, 2, 3, 4)) is None
    return [c.stats(), c.lookup(None, (1, 2, 3)).snapshot()]


def _lru_and_pin(Alloc, Exhausted, Cache):
    a = Alloc(6)
    c = Cache(a)
    for k, tok in ((1, 5), (2, 6), (3, 7)):
        _entry(c, a, None, (k,), [tok], 2)
    c.lookup(None, (1,))
    e2 = c.lookup(None, (2,))
    c.pin(e2)
    assert c.evict_for(2) == 1
    assert c.lookup(None, (2,)) is not None
    assert c.lookup(None, (3,)) is None
    c.unpin(e2)
    log = [c.stats(), c.evict_for(4)]
    with pytest.raises(ValueError, match="unpin"):
        c.unpin(e2)
    return log + [c.stats(), a.stats()]


def _all_pinned(Alloc, Exhausted, Cache):
    a = Alloc(4)
    c = Cache(a)
    _entry(c, a, None, (1,), [5], 2)
    _entry(c, a, None, (2,), [6], 2)
    for key in ((1,), (2,)):
        c.pin(c.lookup(None, key))
    assert c.evict_for(1) == 0
    assert c.num_entries == 2
    return [c.stats()]


def _supersede(Alloc, Exhausted, Cache):
    a = Alloc(8)
    c = Cache(a)
    _entry(c, a, None, (1,), [5, 6], 1)
    short = a.alloc(1)
    assert c.insert(None, (1,), [5], short, None) is False
    assert a.refcount(short[0]) == 0
    old = c.lookup(None, (1,)).pages
    longer = a.alloc(2)
    assert c.insert(None, (1,), [5, 6, 7], longer, None) is True
    assert c.lookup(None, (1,)).tokens == [5, 6, 7]
    assert a.refcount(old[0]) == 0
    return [c.stats(), a.stats()]


def _tenants(Alloc, Exhausted, Cache):
    a = Alloc(8)
    c = Cache(a)
    _entry(c, a, "a", (1, 2), [9], 1)
    assert c.lookup("b", (1, 2)) is None
    assert c.lookup("a", (1, 2)) is not None
    assert c.tenants() == ["a"]
    return [c.stats(), [e.snapshot() for e in c.entries("a")]]


def _budgets(Alloc, Exhausted, Cache):
    a = Alloc(16)
    c = Cache(a, max_pages=4)
    for k, tok in ((1, 5), (2, 6), (3, 7)):
        _entry(c, a, None, (k,), [tok], 2)
    assert c.cached_pages <= 4 and c.lookup(None, (1,)) is None
    a2 = Alloc(16)
    c2 = Cache(a2, max_entries=2)
    for k in range(4):
        _entry(c2, a2, None, (k,), [5], 1)
    assert c2.num_entries == 2 and c2.lookup(None, (0,)) is None
    assert c2.lookup(None, (3,)) is not None
    for bad in (dict(max_pages=-1), dict(max_entries=-1)):
        with pytest.raises(ValueError, match=">= 0"):
            Cache(a, **bad)
    return [c.stats(), c2.stats()]


def _prune_and_clear(Alloc, Exhausted, Cache):
    a = Alloc(8)
    c = Cache(a)
    _entry(c, a, None, tuple(range(30)), [5], 1)
    assert c.evict_for(8) == 1
    assert c.num_entries == 0 and c.tenants() == []
    _entry(c, a, None, (1,), [5], 2)
    _entry(c, a, "t", (2,), [6], 2)
    e = c.lookup("t", (2,))
    c.begin_transfer(e)
    log = [c.stats(), a.stats()]
    assert c.clear() == 1              # the entry in transfer is pinned
    c.end_transfer(e)
    assert c.clear() == 1
    assert a.in_use == 0 and c.num_entries == 0
    return log + [c.stats(), a.stats()]


UNITS = [_share_free, _refusals, _churn, _lookup_exact, _lru_and_pin,
         _all_pinned, _supersede, _tenants, _budgets, _prune_and_clear]


@pytest.mark.parametrize("case", UNITS, ids=lambda f: f.__name__[1:])
def test_units_match_jax(case):
    assert case(*PORT) == case(*JAX)


# -- serving against JAX -------------------------------------------------------

CFG = dict(vocab_size=64, model_dim=16, num_heads=2, mlp_dim=32,
           num_layers=2, max_len=16, num_partitions=1)
TS, T, PS = 8, 12, 4
COUNTERS = ("serve.prefix.hits", "serve.prefix.misses",
            "serve.prefix.full_hits", "serve.prefix.cow_copies",
            "serve.prefix.replayed_tokens",
            "serve.prefix.prefill_tokens_skipped",
            "serve.prefix.evictions", "serve.kv_refill_deferred",
            "serve.decode_steps", "serve.completed", "serve.tokens")


def _nmt_models():
    jcfg = jnmt.tiny_config(**CFG, compute_dtype=jnp.float32)
    jparams = jnmt.build_model(jcfg).init_fn(jax.random.PRNGKey(0))
    tcfg = tnmt.tiny_config(**CFG, compute_dtype=torch.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


class _Rig:
    """The same NMT program and serve config in both packages."""

    def __init__(self, slots=3, pool_pages=36, draft=False, **kw):
        jcfg, jparams, tcfg, tparams = _nmt_models()
        self.tcfg, self.tparams = tcfg, tparams
        pkw = dict(max_src_len=TS, max_len=T, page_size=PS,
                   pool_pages=pool_pages,
                   prefill_chunk_layers=kw.pop("prefill_chunk_layers",
                                               None))
        jkw, tkw = dict(pkw), dict(pkw, device="cpu")
        if draft:
            jd = jadapters.layer_skip_draft(jcfg, jparams)
            td = tadapters.layer_skip_draft(tcfg, tparams)
            jkw.update(spec_tokens=2, draft_cfg=jd[0], draft_params=jd[1])
            tkw.update(spec_tokens=2, draft_cfg=td[0], draft_params=td[1])
        self.sides = {
            "jax": (jpx, jadapters.NMTDecodeProgram(jcfg, **jkw), jparams,
                    {}),
            "port": (tpx, tpx.NMTDecodeProgram(tcfg, **tkw), tparams,
                     {"device": "cpu"})}
        self.slots, self.kw = slots, kw

    def run(self, script):
        """``script(sess)`` on each side's fresh session; returns {side:
        (its result, stats after it, stats after close, allocator pages
        in use after close)}."""
        out = {}
        for side, (pkg, prog, params, kw) in self.sides.items():
            sess = pkg.ServeSession(
                program=prog, params=params, **kw,
                config=pkg.Config(serve_config=pkg.ServeConfig(
                    max_batch=self.slots, max_queue=64, prefix_cache=True,
                    **self.kw)))
            try:
                res = script(sess)
                live = sess.stats()
            finally:
                sess.close()
            out[side] = (res, live, sess.stats(),
                         sess._scheduler._alloc.in_use)
        return out


def _served(sess, srcs, caps, **kw):
    return [sess.submit({"src": s}, max_new_tokens=c, **kw)
            .result(timeout=120).tolist() for s, c in zip(srcs, caps)]


def _greedy(rig, src, cap):
    ref = tnmt.greedy_decode(rig.tparams, rig.tcfg, src[None],
                             max_len=cap)[0].tolist()
    if tnmt.EOS_ID in ref:
        ref = ref[:ref.index(tnmt.EOS_ID) + 1]
    return ref


def _check(rig, out, srcs_caps, counters=COUNTERS):
    """Both sides' results equal, the port's tokens greedy, the counters
    equal, no page in use after close."""
    (jres, jlive, jend, jin), (tres, tlive, tend, tin) = \
        out["jax"], out["port"]
    assert tres == jres
    for key in counters:
        assert tlive.get(key) == jlive.get(key), key
    assert tin == jin == 0
    assert tend["serve.kv_pages_in_use"] == 0
    for outs, (srcs, caps) in zip(tres, srcs_caps):
        for src, cap, got in zip(srcs, caps, outs):
            assert got == _greedy(rig, src, cap)
    return tlive


@pytest.fixture
def srcs():
    rng = np.random.default_rng(0)
    return [rng.integers(3, 64, (n,)).astype(np.int32) for n in (6, 4, 8)]


def test_warm_replay_and_cow_token_identical(srcs):
    rig = _Rig()
    caps = [7, 5, 7]
    out = rig.run(lambda s: [_served(s, srcs, caps), _served(s, srcs, caps),
                             _served(s, srcs, [12] * 3)])
    st = _check(rig, out, [(srcs, caps), (srcs, caps), (srcs, [12] * 3)])
    assert st["serve.prefix.full_hits"] >= 3
    assert st["serve.prefix.cow_copies"] >= 1


def test_full_hit_completes_with_zero_decode_steps(srcs):
    rig = _Rig()

    def script(s):
        first = _served(s, srcs[:1], [8])
        steps = s.stats()["serve.decode_steps"]
        second = _served(s, srcs[:1], [8])
        return [first, second, s.stats()["serve.decode_steps"] - steps]

    out = rig.run(script)
    assert out["port"][0][2] == 0
    st = _check(rig, {k: (v[0][:2],) + v[1:] for k, v in out.items()},
                [(srcs[:1], [8])] * 2)
    assert st["serve.prefix.full_hits"] == 1


def test_eviction_under_pressure_and_no_stale_reads():
    rng = np.random.default_rng(1)
    srcs = [rng.integers(3, 64, (5,)).astype(np.int32) for _ in range(6)]
    rig = _Rig(slots=2, pool_pages=8)

    def script(s):
        outs = _served(s, srcs, [12] * 6)
        hits = s.stats()["serve.prefix.hits"]
        again = _served(s, srcs[:1], [12])
        return [outs, again, s.stats()["serve.prefix.hits"] - hits]

    out = rig.run(script)
    assert out["port"][0][2] == 0, "an evicted prefix was readable"
    st = _check(rig, {k: (v[0][:2],) + v[1:] for k, v in out.items()},
                [(srcs, [12] * 6), (srcs[:1], [12])])
    assert st["serve.prefix.evictions"] > 0


def test_chunked_prefill_composes_with_prefix_cache(srcs):
    rig = _Rig(prefill_chunk_layers=1)

    def script(s):
        cold = _served(s, srcs[:2], [9, 9])
        chunks = s.stats()["serve.prefill_chunks"]
        warm = _served(s, srcs[:2], [9, 9])
        return [cold, warm, s.stats()["serve.prefill_chunks"] - chunks]

    out = rig.run(script)
    assert out["port"][0][2] == 0, "a hit must skip every prefill chunk"
    _check(rig, {k: (v[0][:2],) + v[1:] for k, v in out.items()},
           [(srcs[:2], [9, 9])] * 2,
           counters=COUNTERS + ("serve.prefill_chunks",))


def test_speculative_decode_composes_with_prefix_cache(srcs):
    rig = _Rig(draft=True)
    caps = [7, 9, 12]
    out = rig.run(lambda s: [_served(s, srcs, caps),
                             _served(s, srcs, [12] * 3)])
    _check(rig, out, [(srcs, caps), (srcs, [12] * 3)],
           counters=COUNTERS + ("serve.spec_proposed",
                                "serve.spec_accepted"))


def test_kv_accounting_counts_shared_pages_once(srcs):
    rig = _Rig()

    def script(s):
        a = _served(s, srcs[:1], [7])
        b = _served(s, srcs[:1], [12])
        st = s.stats()
        alloc = s._scheduler._alloc
        assert st["serve.kv_pages_in_use"] == alloc.in_use
        assert st["serve.kv_page_refs"] == alloc.total_refs
        assert st["serve.kv_pages_in_use"] <= st["serve.kv_page_refs"]
        return [a, b, alloc.stats(), st["serve.kv_sharing_ratio"]]

    out = rig.run(script)
    assert out["port"][0][2:] == out["jax"][0][2:]
    _check(rig, {k: (v[0][:2],) + v[1:] for k, v in out.items()},
           [(srcs[:1], [7]), (srcs[:1], [12])])


def test_tenant_isolation_in_serving(srcs):
    rig = _Rig()

    def script(s):
        hits = []
        outs = []
        for tenant in ("a", "b", "a"):
            outs.append(_served(s, srcs[:1], [9], tenant=tenant))
            hits.append(s.stats()["serve.prefix.hits"])
        return [outs, hits, s.prefix_stats()]

    out = rig.run(script)
    res = out["port"][0]
    assert res[1] == [0, 0, 1], "tenant b hit tenant a's prefix"
    assert res[2]["tenants"] == 2
    assert res == out["jax"][0]
    assert res[0][0] == res[0][1] == res[0][2] == [_greedy(rig, srcs[0], 9)]


def test_reqtrace_carries_prefix_fields(srcs):
    rig = _Rig()
    pkg, prog, params, kw = rig.sides["port"]
    with pkg.ServeSession(program=prog, params=params, **kw,
                          config=pkg.Config(serve_config=pkg.ServeConfig(
                              max_batch=3, prefix_cache=True))) as sess:
        for _ in range(2):
            _served(sess, srcs[:1], [8])
        recs = sess.request_records()
    cold, warm = recs[-2], recs[-1]
    assert cold["prefix_hit_pages"] == 0
    assert cold["prefill_tokens_skipped"] == 0
    assert "prefill_ms" in cold["phases_ms"]
    assert warm["prefix_hit_pages"] > 0
    assert warm["prefill_tokens_skipped"] == 6
    assert "prefix_replay_ms" in warm["phases_ms"]
    assert "prefill_ms" not in warm["phases_ms"]
    assert sum(warm["ttft_decomp"].values()) == pytest.approx(
        warm["ttft_ms"], rel=0.05)
    st = sess.stats()
    assert st["serve.timeline.prefix_hit_pages"] is not None
    assert st["serve.prefix.hit_rate"] is None     # unhooked at close


def test_prefill_result_is_copied_into_the_cache(srcs):
    """A's request state goes to the cache at retire; B's prefill then
    overwrites the program's prefill buffer; A's continuation must still
    decode from A's own cross K/V. Without the copy the continuation
    reads B's."""
    rig = _Rig()
    _, prog, params, _ = rig.sides["port"]
    with tpx.ServeSession(program=prog, params=params, device="cpu",
                          config=tpx.Config(serve_config=tpx.ServeConfig(
                              max_batch=3, prefix_cache=True))) as sess:
        a1 = _served(sess, srcs[:1], [4])[0]
        _served(sess, srcs[1:2], [4])
        a2 = _served(sess, srcs[:1], [12])[0]
        st = sess.stats()
    assert st["serve.prefix.hits"] == 1 and st["serve.prefix.misses"] == 2
    assert a1 == _greedy(rig, srcs[0], 4)
    assert a2 == _greedy(rig, srcs[0], 12)
    # the buffer is the program's: the next prefill overwrites it
    fa, fb = (prog.prepare_feed({"src": s}) for s in srcs[:2])
    ra = prog.prefill(params, fa)
    ck_a = ra["ck"].clone()
    rb = prog.prefill(params, fb)
    assert rb["ck"] is ra["ck"] and not torch.equal(ra["ck"], ck_a)


def test_causal_lm_prefix_replay_matches_jax():
    """The causal LM: a prompt's positions precede the decoded ones, so
    sharing counts positions; warm, extended (copy-on-write) and
    imported rounds equal JAX's tokens and counters."""
    jcfg = jlc.tiny_config(compute_dtype=jnp.float32, parallelism="data")
    jparams = jlc.build_model(jcfg).init_fn(jax.random.PRNGKey(0))
    tcfg = tlc.tiny_config(compute_dtype=torch.float32, parallelism="data")
    tparams = long_context_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    kw = dict(page_size=PS, pool_pages=24)
    jprog = jadapters.CausalLMDecodeProgram(jcfg, TS, T, **kw)
    tprog = tpx.CausalLMDecodeProgram(tcfg, TS, T, device="cpu", **kw)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, (n,)).astype(np.int32) for n in (7, 3)]
    res, counts = {}, {}
    for side, pkg, prog, params, skw in (
            ("jax", jpx, jprog, jparams, {}),
            ("port", tpx, tprog, tparams, {"device": "cpu"})):
        with pkg.ServeSession(
                program=prog, params=params, **skw,
                config=pkg.Config(serve_config=pkg.ServeConfig(
                    max_batch=2, prefix_cache=True))) as sess:
            rounds = [[sess.submit({"ids": p}, max_new_tokens=c)
                       .result(timeout=120).tolist()
                       for p in prompts] for c in (5, 5, 12)]
        res[side] = rounds
        counts[side] = {k: sess.stats().get(k) for k in COUNTERS}
    assert res["port"] == res["jax"]
    assert counts["port"] == counts["jax"]
    assert counts["port"]["serve.prefix.cow_copies"] >= 1
    for p, got in zip(prompts, res["port"][2]):
        assert got == tadapters.standalone_greedy(tprog, tparams,
                                                  {"ids": p}, 12)


def test_prefix_cache_requires_paged_program():
    _, _, tcfg, tparams = _nmt_models()
    prog = tpx.NMTDecodeProgram(tcfg, max_src_len=TS, max_len=T,
                                device="cpu")
    with pytest.raises(ValueError, match="PAGED"):
        tpx.ServeSession(program=prog, params=tparams, device="cpu",
                         config=tpx.Config(serve_config=tpx.ServeConfig(
                             max_batch=2, prefix_cache=True)))
