"""The port's disaggregated prefill/decode serving against the JAX
package's (``tests/test_disagg.py``).

* the wire format as a pure unit: nested request states round-trip
  exactly through both packages' ``export_prefill`` / ``import_prefill``
  in either direction (the npz format is shared), a bf16 tensor travels
  as float32 (numpy has no bfloat16), malformed states are refused;
* the transfer pin (``begin_transfer`` / ``end_transfer``) through both
  packages' prefix caches;
* serving: a ``DisaggFleet`` (one program per replica) gives the
  colocated fleet's tokens, which equal ``standalone_greedy`` and JAX's
  served tokens on the same parameters; the ``kv_transfer`` phase lands
  in the TTFT decomposition, no decode page stays in use;
* the failure ladder: a prefill replica killed mid-transfer fails over
  inside the pool; a dead prefill pool falls back to colocated serving;
* across packages: bytes from JAX's ``export_prefill`` (after its
  ``prefill_only``) import into the port's decode replica, and the
  served tokens equal JAX's colocated tokens.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jpx
import parallax_tpu.serve as jserve
from parallax_tpu.serve import adapters as jadapters
import parallax_tpu_torch as tpx
import parallax_tpu_torch.serve as tserve
from parallax_tpu_torch import weights
from parallax_tpu_torch.serve import (DisaggFleet, FaultInjector,
                                      FleetConfig, ServeFleet,
                                      ServeSession, adapters as tadapters,
                                      export_prefill, import_prefill,
                                      standalone_greedy)

PACKAGES = {"port": tserve, "jax": jserve}
NAME = "causal_lm"
CAP = 6


# -- the wire protocol as a pure unit ---------------------------------------


def _state():
    return {"pk": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "meta": {"base": np.int32(5),
                     "mask": np.array([True, False])},
            "first": np.arange(3, dtype=np.int32)}


@pytest.mark.parametrize("src,dst", [("port", "port"), ("port", "jax"),
                                     ("jax", "port")])
def test_roundtrip_nested_exact(src, dst):
    rs = _state()
    if src == "jax":
        rs = dict(rs, pk=jnp.asarray(rs["pk"].numpy()))
    wire = PACKAGES[src].export_prefill(rs)
    assert isinstance(wire, bytes) and len(wire) > 0
    back = PACKAGES[dst].import_prefill(wire)
    assert set(back) == {"pk", "meta", "first"}
    assert set(back["meta"]) == {"base", "mask"}
    np.testing.assert_array_equal(back["pk"], np.arange(12).reshape(3, 4))
    np.testing.assert_array_equal(back["meta"]["base"], 5)
    np.testing.assert_array_equal(back["meta"]["mask"], [True, False])
    assert back["pk"].dtype == np.float32
    assert back["first"].dtype == np.int32


def test_bf16_travels_as_float32_exactly():
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    wire = export_prefill({"k": x, "v": x.float()})
    back = import_prefill(wire)
    assert back["k"].dtype == np.float32
    np.testing.assert_array_equal(back["k"], x.float().numpy())
    # fp32 on the wire: twice the bf16 bytes, the same as the fp32 leaf
    assert back["k"].nbytes == back["v"].nbytes == 2 * x.numel() * 2
    # the JAX package reads the same bytes
    np.testing.assert_array_equal(jserve.import_prefill(wire)["k"],
                                  back["k"])


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_malformed_states_refused(pkg):
    mod = PACKAGES[pkg]
    with pytest.raises(ValueError, match="separator"):
        mod.export_prefill({"a/b": np.zeros(2)})
    with pytest.raises(ValueError, match="dict of arrays"):
        mod.export_prefill(np.zeros(2))


# -- the transfer pin as a pure unit ----------------------------------------


def _entry(mod, cache, alloc, key, tokens, n_pages):
    pages = alloc.alloc(n_pages)
    assert cache.insert(None, key, tokens, pages, {"x": np.zeros(1)})
    return cache.lookup(None, key)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_transferring_entry_survives_lru_pressure(pkg):
    mod = PACKAGES[pkg]
    a = mod.PageAllocator(8)
    c = mod.RadixPrefixCache(a)
    streaming = _entry(mod, c, a, (1,), [9], 4)
    _entry(mod, c, a, (2,), [9], 4)
    c.begin_transfer(streaming)
    assert c.evict_for(4) == 1
    assert c.lookup(None, (1,)) is streaming
    assert c.lookup(None, (2,)) is None
    c.end_transfer(streaming)
    assert c.evict_for(8) == 1
    assert a.in_use == 0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_supersede_cannot_free_transferring_pages(pkg):
    mod = PACKAGES[pkg]
    a = mod.PageAllocator(8)
    c = mod.RadixPrefixCache(a)
    streaming = _entry(mod, c, a, (1,), [7, 8], 4)
    c.begin_transfer(streaming)
    assert a.shared_pages == 4
    pages2 = a.alloc(4)
    assert c.insert(None, (1,), [7, 8, 9], pages2, {"x": np.zeros(1)})
    assert c.lookup(None, (1,)) is not streaming
    assert a.in_use == 8
    c.end_transfer(streaming)
    assert a.in_use == 4
    assert c.evict_for(8) == 1
    assert a.in_use == 0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_unbalanced_end_transfer_refused(pkg):
    mod = PACKAGES[pkg]
    a = mod.PageAllocator(4)
    c = mod.RadixPrefixCache(a)
    e = _entry(mod, c, a, (1,), [5], 2)
    with pytest.raises(ValueError, match="begin_transfer"):
        c.end_transfer(e)


# -- serving ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fixture():
    """JAX's causal-LM fixture and its params carried to the port."""
    jprog, jparams = jadapters.registered_adapters()[NAME].build(
        paged=True, chunked=False)
    tprog, _ = tadapters.registered_adapters()[NAME].build(
        paged=True, chunked=False, device="cpu")
    tparams = weights.long_context_params_from_jax(
        jax.tree.map(np.asarray, jparams), tprog.cfg, device="cpu")
    return jprog, jparams, tprog, tparams


def _feeds(n, seed):
    rng = np.random.default_rng(seed)
    spec = tadapters.registered_adapters()[NAME]
    return [spec.make_feed(rng) for _ in range(n)]


def _factory(params):
    """A replica factory that builds one program per replica."""
    cfg = tpx.Config(serve_config=tpx.ServeConfig(
        max_batch=2, max_queue=64, prefix_cache=True))
    spec = tadapters.registered_adapters()[NAME]

    def mk(rid, **kw):
        prog, _ = spec.build(paged=True, chunked=False, device="cpu")
        return ServeSession(program=prog, params=params, config=cfg,
                            device="cpu", **kw)
    return mk


def _jax_served(feeds):
    jprog, jparams, _, _ = _fixture()
    cfg = jpx.Config(serve_config=jpx.ServeConfig(max_batch=2,
                                                  max_queue=64))
    with jserve.ServeSession(program=jprog, params=jparams,
                             config=cfg) as sess:
        reqs = [sess.submit(f, max_new_tokens=CAP) for f in feeds]
        return [[int(t) for t in r.result(timeout=120)] for r in reqs]


def test_disagg_equals_colocated_and_jax_with_kv_transfer_decomp():
    _, _, tprog, tparams = _fixture()
    mk = _factory(tparams)
    feeds = _feeds(5, seed=21)
    want = [standalone_greedy(tprog, tparams, f, max_new_tokens=CAP)
            for f in feeds]
    assert want == _jax_served(feeds)

    colo = ServeFleet(mk, config=FleetConfig(num_replicas=1,
                                             min_replicas=1))
    try:
        got_colo = [[int(t) for t in r.result(timeout=120)]
                    for r in [colo.submit(f, max_new_tokens=CAP)
                              for f in feeds]]
    finally:
        colo.close()
    assert got_colo == want

    d = DisaggFleet(
        mk, mk,
        prefill_config=FleetConfig(num_replicas=1, min_replicas=1),
        decode_config=FleetConfig(num_replicas=1, min_replicas=1))
    try:
        reqs = [d.submit(f, max_new_tokens=CAP) for f in feeds]
        got = [[int(t) for t in r.result(timeout=120)] for r in reqs]
    finally:
        d.close()
    assert got == want

    snap = d.metrics.snapshot()
    assert snap["serve.disagg.transfers"] == len(feeds)
    assert snap["serve.disagg.transfer_bytes"] > 0
    assert d.recompiles() == 0
    for rid, st in d.decode_fleet.stats()["replicas"].items():
        assert st["serve"].get("serve.kv_pages_in_use") == 0, rid
        assert st["serve"]["serve.prefix.hits"] == len(feeds)
    recs = [r for r in d.request_records()
            if r.get("ttft_decomp") is not None]
    assert recs
    for rec in recs:
        decomp = rec["ttft_decomp"]
        assert "kv_transfer_ms" in decomp, decomp
        total = sum(decomp.values())
        assert abs(total - rec["ttft_ms"]) <= 0.05 * max(rec["ttft_ms"],
                                                         1e-9)
        assert rec["hops"][0] == "prefill:0"


def test_prefill_replica_killed_mid_transfer_fails_over():
    _, _, tprog, tparams = _fixture()
    mk = _factory(tparams)
    feeds = _feeds(4, seed=23)
    want = [standalone_greedy(tprog, tparams, f, max_new_tokens=CAP)
            for f in feeds]
    inj = FaultInjector()
    d = DisaggFleet(
        mk, mk,
        prefill_config=FleetConfig(num_replicas=2, min_replicas=1,
                                   max_retries=2),
        decode_config=FleetConfig(num_replicas=1, min_replicas=1),
        faults=inj)
    try:
        assert [int(t) for t in d.submit(
            feeds[0], max_new_tokens=CAP).result(timeout=120)] == want[0]
        # park replica 0's idle decode loop inside a stall, so the
        # one-shot crash is consumed by the PREFILL path (the kill
        # mid-transfer), not by an idle loop pass
        inj.arm(0, "stall", seconds=1.0)
        t_end = time.perf_counter() + 5.0
        while inj.fired("stall") == 0 and time.perf_counter() < t_end:
            time.sleep(0.002)
        assert inj.fired("stall") == 1
        inj.arm(0, "crash")
        reqs = [d.submit(f, max_new_tokens=CAP) for f in feeds]
        got = [[int(t) for t in r.result(timeout=120)] for r in reqs]
    finally:
        d.close()
    assert got == want
    assert inj.fired("crash") == 1
    assert d.metrics.snapshot()["serve.disagg.prefill_failovers"] >= 1
    assert d.recompiles() == 0


def test_dead_prefill_pool_falls_back_to_colocated():
    _, _, tprog, tparams = _fixture()
    mk = _factory(tparams)
    feeds = _feeds(3, seed=29)
    want = [standalone_greedy(tprog, tparams, f, max_new_tokens=CAP)
            for f in feeds]
    inj = FaultInjector()
    d = DisaggFleet(
        mk, mk,
        prefill_config=FleetConfig(num_replicas=1, min_replicas=1),
        decode_config=FleetConfig(num_replicas=1, min_replicas=1),
        faults=inj)
    try:
        inj.arm(0, "crash")  # the idle loop takes it: the replica dies
        t_end = time.perf_counter() + 5.0
        while d.prefill_fleet.live_sessions() \
                and time.perf_counter() < t_end:
            time.sleep(0.005)
        assert not d.prefill_fleet.live_sessions()
        reqs = [d.submit(f, max_new_tokens=CAP) for f in feeds]
        got = [[int(t) for t in r.result(timeout=120)] for r in reqs]
    finally:
        d.close()
    assert got == want
    snap = d.metrics.snapshot()
    assert snap["serve.disagg.prefill_fallbacks"] == len(feeds)
    assert snap["serve.disagg.transfers"] == 0


def test_jax_exported_prefill_serves_on_the_port():
    """JAX's prefill, exported as wire bytes, imported into the port's
    decode replica: admission takes the imported entry (nothing
    replayed, the prefill skipped) and the tokens equal JAX's colocated
    serving of the same feeds."""
    jprog, jparams, _, tparams = _fixture()
    feeds = _feeds(3, seed=31)
    jcfg = jpx.Config(serve_config=jpx.ServeConfig(
        max_batch=2, max_queue=64, prefix_cache=True))
    with jserve.ServeSession(program=jprog, params=jparams,
                             config=jcfg) as jsess:
        exported = []
        for f in feeds:
            _, key, rs = jsess.prefill_only(f)
            exported.append((key, jserve.export_prefill(rs)))
        want = [[int(t) for t in r.result(timeout=120)]
                for r in [jsess.submit(f, max_new_tokens=CAP)
                          for f in feeds]]
    dec = _factory(tparams)(0)
    try:
        for key, wire in exported:
            assert dec.import_prefix_entry(None, key,
                                           import_prefill(wire))
        got = [[int(t) for t in r.result(timeout=120)]
               for r in [dec.submit(f, max_new_tokens=CAP)
                         for f in feeds]]
        snap = dec.metrics.snapshot()
    finally:
        dec.close()
    assert got == want
    assert snap["serve.prefix.hits"] == len(feeds)
    assert snap["serve.prefix.replayed_tokens"] == 0
    assert snap["serve.prefills"] == 0
