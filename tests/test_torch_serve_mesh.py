"""The port's ``ServeSession`` over a mesh of gloo ranks against the JAX
``ServeSession`` on a CPU mesh of the same shape.

The port's mesh is a process group: every rank constructs the session,
rank 0 leads and the others replay its dispatches (serve/mesh.py). The
ranks run ``serve_mesh`` of ``torch_dist_ranks.py`` on meshes (1, 2) and
(2, 2), each spawned once with a deadline (a follower that hung would
fail the test, not stall the suite). The JAX side runs in this process
on the first devices of the 8 emulated CPU devices, from the same
parameters:

* one-shot serving of a model whose row-sharded table is placed by the
  engine's plan (``model=``): every output at 1e-5 of JAX's
  ``ServeSession(..., model=)``; each rank holds V/p rows; buckets that
  divide the ranks are split over them, the others go whole;
  ``serve.recompiles`` 0; ``submit`` on a follower raises; ``close()``
  returns on every rank and releases the session's graphs (stand-ins
  planted before it: the CPU captures none);
* ``NMTDecodeProgram`` (``emb`` row-sharded, ``out_proj`` dense) and
  ``LM1BDecodeProgram`` (``softmax_w`` row-sharded, the greedy argmax
  over ranks) tokens identical to JAX's served tokens, once with a tie
  forced between rows of two shard columns (the lowest id wins, as
  JAX's argmax over the whole row). JAX classifies a decode program's
  params on the serving feed, which its models' losses cannot read, so
  its reference sessions take no ``model=``: the tokens do not depend on
  placement;
* on (1, 2): ``ParallaxSession.serve()`` serves the engine's own
  tensors (no gather, no copy), and ``MoeLMDecodeProgram`` under expert
  placement raises the ``NotImplementedError`` naming the missing
  all_to_all dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import parallax_tpu as jpx
from parallax_tpu.core import mesh as jmesh
from parallax_tpu.models import lm1b as jlm1b
from parallax_tpu.models import nmt as jnmt
from parallax_tpu.ops import embedding as jemb
from parallax_tpu.serve import LM1BDecodeProgram as JLM1BDecodeProgram
from parallax_tpu.serve import NMTDecodeProgram as JNMTDecodeProgram
from parallax_tpu.serve import ServeSession as JServeSession
from test_torch_dist import join_ranks, shared, start_ranks

RTOL, ATOL = 1e-5, 1e-6
DEADLINE_S = 150
NMT_CFG = dict(vocab_size=64, model_dim=16, num_heads=2, mlp_dim=32,
               num_layers=2, max_len=16, num_partitions=1,
               use_pallas_attention=True)
NMT_PROG = dict(max_src_len=8, max_len=8, page_size=4, pool_pages=16,
                attn_impl="kernel")
# one-shot bursts: buckets 1, 4 and 8 of the default powers of two
BURSTS = [[0], [1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11]]
TIE = (5, 503)        # softmax rows in shard columns 0 and 1 of 1000


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_toy():
    def init_fn(rng):
        r1, r2 = jax.random.split(rng)
        return {"emb": jax.random.normal(r1, (32, 8)) * 0.5,
                "proj": {"w": jax.random.normal(r2, (8, 4)) * 0.5}}

    def loss_fn(params, batch):
        h = jemb.embedding_lookup(params["emb"], batch["ids"]) \
            @ params["proj"]["w"]
        return jnp.mean(h ** 2)

    return jpx.Model(init_fn, loss_fn, optimizer=optax.sgd(0.1))


def _jax_infer(params, batch):
    h = jemb.embedding_lookup(params["emb"], batch["ids"]) \
        @ params["proj"]["w"]
    return {"h": h, "n": h.sum(-1).sum(-1)}


def _jmesh(shape):
    return jmesh.build_mesh(jax.devices()[:shape[0] * shape[1]],
                            shape=shape)


def _config(**sc):
    return jpx.Config(serve_config=jpx.ServeConfig(**sc))


def _inputs():
    rng = np.random.default_rng(5)
    toy = _np_tree(_jax_toy().init_fn(jax.random.PRNGKey(0)))
    ids = [rng.integers(0, 32, (3,)).astype(np.int32) for _ in range(12)]
    jcfg = jnmt.tiny_config(**NMT_CFG, compute_dtype=jnp.float32)
    nmt_params = _np_tree(jnmt.build_model(jcfg).init_fn(
        jax.random.PRNGKey(1)))
    srcs = [rng.integers(3, 64, (n,)).astype(np.int32)
            for n in (6, 4, 8, 5, 7, 3)]
    caps = [8, 5, 7, 8, 4, 6]
    lcfg = jlm1b.tiny_config(compute_dtype=jnp.float32)
    lparams = _np_tree(jlm1b.build_model(lcfg).init_fn(
        jax.random.PRNGKey(3)))
    tied = jax.tree.map(np.array, lparams)
    for row in TIE:
        tied["softmax_w"][row] = 0.0
        tied["softmax_b"][row] = 100.0
    prompts = [rng.integers(1, 1000, (n,)).astype(np.int32)
               for n in (5, 8, 3, 6)]
    lcaps = [8, 6, 8, 7]
    lm1b_cases = [dict(params=p, prompts=prompts, caps=lcaps)
                  for p in (lparams, tied)]
    batch = {"ids": rng.integers(0, 32, (8, 3)).astype(np.int32),
             "y": rng.standard_normal((8, 3, 4)).astype(np.float32)}
    return dict(
        oneshot=dict(init=toy, ids=ids, bursts=BURSTS),
        nmt_case=dict(cfg=NMT_CFG, prog=NMT_PROG, params=nmt_params,
                      srcs=srcs, caps=caps),
        lm1b_cases=lm1b_cases,
        handoff=dict(init=toy, batch=batch, ids=ids[:6]))


def _jax_reference(shape, inp):
    mesh = _jmesh(shape)
    one = inp["oneshot"]
    with JServeSession(_jax_infer, one["init"],
                       example_feed={"ids": np.zeros((3,), np.int32)},
                       model=_jax_toy(), mesh=mesh,
                       config=_config(max_batch=8)) as s:
        oneshot = [s.submit({"ids": i}).result(timeout=120)
                   for i in one["ids"]]
        rows = s._params["emb"].sharding.shard_shape(
            s._params["emb"].shape)
    case = inp["nmt_case"]
    jcfg = jnmt.tiny_config(**NMT_CFG, compute_dtype=jnp.float32)
    with JServeSession(program=JNMTDecodeProgram(jcfg, **NMT_PROG),
                       params=case["params"], mesh=mesh,
                       config=_config(max_batch=4, max_queue=64)) as s:
        nmt = [np.asarray(s.submit({"src": x}, max_new_tokens=c)
                          .result(timeout=120))
               for x, c in zip(case["srcs"], case["caps"])]
    lm = []
    lcfg = jlm1b.tiny_config(compute_dtype=jnp.float32)
    for c in inp["lm1b_cases"]:
        with JServeSession(program=JLM1BDecodeProgram(lcfg, 8, 8),
                           params=c["params"], mesh=mesh,
                           config=_config(max_batch=4, max_queue=64)) as s:
            lm.append([np.asarray(s.submit({"ids": p}, max_new_tokens=k)
                                  .result(timeout=120))
                       for p, k in zip(c["prompts"], c["caps"])])
    return dict(oneshot=oneshot, oneshot_rows=tuple(rows), nmt=nmt,
                lm1b=lm)


def _ranks(shape, inp, tmp_path_factory):
    """The ranks' results on ``shape``, spawned once a test session."""
    world = shape[0] * shape[1]
    extra = dict(handoff=inp["handoff"], moe=True) if shape == (1, 2) \
        else {}

    def compute(tmp):
        return join_ranks(start_ranks(
            tmp, world, "serve_mesh", DEADLINE_S, shape=shape,
            oneshot=inp["oneshot"], nmt_case=inp["nmt_case"],
            lm1b_cases=inp["lm1b_cases"], **extra))

    return shared(tmp_path_factory, f"serve_mesh_{shape[0]}x{shape[1]}",
                  compute)


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)],
                ids=["mesh1x2", "mesh2x2"])
def runs(request, tmp_path_factory):
    shape = request.param
    inp = _inputs()
    ranks = _ranks(shape, inp, tmp_path_factory)
    ref = shared(tmp_path_factory, f"serve_mesh_ref_{shape[0]}x{shape[1]}",
                 lambda tmp: _jax_reference(shape, inp))
    return shape, inp, ref, ranks


@pytest.fixture(scope="module")
def runs_1x2(tmp_path_factory):
    inp = _inputs()
    return inp, _ranks((1, 2), inp, tmp_path_factory)


def test_oneshot_outputs_equal_jax(runs):
    shape, inp, ref, ranks = runs
    got = ranks[0]["oneshot"]["out"]
    assert len(got) == len(ref["oneshot"])
    for g, w in zip(got, ref["oneshot"]):
        for k in ("h", "n"):
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=RTOL,
                                       atol=ATOL)


def test_each_rank_holds_its_rows(runs):
    shape, _, ref, ranks = runs
    V, p = 32, shape[1]
    assert ref["oneshot_rows"] == (V // p, 8)
    for r in ranks:
        assert r["oneshot"]["rows"] == (V // p, 8)
        assert r["nmt"]["rows"] == (64 // p, 16)
        assert all(c["rows"] == (1000 // p, 32) for c in r["lm1b"])


def test_buckets_split_when_they_divide_the_ranks(runs):
    shape, _, _, ranks = runs
    world = shape[0] * shape[1]
    want = {b: b % world == 0 for b in (1, 2, 4, 8)}
    for r in ranks:
        assert r["oneshot"]["split"] == want


def test_decode_tokens_identical_to_jax(runs):
    _, inp, ref, ranks = runs
    lead = ranks[0]
    for g, w in zip(lead["nmt"]["out"], ref["nmt"]):
        np.testing.assert_array_equal(g, w)
    for case_got, case_want in zip(lead["lm1b"], ref["lm1b"]):
        for g, w in zip(case_got["out"], case_want):
            np.testing.assert_array_equal(g, w)
    # the forced tie: both rows score 100 every step, the lower id wins
    tied = [t for out in lead["lm1b"][1]["out"] for t in out.tolist()]
    assert set(tied) == {TIE[0]}


def test_leader_and_followers(runs):
    _, _, _, ranks = runs
    cases = [r["oneshot"] for r in ranks] + [r["nmt"] for r in ranks] + \
        [c for r in ranks for c in r["lm1b"]]
    assert all(c["closed"] for c in cases)
    for c in cases[:1] + [r["nmt"] for r in ranks[:1]]:
        assert c["recompiles"] == 0
    for r in ranks[1:]:
        for c in [r["oneshot"], r["nmt"]] + r["lm1b"]:
            assert "leader" in c["submit"]


def test_close_releases_the_mesh_graphs(runs):
    """``close()`` over more than one rank destroys the session's graphs
    (on a card they hold the mesh's NCCL communicators, and
    ``destroy_process_group`` waits for every graph that does): the
    decode programs' on every rank, the one-shot signatures' on the
    leader (where stand-ins were planted)."""
    _, _, _, ranks = runs
    for rank, r in enumerate(ranks):
        decode = [r["nmt"]] + r["lm1b"]
        assert all(c["released"] == [True, True] for c in decode), rank
        want = [True] * len(r["oneshot"]["split"]) if rank == 0 else []
        assert r["oneshot"]["released"] == want, rank


def test_serve_handoff_uses_engine_tensors(runs_1x2):
    inp, ranks = runs_1x2
    for r in ranks:
        h = r["handoff"]
        assert h["same"] and h["closed"]
        assert h["rows"] == (16, 8)
    lead = ranks[0]["handoff"]
    whole = lead["whole"]
    assert lead["recompiles"] == 0
    for ids, got in zip(inp["handoff"]["ids"], lead["out"]):
        want = _jax_infer({"emb": whole["emb"], "proj": {"w": whole["w"]}},
                          {"ids": ids})
        np.testing.assert_allclose(got["h"], np.asarray(want["h"]),
                                   rtol=RTOL, atol=ATOL)


def test_moe_expert_placement_refused(runs_1x2):
    _, ranks = runs_1x2
    for r in ranks:
        assert r["moe"] is not None and "all_to_all" in r["moe"]
