"""The port's switch-MoE LM against the JAX package's.

fp32 throughout, ``tiny_config`` (vocab 512, D 32, 2 heads, expert_dim
64, 8 experts, 2 layers, max_len 32), weights carried from the JAX
initial tree with ``moe_lm_params_from_jax``.

(a) One process: the loss, its three metrics and every gradient of the
    port's ``loss_fn`` against ``jax.value_and_grad`` of the JAX
    ``loss_fn`` on one 4 x 16 batch, within 1e-5 of each leaf's peak, for
    the plain core and ``use_pallas_attention`` (Pallas interpret mode on
    the JAX side); no mesh, so the MoE is the dense path on both sides.
(b) Three ``sess.run`` steps of ``parallel_run`` HYBRID on one process
    against the JAX session on its 8 emulated devices with
    ``num_partitions=1`` (a (8, 1) mesh: the dense MoE, as on one rank):
    losses and metrics at rtol 1e-4, every parameter within 1e-4.
(c) Three steps on 4 gloo ranks (``torch_dist_ranks.moe_models``), rank
    ``r * shard + s`` holding the JAX mesh's device ``(r, s)`` and its
    rows of 8 x 16 batches, on (1, 4) and (2, 2): the capacity path's
    all-to-all dispatch (5 slots an expert a rank, so pairs drop), held
    to the JAX engine of the same model on the same mesh with the model's
    clip + Adam and again with SGD (lr 0.1; Adam hides a gradient scaled
    by a constant), and top-2 routing on (2, 2) with Adam: losses,
    ``lm_loss``, ``aux_loss`` and ``moe_dropped`` at rtol 1e-4, every
    parameter of ``gather_params()`` within 1e-4 of its peak. Each rank holds E/n experts (``expert_sharded``), ``emb``
    its rows; a step issues four ``all_to_all``s a layer (forward and
    backward). Six experts on (1, 4) warn and replicate, and the dense
    fallback runs (no all-to-all), against JAX's engine too.
(d) ``MoeLMDecodeProgram``, dense and paged, against JAX's: the prefill's
    K/V, ``base`` and ``first``, the caches after two inserts, and two
    decode steps' logits, within 1e-5; then 24 requests on 8 slots whose
    served tokens equal both ``standalone_greedy``s.
(e) The engine's rule for expert weights (an ``ExpertSpec`` on a sparse
    table, and the non-default batch layouts, are refused), the config's
    defaults against JAX's, and one rank's weights.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as tpt
from parallax_tpu.core import engine as jengine
from parallax_tpu.core import mesh as jmesh
from parallax_tpu.models import moe_lm as jmoe
from parallax_tpu.serve import adapters as jadapters
from parallax_tpu_torch import weights
from parallax_tpu_torch.core import engine as tengine, mesh as tmesh
from parallax_tpu_torch.core.classify import flatten
from parallax_tpu_torch.models import moe_lm as tmoe
from parallax_tpu_torch.serve import adapters as tadapters
from test_torch_dist import (_flat, _jax_config, join_ranks, shared,
                             start_ranks)

STEPS = 3
SGD_LR = 0.1
BATCH, SEQ = 8, 16


def _jax_params(cfg):
    params = jmoe.build_model(cfg).init_fn(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _close(got, want, what, tol=1e-5):
    want = np.asarray(want)
    peak = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * peak, err_msg=what)


def _batches(vocab=512):
    rng = np.random.default_rng(7)
    return [jmoe.make_batch(rng, BATCH, SEQ, vocab) for _ in range(STEPS)]


# -- (a) one process ----------------------------------------------------------


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "flash"])
def test_loss_and_gradients_match_jax(pallas):
    jcfg = jmoe.tiny_config(compute_dtype=jnp.float32,
                            use_pallas_attention=pallas)
    init = _jax_params(jcfg)
    batch = jmoe.make_batch(np.random.default_rng(0), 4, 16, jcfg.vocab_size)
    jmodel = jmoe.build_model(jcfg)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, batch, jax.random.PRNGKey(1)),
        has_aux=True))(init)

    tcfg = tmoe.tiny_config(compute_dtype=torch.float32,
                            use_pallas_attention=pallas)
    params = weights.moe_lm_params_from_jax(init, tcfg, "cpu")
    leaves = dict(flatten(params))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    loss, aux = tmoe.build_model(tcfg).loss_fn(
        params, {"ids": torch.from_numpy(batch["ids"])})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-6)
    assert set(aux) == set(jaux) == {"lm_loss", "aux_loss", "moe_dropped"}
    for k in aux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    want = _flat(jgrads)
    assert set(want) == set(leaves)
    for (path, _), g in zip(leaves.items(), grads):
        _close(g.numpy(), want[path], path)


# -- (b) the one-process session against the JAX session --------------------


@pytest.fixture(scope="module")
def jax_session():
    jcfg = jmoe.tiny_config(compute_dtype=jnp.float32)
    batches = _batches()
    jsess, *_ = jparallax.parallel_run(
        jmoe.build_model(jcfg), num_partitions=1, seed=0,
        parallax_config=jparallax.Config(run_option="HYBRID",
                                         search_partitions=False))
    try:
        jsess.prepare(batches[0])
        assert dict(jsess.engine.mesh.shape) == {"repl": 8, "shard": 1}
        init = jax.tree.map(np.asarray, jsess.state.params)
        outs = [jsess.run(["loss", "lm_loss", "aux_loss", "moe_dropped"],
                          feed_dict=b) for b in batches]
        final = _flat(jsess.state.params)
    finally:
        jsess.close()
    return batches, init, [[float(v) for v in o] for o in outs], final


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "flash"])
def test_three_session_steps_match_jax(jax_session, pallas):
    batches, init, jouts, jfinal = jax_session
    tcfg = tmoe.tiny_config(compute_dtype=torch.float32,
                            use_pallas_attention=pallas)
    sess, *_ = tpt.parallel_run(
        tmoe.build_model(tcfg), device="cpu", seed=0,
        parallax_config=tpt.Config(run_option="HYBRID"))
    sess.prepare(batches[0])
    carried = dict(flatten(weights.moe_lm_params_from_jax(init, tcfg,
                                                          "cpu")))
    with torch.no_grad():
        for path, leaf in flatten(sess.state.params):
            leaf.copy_(carried[path])
    outs = [[float(v) for v in sess.run(
        ["loss", "lm_loss", "aux_loss", "moe_dropped"], feed_dict=b)]
        for b in batches]
    np.testing.assert_allclose(outs, jouts, rtol=1e-4, atol=1e-7)
    assert all(o[3] == 0.0 for o in outs)
    final = {p: t.detach().numpy() for p, t in flatten(sess.state.params)}
    assert set(final) == set(jfinal)
    for path, want in jfinal.items():
        _close(final[path], want, path, tol=1e-4)
    sess.close()


# -- (c) trajectories on gloo ranks -------------------------------------------

OPTS = ("own", "sgd")
# name: (config kwargs, (repl, shard), optimizers). Top-2 runs with the
# model's Adam alone: with SGD its third step puts a layer-1
# pre-activation of expert 3 within 5e-8 of the ReLU kink, where fp32
# rounding picks the side and that expert's w1 update moves by 1 %
# (on both sides of the comparison alike: the kink, not the dispatch)
RUNS = {"ep_1x4": ({}, (1, 4), OPTS), "ep_2x2": ({}, (2, 2), OPTS),
        "ep_top2_2x2": (dict(top_k=2), (2, 2), ("own",)),
        "six_experts_1x4": (dict(num_experts=6), (1, 4), OPTS)}
CASES = [(name, opt) for name, (_, _, opts) in RUNS.items()
         for opt in opts]
FETCHES = ("loss", "lm_loss", "aux_loss", "moe_dropped")


def _jax_run(cfg_kw, shape, batches, sgd=False, init=None):
    """Metrics by step and the final parameters of the JAX engine on a
    ``shape`` mesh of CPU devices, and its initial parameters."""
    cfg = jmoe.tiny_config(compute_dtype=jnp.float32, **cfg_kw)
    model = jmoe.build_model(cfg)
    if sgd:
        model.optimizer = optax.sgd(SGD_LR)
    mesh = jmesh.build_mesh(jax.devices()[:shape[0] * shape[1]],
                            shape=shape)
    eng = jengine.Engine(model, mesh, _jax_config(run_option="HYBRID"),
                         batches[0])
    state = eng.init_state(0)
    if init is not None:
        state = state.replace(params=jax.device_put(
            init, jax.tree.map(lambda a: a.sharding, state.params)))
    first = jax.tree.map(np.asarray, state.params)
    outs = {k: [] for k in FETCHES}
    for b in batches:
        state, out = eng.step(state, b)
        for k in FETCHES:
            outs[k].append(float(out[k]))
    return first, outs, _flat(state.params), eng.plan


def _model_runs(tmp):
    batches = _batches()
    inits = {name: _jax_params(jmoe.tiny_config(
        compute_dtype=jnp.float32, **kw)) for name, (kw, _, _) in
        RUNS.items()}
    runs = [(f"{name}/{opt}", RUNS[name][0], RUNS[name][1],
             SGD_LR if opt == "sgd" else None, inits[name], batches)
            for name, opt in CASES]
    handle = start_ranks(tmp, 4, "moe_models", deadline_s=240, runs=runs)
    oracle = {}
    for name, opt in CASES:
        kw, shape, _ = RUNS[name]
        _, outs, final, _ = _jax_run(kw, shape, batches, sgd=opt == "sgd",
                                     init=inits[name])
        oracle[f"{name}/{opt}"] = (outs, final)
    return oracle, join_ranks(handle)


@pytest.fixture(scope="module")
def model_runs(tmp_path_factory):
    return shared(tmp_path_factory, "moe_models", _model_runs)


@pytest.mark.parametrize("name,opt", CASES,
                         ids=[f"{n}-{o}" for n, o in CASES])
def test_trajectory_matches_jax(model_runs, name, opt):
    oracle, ranks = model_runs
    kw, (repl, shard), _ = RUNS[name]
    want, want_params = oracle[f"{name}/{opt}"]
    E = kw.get("num_experts", 8)
    ep = E % shard == 0
    for k, r in enumerate(ranks):
        got = r[f"{name}/{opt}"]
        assert got["mesh"] == (repl, shard, divmod(k, shard))
        for key in FETCHES:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-7, err_msg=key)
        assert set(got["params"]) == set(want_params)
        for path, w in want_params.items():
            _close(got["params"][path], w, path, tol=1e-4)
        pl = got["placements"]
        assert pl["emb"] == "row_sharded"
        assert pl["blocks/0/moe_w1"] == pl["blocks/1/moe_w2"] == \
            ("expert_sharded" if ep else "replicated")
        assert got["local_shapes"]["blocks/0/moe_w1"] == \
            ((E // shard if ep else E), 32, 64)
        assert got["local_shapes"]["blocks/1/moe_w2"] == \
            ((E // shard if ep else E), 64, 32)
        assert got["counts"]["all_to_all"] == (4 * 2 if ep else 0)
    if ep and kw.get("top_k", 1) == 1:
        assert max(want["moe_dropped"]) > 0


# -- (d) serving --------------------------------------------------------------

TS, CAP, PS, POOL = 8, 12, 4, 16
PAGED = dict(page_size=PS, pool_pages=POOL)


def _programs(paged):
    jcfg = jmoe.tiny_config(compute_dtype=jnp.float32)
    jparams = jmoe.build_model(jcfg).init_fn(jax.random.PRNGKey(0))
    tcfg = tmoe.tiny_config(compute_dtype=torch.float32)
    tparams = weights.moe_lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    kw = dict(PAGED, attn_impl="kernel") if paged else {}
    jkw = dict(PAGED, attn_impl="einsum") if paged else {}
    return (jadapters.MoeLMDecodeProgram(jcfg, TS, CAP, **jkw), jparams,
            tpt.MoeLMDecodeProgram(tcfg, TS, CAP, device="cpu", **kw),
            tparams)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_program_matches_jax(paged):
    jprog, jparams, tprog, tparams = _programs(paged)
    prompts = [np.arange(1, 6, dtype=np.int32) * 7,
               np.arange(1, 9, dtype=np.int32) * 5]
    jstate = jprog.init_state(jparams, 2)
    tstate = tprog.init_state(tparams, 2)
    rows = []
    for j, ids in enumerate(prompts):
        jfeed = jprog.prepare_feed({"ids": ids})
        tfeed = tprog.prepare_feed({"ids": ids})
        jrs = jprog.prefill(jparams, jfeed)
        trs = tprog.prefill(tparams, tfeed)
        for key in ("pk", "pv", "base", "first"):
            _close(trs[key], jrs[key], key)
        if paged:
            row = np.full(((TS + CAP) // PS,), POOL, np.int32)
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
    pages = np.stack(rows) if paged else None
    tok = np.zeros((2,), np.int32)
    for t in range(2):
        tt = np.full((2,), t, np.int32)
        kw = dict(pages=jnp.asarray(pages), page_size=PS,
                  attn_impl="einsum") if paged else {}
        jlog, jkc, jvc = jmoe._decode_step_cached(
            jprog.cfg, jparams, jnp.asarray(tok), jnp.asarray(tt),
            jstate["base"], jstate["first"], jstate["kc"], jstate["vc"],
            **kw)
        jstate = dict(jstate, kc=jkc, vc=jvc)
        tkw = dict(pages=torch.from_numpy(pages), page_size=PS,
                   attn_impl="kernel") if paged else {}
        tlog, _, _ = tmoe._decode_step_cached(
            tprog.cfg, tparams, torch.from_numpy(tok), torch.from_numpy(tt),
            tstate["base"], tstate["first"], tstate["kc"], tstate["vc"],
            **tkw)
        _close(tlog, jlog, f"logits step {t}")
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_served_tokens_equal_both_standalone_greedies(paged):
    jprog, jparams, tprog, tparams = _programs(paged)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, (int(rng.integers(1, TS + 1)),))
               .astype(np.int32) for _ in range(24)]
    caps = [int(c) for c in np.random.default_rng(4).integers(4, CAP + 1,
                                                             24)]
    serve = tpt.ServeConfig(max_batch=8, max_queue=64)
    with tpt.ServeSession(program=tprog, params=tparams, device="cpu",
                          config=tpt.Config(serve_config=serve)) as sess:
        reqs = [sess.submit({"ids": p}, max_new_tokens=c)
                for p, c in zip(prompts, caps)]
        outs = [r.result(timeout=120) for r in reqs]
    stats = sess.stats()
    assert stats["serve.completed"] == 24
    if paged:
        assert stats["serve.kv_pages_in_use"] == 0
    for p, c, out in zip(prompts, caps, outs):
        want = jadapters.standalone_greedy(jprog, jparams, {"ids": p}, c)
        mine = tadapters.standalone_greedy(tprog, tparams, {"ids": p}, c)
        assert mine == want
        assert out.tolist() == want


# -- (e) the engine's rule, the config, one rank's weights -------------------


def test_expert_spec_rules():
    cfg = tmoe.tiny_config()
    model = tmoe.build_model(cfg)
    batch = {"ids": np.ones((4, 8), np.int32)}
    mesh = tmesh.Mesh(torch.device("cpu"), repl=1, shard=2)
    eng = tengine.Engine(model, mesh, tpt.Config(run_option="HYBRID"),
                         batch)
    pl = eng.plan.placements
    assert pl["blocks/0/moe_w1"] == "expert_sharded"
    assert pl["blocks/0/router"] == "replicated"
    assert pl["emb"] == "row_sharded"
    assert eng.plan.gathered == []
    # an expert spec on a table read only through embedding_lookup
    bad = tmoe.build_model(cfg)
    bad.param_specs = {"emb": tmesh.ExpertSpec("shard", None)}
    with pytest.raises(ValueError, match="sparse tables"):
        tengine.Engine(bad, mesh, tpt.Config(run_option="HYBRID"), batch)
    repl = tmoe.build_model(cfg)
    repl.batch_specs = {"ids": tmesh.P("repl", None)}
    with pytest.raises(NotImplementedError, match="default layout"):
        tengine.Engine(repl, mesh, tpt.Config(run_option="HYBRID"), batch)
    one = tengine.Engine(model, tmesh.Mesh(torch.device("cpu")),
                         tpt.Config(run_option="HYBRID"), batch)
    assert set(one.plan.placements.values()) == {"replicated"}


def test_config_defaults_and_rank_weights():
    got, want = tmoe.MoeLMConfig(), jmoe.MoeLMConfig()
    for field in ("vocab_size", "model_dim", "num_heads", "expert_dim",
                  "num_experts", "num_layers", "max_len", "capacity_factor",
                  "top_k", "aux_loss_weight", "use_pallas_attention",
                  "learning_rate", "num_partitions"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.compute_dtype == torch.bfloat16
    jcfg = jmoe.tiny_config()
    init = _jax_params(jcfg)
    cfg = tmoe.tiny_config()
    mesh = tmesh.Mesh(torch.device("cpu"), repl=1, shard=4, rank=3)
    eng = tengine.Engine(tmoe.build_model(cfg), mesh,
                         tpt.Config(run_option="HYBRID"),
                         {"ids": np.ones((4, 8), np.int32)})
    mine = dict(flatten(weights.moe_lm_params_from_jax(init, cfg, "cpu",
                                                       engine=eng)))
    np.testing.assert_array_equal(mine["blocks/1/moe_w1"].numpy(),
                                  init["blocks"][1]["moe_w1"][6:8])
    np.testing.assert_array_equal(mine["emb"].numpy(), init["emb"][384:])
    np.testing.assert_array_equal(mine["blocks/0/router"].numpy(),
                                  init["blocks"][0]["router"])
    short = dict(init, blocks=init["blocks"][:1])
    with pytest.raises(ValueError, match="blocks"):
        weights.moe_lm_params_from_jax(short, cfg, "cpu")
    bad = dict(init, out_w=init["out_w"][:, :-1])
    with pytest.raises(ValueError, match="out_w"):
        weights.moe_lm_params_from_jax(bad, cfg, "cpu")
