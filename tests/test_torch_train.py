"""The port's training slice as a whole against the JAX package's:
``parallel_run`` -> engine -> slices-mode Adagrad, three steps of
``tiny_config`` in fp32 through both packages' sessions.

The port starts from the JAX initial parameters
(``lm1b_params_from_jax``). Each step's sampled-softmax candidates are
the JAX session's own — ``log_uniform_candidates`` of
``split(fold_in(PRNGKey(seed + 1), step))[1]`` (engine.py:598, :603,
lm1b.py:174-175) — handed to the port's sampler with ``monkeypatch``.
keep_prob is 1, so no other randomness enters. Per-step losses and the
final parameters agree to 1e-4 relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as tparallax
from parallax_tpu.core import classify as jclassify
from parallax_tpu.models import lm1b as jlm1b
from parallax_tpu.ops import sampled_softmax as jss
from parallax_tpu_torch.core import classify as tclassify
from parallax_tpu_torch.models import lm1b as tlm1b
from parallax_tpu_torch.ops import sampled_softmax as tss
from parallax_tpu_torch.weights import lm1b_params_from_jax

SEED = 0
STEPS = 3
CFG = dict(num_partitions=8, keep_prob=1.0, sparse_grad_mode="slices")


def _batches(vocab):
    rng = np.random.default_rng(0)
    return [jlm1b.make_batch(rng, 16, 6, vocab) for _ in range(STEPS)]


def _jax_step_candidates(cfg):
    base = jax.random.PRNGKey(SEED + 1)
    out = []
    for step in range(STEPS):
        _drop, samp = jax.random.split(jax.random.fold_in(base, step))
        out.append(np.asarray(jss.log_uniform_candidates(
            samp, cfg.num_samples, cfg.vocab_size)))
    return out


def _feed_candidates(monkeypatch, ids_list):
    it = iter(ids_list)

    def fake(gen, num_samples, vocab_size, device=None):
        if torch.device(device).type == "meta":   # the classifier's pass
            return torch.zeros((num_samples,), dtype=torch.long,
                               device="meta")
        return torch.tensor(next(it), dtype=torch.long, device=device)

    monkeypatch.setattr(tss, "log_uniform_candidates", fake)


def _config(pkg):
    kw = dict(run_option="HYBRID", sparse_grad_mode="slices")
    if pkg is jparallax:
        kw["search_partitions"] = False
    return pkg.Config(**kw)


def test_three_steps_match_jax_session(monkeypatch):
    jcfg = jlm1b.tiny_config(**CFG, compute_dtype=jnp.float32)
    tcfg = tlm1b.tiny_config(**CFG, compute_dtype=torch.float32,
                             lstm_impl="kernel")
    batches = _batches(jcfg.vocab_size)

    jsess, *_ = jparallax.parallel_run(jlm1b.build_model(jcfg),
                                       parallax_config=_config(jparallax),
                                       seed=SEED)
    try:
        jsess.prepare(batches[0])
        jinit = jax.tree.map(np.asarray, jsess.state.params)
        jlosses = [float(jsess.run("loss", feed_dict=b)) for b in batches]
        jfinal = {jclassify._pathname(k): np.asarray(v) for k, v in
                  jax.tree_util.tree_flatten_with_path(
                      jsess.state.params)[0]}
    finally:
        jsess.close()

    _feed_candidates(monkeypatch, _jax_step_candidates(jcfg))
    tsess, *rest = tparallax.parallel_run(
        tlm1b.build_model(tcfg), parallax_config=_config(tparallax),
        seed=SEED, device="cpu")
    assert rest == [1, 0, 1]
    assert tsess.prepare(batches[0]) == 0
    carried = dict(tclassify.flatten(lm1b_params_from_jax(jinit, tcfg,
                                                          "cpu")))
    with torch.no_grad():
        for path, leaf in tclassify.flatten(tsess.state.params):
            leaf.copy_(carried[path])
    out = [tsess.run(["loss", "global_step", "words"], feed_dict=b)
           for b in batches]
    tlosses = [float(o[0]) for o in out]
    assert [int(o[1]) for o in out] == [1, 2, 3]
    assert all(float(o[2]) == 16 * 6 for o in out)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    tfinal = {p: t.detach().numpy()
              for p, t in tclassify.flatten(tsess.state.params)}
    assert set(tfinal) == set(jfinal)
    for path, want in jfinal.items():
        np.testing.assert_allclose(tfinal[path], want, rtol=1e-4,
                                   atol=1e-6, err_msg=path)
    # embedding rows that no batch looked up keep their initial values
    touched = set(np.concatenate([b["x"].ravel() for b in batches]))
    emb0 = carried["emb"].numpy()
    untouched = [r for r in range(tcfg.padded_vocab) if r not in touched]
    np.testing.assert_array_equal(tfinal["emb"][untouched],
                                  emb0[untouched])
    tsess.close()


def _session(device="cpu", **cfg_kw):
    cfg = tlm1b.tiny_config(**{**CFG, **cfg_kw})
    sess, *_ = tparallax.parallel_run(tlm1b.build_model(cfg),
                                      parallax_config=_config(tparallax),
                                      device=device)
    return cfg, sess


def test_plan_routes_tables_to_slices_and_lstm_to_the_optimizer():
    cfg, sess = _session(lstm_impl="kernel")
    batch = _batches(cfg.vocab_size)[0]
    sess.prepare(batch)
    eng = sess.engine
    assert {p for p, s in eng.plan.var_specs.items() if s.is_sparse} == \
        {"emb", "softmax_w", "softmax_b"}
    # one rank, one shard: the tables stay whole (build_plan row-shards
    # only over a shard axis wider than 1, as the JAX plan)
    assert eng.plan.placements["emb"] == "replicated"
    assert eng.plan.placements["lstm/w"] == "replicated"
    assert sorted(sess.state.slice_state) == ["emb", "softmax_b",
                                              "softmax_w"]
    acc = sess.state.slice_state["emb"]
    assert acc.dtype == torch.float32 and bool((acc == 1.0).all())
    before = {p: t.detach().clone()
              for p, t in tclassify.flatten(sess.state.params)}
    sess.run("loss", feed_dict=batch)
    ids = set(batch["x"].ravel())
    changed = (sess.state.params["emb"] != before["emb"]).any(dim=1)
    assert set(np.flatnonzero(changed.numpy())) <= ids
    for p in ("lstm/w", "lstm/w_proj"):
        assert not torch.equal(dict(tclassify.flatten(
            sess.state.params))[p], before[p])
    # the dense group's optimizer state holds only the LSTM group
    rss = sess.state.opt_state[1][0]
    assert sorted(rss) == ["lstm/b", "lstm/w", "lstm/w_proj"]
    sess.close()


def test_run_iter_fetch_and_evaluate():
    cfg, sess = _session(lstm_impl="kernel")
    batches = _batches(cfg.vocab_size)
    outs = list(sess.run_iter(iter(batches), fetches=["loss", "words"]))
    assert len(outs) == STEPS and sess.state.step == STEPS
    loss = outs[-1][0]
    assert isinstance(loss, tparallax.Fetch) and loss.done()
    assert np.isfinite(float(loss)) and loss.shape == ()
    assert float(outs[0][1]) == 16 * 6
    step = sess.state.step
    held = sess.evaluate(batches[0])
    assert np.isfinite(float(held)) and sess.state.step == step
    with pytest.raises(KeyError, match="available"):
        sess.run("nope", feed_dict=batches[0])
    snap = sess.metrics_snapshot()
    assert snap["session.steps"] == STEPS + 1
    assert snap["engine.builds"] == 1
    sess.close()


def test_feed_contract_per_replica_lists():
    cfg, sess = _session()
    b = _batches(cfg.vocab_size)[0]
    out = sess.run("words", feed_dict={k: [v] for k, v in b.items()})
    assert float(out) == 16 * 6
    with pytest.raises(ValueError, match="num_replicas_per_worker"):
        sess.run("loss", feed_dict={k: [v, v] for k, v in b.items()})
    sess.close()


def test_entry_points_default_to_the_card_and_refuse_what_is_not_ported():
    model = tlm1b.build_model(tlm1b.tiny_config())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tparallax.parallel_run(model)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tlm1b.init_params(tlm1b.tiny_config(), torch.Generator())
    # remote hosts need the ssh launcher, which is not ported
    with pytest.raises(NotImplementedError, match="remote hosts"):
        tparallax.parallel_run(model, resource_info="a:0;b:0",
                               device="cpu")
    # sync=False and num_partitions run (one process: one rank, so the
    # partition count snaps to 1)
    batch = tlm1b.make_batch(np.random.default_rng(0), 4, 3, 1000)
    for kw in (dict(sync=False), dict(num_partitions=4)):
        sess, *rest = tparallax.parallel_run(
            tlm1b.build_model(tlm1b.tiny_config()), device="cpu", **kw)
        assert rest == [1, 0, 1]
        assert math.isfinite(float(sess.run("loss", feed_dict=batch)))
        assert sess.mesh.shape == {"repl": 1, "shard": 1}
        sess.close()
    # a stateful model on more than one rank builds (cross-rank
    # BatchNorm, tests/test_torch_pipeline.py); pipeline_info is kept and
    # value_and_grad_fn replaces autograd, but takes no slice_updaters;
    # and tensor-parallel specs on a shard axis of 2 whose batch is not on
    # 'repl' alone are refused (on one rank a tensor-parallel spec
    # replicates)
    from parallax_tpu_torch.core import engine as tengine, mesh as tmesh
    two = tmesh.Mesh(torch.device("cpu"), repl=2, shard=1)
    eng = tengine.Engine(tparallax.cnn.build_model("resnet50_v1.5",
                                                   image_size=32), two,
                         tparallax.Config(run_option="AR"),
                         tparallax.cnn.make_batch(
                             np.random.default_rng(0), 2, 32, 1000))
    assert eng.model.stateful and eng.mesh.size == 2
    piped = tlm1b.build_model(tlm1b.tiny_config())
    piped.pipeline_info = {"stages": 2}
    sess = tparallax.parallel_run(piped, device="cpu")[0]
    sess.prepare(batch)
    assert sess.engine.model.pipeline_info == {"stages": 2}
    sess.close()
    calls = []

    def vag(params, feed, gen):
        calls.append(sorted(feed))
        leaf = params["lstm"]["w"]
        return leaf.sum() * 0.0, {}, {"lstm": {"w": torch.ones_like(leaf)}}

    fused = tlm1b.build_model(tlm1b.tiny_config(learning_rate=0.5))
    fused.value_and_grad_fn = vag
    sess = tparallax.parallel_run(fused, device="cpu")[0]
    sess.prepare(batch)
    w0 = sess.state.params["lstm"]["w"].detach().clone()
    emb0 = sess.state.params["emb"].detach().clone()
    assert float(sess.run("loss", feed_dict=batch)) == 0.0
    assert calls == [["w", "x", "y"]]
    # the given gradient is applied, every other one is zero: the clip
    # scales the ones to a norm of 10, then Adagrad's first step is
    # lr g / sqrt(1 + g^2) per entry
    g = 10.0 / np.sqrt(w0.numel())
    assert torch.allclose(sess.state.params["lstm"]["w"],
                          w0 - 0.5 * g / np.sqrt(1.0 + g * g))
    assert torch.equal(sess.state.params["emb"], emb0)
    sess.close()
    fused.slice_updaters = {"emb": object()}
    with pytest.raises(ValueError, match="value_and_grad_fn"):
        tparallax.parallel_run(fused, device="cpu")[0].prepare(batch)
    tp = tlm1b.build_model(tlm1b.tiny_config())
    tp.param_specs["emb"] = tmesh.P(None, "shard")
    sess = tparallax.parallel_run(tp, device="cpu")[0]
    sess.prepare(batch)
    assert sess.engine.plan.placements["emb"] == "replicated"
    sess.close()
    wide = tmesh.Mesh(torch.device("cpu"), repl=1, shard=2)
    with pytest.raises(NotImplementedError, match="batch_specs"):
        tengine.Engine(tp, wide, tparallax.Config(run_option="HYBRID"),
                       batch)
    with pytest.raises(ValueError, match="sparse_grad_mode"):
        tparallax.Config(sparse_grad_mode="Slices")
    assert tparallax.Config(run_option="ps").run_option == "SHARD"
    with pytest.raises(ValueError, match="run_option"):
        tparallax.Config(run_option="ring")


def _slice_table_read_by_a_gather_models():
    """The same model in both packages: ``emb`` registered for slice
    updates but read through a plain gather (``torch.index_select`` /
    ``jnp.take``), never through ``embedding_lookup``."""
    from parallax_tpu.core.engine import Model as JModel
    from parallax_tpu.ops.sparse_optim import SliceAdagrad as JSliceAdagrad
    from parallax_tpu_torch.core.engine import Model as TModel
    from parallax_tpu_torch.ops.sparse_optim import SliceAdagrad

    def t_init(gen, device):
        return {"emb": torch.ones((16, 4), device=device),
                "w": torch.ones((4,), device=device)}

    def t_loss(params, batch):
        rows = torch.index_select(params["emb"], 0, batch["ids"])
        return (rows @ params["w"]).sum()

    def j_init(rng):
        return {"emb": jnp.ones((16, 4)), "w": jnp.ones((4,))}

    def j_loss(params, batch):
        return jnp.sum(jnp.take(params["emb"], batch["ids"], axis=0)
                       @ params["w"])

    tmodel = TModel(t_init, t_loss, slice_updaters={"emb": SliceAdagrad(
        0.1, initial_accumulator_value=1.0)})
    jmodel = JModel(j_init, j_loss, slice_updaters={"emb": JSliceAdagrad(
        0.1, initial_accumulator_value=1.0)})
    return tmodel, jmodel


def test_slice_table_read_outside_embedding_lookup_is_refused():
    """A slice-updated table that no embedding_lookup reads would never
    be trained: both engines refuse it when the step is built."""
    tmodel, jmodel = _slice_table_read_by_a_gather_models()
    batch = {"ids": np.array([1, 3, 3, 7], np.int64)}
    msg = "no embedding_lookup of those tables was traced"
    jsess, *_ = jparallax.parallel_run(jmodel,
                                       parallax_config=_config(jparallax))
    try:
        with pytest.raises(ValueError, match=msg):
            jsess.prepare({"ids": batch["ids"].astype(np.int32)})
    finally:
        jsess.close()
    tsess, *_ = tparallax.parallel_run(tmodel,
                                       parallax_config=_config(tparallax),
                                       device="cpu")
    with pytest.raises(ValueError, match=msg):
        tsess.prepare(batch)
    tsess.close()


def _linear_models():
    """y = x . w + b with a squared loss, fixed initial values, SGD, in
    both packages."""
    import optax

    from parallax_tpu.core.engine import Model as JModel
    from parallax_tpu_torch.core import optim as toptim
    from parallax_tpu_torch.core.engine import Model as TModel
    w0, b0 = [0.5, -0.25, 1.0], 0.1

    def t_init(gen, device):
        return {"w": torch.tensor(w0, device=device),
                "b": torch.tensor(b0, device=device)}

    def t_loss(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return ((pred - batch["y"]) ** 2).mean()

    def j_init(rng):
        return {"w": jnp.asarray(w0, jnp.float32),
                "b": jnp.asarray(b0, jnp.float32)}

    def j_loss(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return jnp.mean((pred - batch["y"]) ** 2)

    return (TModel(t_init, t_loss, optimizer=toptim.sgd(0.1)),
            JModel(j_init, j_loss, optimizer=optax.sgd(0.1)))


def test_float64_feeds_train_as_float32():
    """numpy's default float64 feeds run as float32 (the JAX session
    runs them so with x64 off): the float32 feeds' losses to the bit,
    and the JAX session's within 1e-5; a float64 tensor feed too."""
    rng = np.random.default_rng(0)
    feeds = [{"x": rng.standard_normal((8, 3)),
              "y": rng.standard_normal((8,))} for _ in range(STEPS)]
    assert feeds[0]["x"].dtype == np.float64

    def port_losses(convert):
        tmodel, _ = _linear_models()
        sess, *_ = tparallax.parallel_run(tmodel, device="cpu")
        out = [sess.run("loss", feed_dict={k: convert(v)
                                           for k, v in f.items()})
               for f in feeds]
        dtypes = {p: t.dtype for p, t in sess.state.params.items()}
        sess.close()
        return [float(x) for x in out], dtypes

    f64, dt64 = port_losses(lambda v: v)
    f32, dt32 = port_losses(lambda v: v.astype(np.float32))
    t64, _ = port_losses(torch.from_numpy)
    assert dt64 == dt32 == {"w": torch.float32, "b": torch.float32}
    assert f64 == f32 == t64
    _, jmodel = _linear_models()
    jsess, *_ = jparallax.parallel_run(jmodel,
                                       parallax_config=_config(jparallax))
    try:
        jlosses = [float(jsess.run("loss", feed_dict=f)) for f in feeds]
    finally:
        jsess.close()
    np.testing.assert_allclose(f64, jlosses, rtol=1e-5, atol=1e-6)


def test_step_keeps_every_state_tensor_in_place():
    """The property a captured graph of the step needs: after steps every
    parameter and every tensor of the optimizer and slice states (the
    tables' accumulators) keeps its storage."""
    from parallax_tpu_torch.core.engine import state_tensors
    cfg, sess = _session(lstm_impl="kernel")
    batches = _batches(cfg.vocab_size)
    sess.prepare(batches[0])
    before = [(t, t.data_ptr()) for t in state_tensors(sess.state)]
    assert len(sess.state.slice_state) == 3
    for b in batches:
        sess.run("loss", feed_dict=b)
    after = [(t, t.data_ptr()) for t in state_tensors(sess.state)]
    assert len(after) == len(before)
    for (t0, p0), (t1, p1) in zip(before, after):
        assert t0 is t1 and p0 == p1
    sess.close()


def test_engine_generator_draws_the_step_generator_candidates(monkeypatch):
    """The engine reseeds one generator before each step; the candidates
    it draws are those of a fresh ``step_generator(seed, step)``."""
    from parallax_tpu_torch.core.engine import step_generator
    real = tss.log_uniform_candidates
    drawn = []

    def spy(gen, num_samples, vocab_size, device=None):
        ids = real(gen, num_samples, vocab_size, device)
        if ids.device.type != "meta":
            drawn.append(ids.clone())
        return ids

    monkeypatch.setattr(tss, "log_uniform_candidates", spy)
    cfg, sess = _session(lstm_impl="kernel", keep_prob=0.5)
    for b in _batches(cfg.vocab_size):
        sess.run("loss", feed_dict=b)
    assert len(drawn) == STEPS
    for step, ids in enumerate(drawn):
        gen = step_generator("cpu", 0, step)
        # the step's dropout masks draw first, from the same generator
        torch.rand((16, 6, cfg.emb_dim), generator=gen)
        torch.rand((6, 16, cfg.proj_dim), generator=gen)
        assert torch.equal(ids, real(gen, cfg.num_samples, cfg.vocab_size))
    sess.close()
