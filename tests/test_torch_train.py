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
    assert eng.plan.placements["emb"] == "row_sharded"
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
    with pytest.raises(NotImplementedError, match="sync=False"):
        tparallax.parallel_run(model, sync=False, device="cpu")
    with pytest.raises(NotImplementedError, match="2 hosts"):
        tparallax.parallel_run(model, resource_info="a:0;b:0",
                               device="cpu")
    with pytest.raises(NotImplementedError, match="num_partitions"):
        tparallax.parallel_run(model, num_partitions=4, device="cpu")
    with pytest.raises(ValueError, match="sparse_grad_mode"):
        tparallax.Config(sparse_grad_mode="Slices")
    assert tparallax.Config(run_option="ps").run_option == "SHARD"
    with pytest.raises(ValueError, match="run_option"):
        tparallax.Config(run_option="ring")
