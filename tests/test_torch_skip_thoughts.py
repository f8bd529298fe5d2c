"""The port's skip-thoughts model against the JAX package's.

fp32, ``tiny_config`` (vocab 500, E 16, H 32), the JAX initial tree
carried across with ``weights.skip_thoughts_params_from_jax``; inputs
from a numpy seed, with zero ids in the previous and next sentences so
the ``(prev > 0)`` and ``(next > 0)`` weights drop positions.

(a) The loss, ``words`` and every gradient of the port's ``loss_fn``
    against ``jax.value_and_grad`` of the JAX one, within 1e-5 of each
    leaf's peak, with the vocabulary unpadded (1 partition) and padded
    (8 partitions: 504 rows, the phantom classes masked).
(b) Three session steps (``parallel_run``, clip + Adam) against the JAX
    session: losses and every parameter after within 1e-4 relative; the
    classifier finds ``emb`` alone sparse, as JAX's does.
(c) The configuration and the weight carrier's checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as tparallax
from parallax_tpu.core import classify as jclassify
from parallax_tpu.models import skip_thoughts as jst
from parallax_tpu_torch import weights
from parallax_tpu_torch.core.classify import flatten
from parallax_tpu_torch.models import skip_thoughts as tst

STEPS = 3


def _batch(seed, vocab, B=4, T=7):
    b = jst.make_batch(np.random.default_rng(seed), B, T, vocab)
    b["prev"][:, -2:] = 0
    b["next"][0, -3:] = 0
    b["next"][1, 2] = 0
    return b


def _flat(tree):
    return {jclassify._pathname(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("parts", [1, 8])
def test_loss_and_gradients_match_jax(parts):
    jcfg = jst.tiny_config(compute_dtype=jnp.float32, num_partitions=parts)
    jmodel = jst.build_model(jcfg)
    init = jax.tree.map(np.asarray, jmodel.init_fn(jax.random.PRNGKey(0)))
    batch = _batch(0, jcfg.vocab_size)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, batch, None), has_aux=True)(init)

    tcfg = tst.tiny_config(compute_dtype=torch.float32, num_partitions=parts)
    assert tcfg.padded_vocab == jcfg.padded_vocab == (500 if parts == 1
                                                      else 504)
    params = weights.skip_thoughts_params_from_jax(init, tcfg, "cpu")
    leaves = dict(flatten(params))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = tst.build_model(tcfg).loss_fn(params, tbatch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    assert float(aux["words"]) == float(jaux["words"]) == \
        float((batch["prev"] > 0).sum() + (batch["next"] > 0).sum())
    want = _flat(jgrads)
    assert set(want) == set(leaves)
    for (path, _), g in zip(leaves.items(), grads):
        peak = max(float(np.abs(want[path]).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want[path], rtol=0,
                                   atol=1e-5 * peak, err_msg=path)


def test_three_session_steps_match_jax():
    jcfg = jst.tiny_config(compute_dtype=jnp.float32, num_partitions=8)
    tcfg = tst.tiny_config(compute_dtype=torch.float32, num_partitions=8)
    batches = [_batch(10 + i, jcfg.vocab_size, B=8) for i in range(STEPS)]
    jsess, *_ = jparallax.parallel_run(
        jst.build_model(jcfg), seed=0,
        parallax_config=jparallax.Config(search_partitions=False))
    try:
        jsess.prepare(batches[0])
        init = jax.tree.map(np.asarray, jsess.state.params)
        jlosses = [float(jsess.run("loss", feed_dict=b)) for b in batches]
        jfinal = _flat(jsess.state.params)
        jsparse = {p for p, s in jsess.engine.plan.var_specs.items()
                   if s.is_sparse}
    finally:
        jsess.close()

    sess, *_ = tparallax.parallel_run(tst.build_model(tcfg), seed=0,
                                      device="cpu")
    sess.prepare(batches[0])
    carried = dict(flatten(weights.skip_thoughts_params_from_jax(
        init, tcfg, "cpu")))
    with torch.no_grad():
        for path, leaf in flatten(sess.state.params):
            leaf.copy_(carried[path])
    out = [sess.run(["loss", "words"], feed_dict=b) for b in batches]
    np.testing.assert_allclose([float(o[0]) for o in out], jlosses,
                               rtol=1e-4)
    assert [float(o[1]) for o in out] == [
        float((b["prev"] > 0).sum() + (b["next"] > 0).sum())
        for b in batches]
    assert {p for p, s in sess.engine.plan.var_specs.items()
            if s.is_sparse} == jsparse == {"emb"}
    got = {p: t.detach().numpy() for p, t in flatten(sess.state.params)}
    assert set(got) == set(jfinal)
    for path, want in jfinal.items():
        np.testing.assert_allclose(got[path], want, rtol=1e-4, atol=1e-6,
                                   err_msg=path)
    sess.close()


def test_config_and_weights_checks():
    cfg, want = tst.SkipThoughtsConfig(), jst.SkipThoughtsConfig()
    for f in dataclasses.fields(want):
        if f.name != "compute_dtype":
            assert getattr(cfg, f.name) == getattr(want, f.name), f.name
    assert cfg.compute_dtype == torch.bfloat16
    assert (cfg.vocab_size, cfg.emb_dim, cfg.hidden_dim) == \
        (20000, 620, 2400)
    assert dataclasses.asdict(tst.tiny_config()) == dict(
        dataclasses.asdict(cfg), vocab_size=500, emb_dim=16, hidden_dim=32)
    tiny = tst.tiny_config(num_partitions=1)
    meta = tst.init_params(tiny, torch.Generator(), "meta")
    jmeta = jax.eval_shape(jst.build_model(jst.tiny_config(
        num_partitions=1)).init_fn, jax.random.PRNGKey(0))
    assert {p: tuple(t.shape) for p, t in flatten(meta)} == {
        jclassify._pathname(k): tuple(v.shape) for k, v in
        jax.tree_util.tree_flatten_with_path(jmeta)[0]}
    init = jax.tree.map(np.asarray, jst.build_model(jst.tiny_config(
        num_partitions=1)).init_fn(jax.random.PRNGKey(0)))
    bad = dict(init, out_b=init["out_b"][:-1])
    with pytest.raises(ValueError, match="out_b"):
        weights.skip_thoughts_params_from_jax(bad, tiny, "cpu")
    extra = dict(init, dec_prev=dict(init["dec_prev"], extra=init["out_b"]))
    with pytest.raises(ValueError, match="dec_prev"):
        weights.skip_thoughts_params_from_jax(extra, tiny, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tst.init_params(tiny, torch.Generator())
