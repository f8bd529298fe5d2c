"""The port's NMT training half against the JAX package's.

* The classifier finds the same sparse set (``emb``) on ``tiny_config``.
* One loss and every parameter's gradient match ``jax.value_and_grad``
  of the JAX ``loss_fn`` with ``use_pallas_attention=True`` (its Pallas
  forward and backward kernels in interpret mode; one device, no
  engine). fp32: the loss within rtol 1e-5, each gradient within rtol
  1e-4 plus atol 1e-5 of that gradient's peak (the two packages sum the
  same products in another order, through 2+2 layers and a softmax over
  512 classes).
* Three ``sess.run`` steps through both packages' ``parallel_run`` HYBRID
  sessions from the JAX initial parameters (``params_from_jax``): per-step
  losses and final parameters within 1e-4 relative. The JAX session runs
  on the 8 emulated CPU devices, so its batch of 16 rows splits 8 ways
  and it averages per-replica mean losses; the targets carry no padding,
  so every replica counts the same words and that average is the global
  mean the port computes. It uses the plain attention
  (``use_pallas_attention=False``: its Pallas path under the 8-device
  engine is too slow here); the port runs both of its executors. The
  warmup is 2 steps on both sides so the parameters move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as tparallax
from parallax_tpu.core import classify as jclassify
from parallax_tpu.models import nmt as jnmt
from parallax_tpu_torch.core import classify as tclassify
from parallax_tpu_torch.models import nmt as tnmt
from parallax_tpu_torch.ops import flash_attention as tfa
from parallax_tpu_torch.weights import params_from_jax

SEED = 0
STEPS = 3
CFG = dict(num_partitions=8, warmup_steps=2)


def _cfgs(**kw):
    return (jnmt.tiny_config(**CFG, compute_dtype=jnp.float32, **kw),
            tnmt.tiny_config(**CFG, compute_dtype=torch.float32, **kw))


def _batch(rng, cfg, rows=16, src_len=12, tgt_len=10):
    """``make_batch`` with some source tails padded (the kv-mask paths)
    and no target padding."""
    b = jnmt.make_batch(rng, rows, src_len, tgt_len, cfg.vocab_size)
    lengths = rng.integers(3, src_len + 1, rows)
    lengths[0] = src_len
    for i, n in enumerate(lengths):
        b["src"][i, n:] = jnmt.PAD_ID
    return b


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_classifier_matches_jax_on_tiny_config():
    """``emb`` alone is sparse; ``pos`` is sliced, so it is dense. The
    JAX classifier agrees on every path but ``pos``."""
    jcfg, tcfg = _cfgs()
    jmodel = jnmt.build_model(jcfg)
    batch = _batch(np.random.default_rng(0), jcfg, rows=4)
    shapes = jax.eval_shape(jmodel.init_fn, jax.random.PRNGKey(0))
    jspecs = jclassify.classify_params(
        lambda p, b, r: jmodel.loss_fn(p, b, r)[0], shapes,
        jax.tree.map(jnp.asarray, batch),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    tmodel = tnmt.build_model(tcfg)
    tspecs = tclassify.classify_params(
        tmodel.call_loss, tmodel.init_fn(torch.Generator(), "meta"),
        {k: v.to("meta") for k, v in _torch_batch(batch).items()},
        torch.Generator())
    jsparse = {p for p, s in jspecs.items() if s.is_sparse}
    tsparse = {p for p, s in tspecs.items() if s.is_sparse}
    assert tsparse == {"emb"}
    # jnp lowers pos[None, :Ts] to a gather whose operand is pos, so the
    # JAX classifier also finds pos sparse; torch slices it as a view. On
    # one card both placements hold the whole tensor and its dense
    # gradient goes through the optimizer either way.
    assert jsparse == {"emb", "pos"}
    assert tspecs["pos"].reason == "no gather use"
    assert set(tspecs) == set(jspecs)
    for p, s in tspecs.items():
        assert s.shape == tuple(jspecs[p].shape), p


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jnmt.build_model(jcfg).init_fn(
        jax.random.PRNGKey(SEED)))


def test_loss_and_every_gradient_match_jax_pallas(jparams):
    jcfg, tcfg = _cfgs(use_pallas_attention=True)
    batch = _batch(np.random.default_rng(1), jcfg, rows=4, src_len=10,
                   tgt_len=8)
    jmodel = jnmt.build_model(jcfg)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jax.tree.map(jnp.asarray, batch),
                                 jax.random.PRNGKey(0)), has_aux=True))(
        jax.tree.map(jnp.asarray, jparams))
    jflat = {jclassify._pathname(k): np.asarray(v) for k, v in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]}

    tmodel = tnmt.build_model(tcfg)
    params = params_from_jax(jparams, tcfg, device="cpu")
    flat = tclassify.flatten(params)
    for _, leaf in flat:
        leaf.requires_grad_(True)
    before = (tfa.launches, tfa.launches_dq, tfa.launches_dkv)
    loss, metrics, _ = tmodel.call_loss(params, _torch_batch(batch),
                                        torch.Generator())
    # the encoder blocks' cross-attention weights and ln3 are unused, and
    # their JAX gradients are zeros
    grads = [torch.zeros_like(leaf) if g is None else g for (_, leaf), g in
             zip(flat, torch.autograd.grad(loss, [leaf for _, leaf in flat],
                                           allow_unused=True))]
    # CPU tensors take the plain versions: no kernel is launched
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv) == before
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert float(metrics["words"]) == float(jaux["words"]) == 4 * 8
    assert {p for p, _ in flat} == set(jflat)
    for (path, _), g in zip(flat, grads):
        want = jflat[path]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=1e-4,
            atol=1e-5 * max(float(np.abs(want).max()), 1e-30),
            err_msg=path)


def _jax_session_run(jcfg, batches):
    """(initial params, per-step losses, final params) of the JAX
    session."""
    kw = dict(run_option="HYBRID", search_partitions=False)
    jsess, *_ = jparallax.parallel_run(jnmt.build_model(jcfg),
                                       parallax_config=jparallax.Config(**kw),
                                       seed=SEED)
    try:
        jsess.prepare(batches[0])
        jinit = jax.tree.map(np.asarray, jsess.state.params)
        losses = [float(jsess.run("loss", feed_dict=b)) for b in batches]
        final = {jclassify._pathname(k): np.asarray(v) for k, v in
                 jax.tree_util.tree_flatten_with_path(
                     jsess.state.params)[0]}
    finally:
        jsess.close()
    return jinit, losses, final


@pytest.fixture(scope="module")
def jax_session():
    jcfg, _ = _cfgs(use_pallas_attention=False)
    rng = np.random.default_rng(2)
    batches = [_batch(rng, jcfg) for _ in range(STEPS)]
    jinit, losses, final = _jax_session_run(jcfg, batches)
    return batches, jinit, losses, final


@pytest.mark.parametrize("pallas", [True, False], ids=["flash", "plain"])
def test_three_session_steps_match_jax(jax_session, pallas):
    batches, jinit, jlosses, jfinal = jax_session
    _, tcfg = _cfgs(use_pallas_attention=pallas)
    tsess, *rest = tparallax.parallel_run(
        tnmt.build_model(tcfg),
        parallax_config=tparallax.Config(run_option="HYBRID"), seed=SEED,
        device="cpu")
    assert rest == [1, 0, 1]
    assert tsess.prepare(batches[0]) == 0
    plan = tsess.engine.plan
    # one rank, one shard: the sparse table stays whole (build_plan
    # row-shards only over a shard axis wider than 1, as the JAX plan)
    assert plan.var_specs["emb"].is_sparse
    assert not plan.var_specs["pos"].is_sparse
    assert plan.placements["emb"] == plan.placements["pos"] == "replicated"
    carried = dict(tclassify.flatten(params_from_jax(jinit, tcfg, "cpu")))
    with torch.no_grad():
        for path, leaf in tclassify.flatten(tsess.state.params):
            leaf.copy_(carried[path])
    out = [tsess.run(["loss", "global_step", "words"], feed_dict=b)
           for b in batches]
    assert [int(o[1]) for o in out] == [1, 2, 3]
    assert all(float(o[2]) == 16 * 10 for o in out)
    np.testing.assert_allclose([float(o[0]) for o in out], jlosses,
                               rtol=1e-4)
    tfinal = {p: t.detach().numpy()
              for p, t in tclassify.flatten(tsess.state.params)}
    assert set(tfinal) == set(jfinal)
    for path, want in jfinal.items():
        np.testing.assert_allclose(tfinal[path], want, rtol=1e-4,
                                   atol=1e-6, err_msg=path)
    # the dense [V, D] embedding gradient went through Adam: rows no
    # batch looked up (the padded vocab included) keep their values
    touched = set(np.concatenate([np.concatenate([b["src"].ravel(),
                                                  b["tgt_in"].ravel()])
                                  for b in batches]))
    untouched = [r for r in range(tcfg.padded_vocab) if r not in touched]
    np.testing.assert_array_equal(tfinal["emb"][untouched],
                                  carried["emb"].numpy()[untouched])
    tsess.close()


def test_first_update_is_zero_and_the_loss_falls():
    """The warmup starts at lr 0: step 1 leaves every parameter as it
    was; a few more steps on one batch lower its loss."""
    _, tcfg = _cfgs(use_pallas_attention=True)
    sess, *_ = tparallax.parallel_run(
        tnmt.build_model(tcfg),
        parallax_config=tparallax.Config(run_option="HYBRID"), seed=SEED,
        device="cpu")
    batch = _batch(np.random.default_rng(3), tcfg, rows=4)
    sess.prepare(batch)
    before = {p: t.detach().clone()
              for p, t in tclassify.flatten(sess.state.params)}
    losses = [float(sess.run("loss", feed_dict=batch))]
    for p, t in tclassify.flatten(sess.state.params):
        assert torch.equal(t, before[p]), p
    losses += [float(sess.run("loss", feed_dict=batch)) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    sess.close()


def test_build_model_refuses_what_is_not_ported():
    # tensor parallelism runs the plain core, as the JAX build_model says
    with pytest.raises(ValueError, match="tensor_parallel"):
        tnmt.build_model(tnmt.tiny_config(tensor_parallel=True,
                                          use_pallas_attention=True))
    with pytest.raises(ValueError, match="tensor_parallel"):
        jnmt.build_model(jnmt.tiny_config(tensor_parallel=True,
                                          use_pallas_attention=True))
    tp = tnmt.build_model(tnmt.tiny_config(tensor_parallel=True))
    assert set(tp.batch_specs) == {"src", "tgt_in", "tgt_out", "w"}
    assert tp.param_specs["enc/*/attn/wo"] == ("shard", None)
    model = tnmt.build_model(tnmt.tiny_config())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.init_fn(torch.Generator(), "cuda")
