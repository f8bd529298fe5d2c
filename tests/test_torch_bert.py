"""The port's BERT pretraining (MLM + NSP) against the JAX package's.

``tiny_config`` (2 layers, D 32, 2 heads, vocab 500) in fp32, the JAX
initial parameters carried across (``bert_params_from_jax``), batches
from the JAX ``make_batch`` with padded tails (``input_ids[:, -3:] = 0``,
so the padding mask matters):

* the classifier's facts of ``tests/test_bert.py:21-23``: ``word_emb``
  sparse, ``type_emb`` (a user override) and ``mlm/out`` dense;
* one loss and every parameter's gradient against ``jax.value_and_grad``
  of the JAX ``loss_fn``, with the plain attention core and with the
  flash path (JAX's Pallas kernels in interpret mode, the port's plain
  versions of B4-B6 on the CPU): the loss within rtol 1e-6, each
  gradient within 1e-5 of that gradient's peak;
* three ``sess.run`` steps of ``parallel_run`` HYBRID against the JAX
  session (on its 8 emulated CPU devices, plain attention: its Pallas
  path under the 8-device engine is too slow here), both port executors:
  per-step losses and final parameters within 1e-4 relative (atol
  1e-6), as ``test_torch_nmt_train.py``;
* ``adamw`` after ``clip_by_global_norm(1)`` against optax over five
  updates, every leaf decayed;
* the config errors of the JAX ``build_model``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as tparallax
from parallax_tpu.core import classify as jclassify
from parallax_tpu.models import bert as jbert
from parallax_tpu_torch.core import classify as tclassify, optim
from parallax_tpu_torch.models import bert as tbert
from parallax_tpu_torch.ops import flash_attention as tfa
from parallax_tpu_torch.weights import bert_params_from_jax

SEED = 0
STEPS = 3
CFG = dict(num_partitions=8, learning_rate=1e-3)


def _cfgs(**kw):
    return (jbert.tiny_config(**CFG, compute_dtype=jnp.float32, **kw),
            tbert.tiny_config(**CFG, compute_dtype=torch.float32, **kw))


def _batch(rng, cfg, rows=8, seq=16, masked=4):
    b = jbert.make_batch(rng, rows, seq, masked, cfg.vocab_size)
    b["input_ids"][:, -3:] = 0
    return b


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat_jax(tree):
    return {jclassify._pathname(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jbert.build_model(jcfg).init_fn(
        jax.random.PRNGKey(SEED)))


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "flash"])
def test_loss_and_every_gradient_match_jax(jparams, pallas):
    jcfg, tcfg = _cfgs(use_pallas_attention=pallas)
    batch = _batch(np.random.default_rng(1), jcfg)
    jmodel = jbert.build_model(jcfg)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jax.tree.map(jnp.asarray, batch),
                                 jax.random.PRNGKey(0)), has_aux=True))(
        jax.tree.map(jnp.asarray, jparams))
    jflat = _flat_jax(jgrads)

    tmodel = tbert.build_model(tcfg)
    params = bert_params_from_jax(jparams, tcfg, device="cpu")
    flat = tclassify.flatten(params)
    for _, leaf in flat:
        leaf.requires_grad_(True)
    before = (tfa.launches, tfa.launches_dq, tfa.launches_dkv)
    loss, metrics, _ = tmodel.call_loss(params, _torch_batch(batch),
                                        torch.Generator())
    grads = torch.autograd.grad(loss, [leaf for _, leaf in flat])
    # CPU tensors take the plain versions: no kernel is launched
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv) == before
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    for name in ("mlm_loss", "nsp_loss"):
        np.testing.assert_allclose(metrics[name].item(), float(jaux[name]),
                                   rtol=1e-6)
    assert float(metrics["masked_tokens"]) == float(jaux["masked_tokens"]) \
        == 8 * 4
    assert {p for p, _ in flat} == set(jflat)
    for (path, _), g in zip(flat, grads):
        want = jflat[path]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0,
            atol=1e-5 * max(float(np.abs(want).max()), 1e-30),
            err_msg=path)


def _jax_session_run(jcfg, batches):
    """(initial params, per-step losses, final params, plan specs) of the
    JAX session on the 8 emulated devices."""
    kw = dict(run_option="HYBRID", search_partitions=False)
    jsess, *_ = jparallax.parallel_run(jbert.build_model(jcfg),
                                       parallax_config=jparallax.Config(**kw),
                                       seed=SEED)
    try:
        jsess.prepare(batches[0])
        jinit = jax.tree.map(np.asarray, jsess.state.params)
        losses = [float(jsess.run("loss", feed_dict=b)) for b in batches]
        final = _flat_jax(jsess.state.params)
        sparse = {p for p, s in jsess.engine.plan.var_specs.items()
                  if s.is_sparse}
    finally:
        jsess.close()
    return jinit, losses, final, sparse


@pytest.fixture(scope="module")
def jax_session():
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(2)
    batches = [_batch(rng, jcfg, rows=16) for _ in range(STEPS)]
    return (batches,) + _jax_session_run(jcfg, batches)


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "flash"])
def test_three_session_steps_match_jax(jax_session, pallas):
    batches, jinit, jlosses, jfinal, jsparse = jax_session
    _, tcfg = _cfgs(use_pallas_attention=pallas)
    tsess, *rest = tparallax.parallel_run(
        tbert.build_model(tcfg),
        parallax_config=tparallax.Config(run_option="HYBRID"), seed=SEED,
        device="cpu")
    assert rest == [1, 0, 1]
    tsess.prepare(batches[0])
    specs = tsess.engine.plan.var_specs
    # tests/test_bert.py:21-23
    assert specs["word_emb"].is_sparse
    assert not specs["type_emb"].is_sparse        # user override
    assert not specs["mlm/out"].is_sparse         # dense MLM head
    assert {p for p, s in specs.items() if s.is_sparse} == {"word_emb"}
    assert "word_emb" in jsparse and "type_emb" not in jsparse
    carried = dict(tclassify.flatten(bert_params_from_jax(jinit, tcfg,
                                                          "cpu")))
    with torch.no_grad():
        for path, leaf in tclassify.flatten(tsess.state.params):
            leaf.copy_(carried[path])
    out = [tsess.run(["loss", "global_step", "masked_tokens"], feed_dict=b)
           for b in batches]
    assert [int(o[1]) for o in out] == [1, 2, 3]
    assert all(float(o[2]) == 16 * 4 for o in out)
    np.testing.assert_allclose([float(o[0]) for o in out], jlosses,
                               rtol=1e-4)
    tfinal = {p: t.detach().numpy()
              for p, t in tclassify.flatten(tsess.state.params)}
    assert set(tfinal) == set(jfinal)
    for path, want in jfinal.items():
        np.testing.assert_allclose(tfinal[path], want, rtol=1e-4,
                                   atol=1e-6, err_msg=path)
    tsess.close()


def test_adamw_after_the_clip_matches_optax_over_five_updates():
    """BERT's chain: ``clip_by_global_norm(1)`` then ``adamw(lr,
    weight_decay=0.01)`` with every leaf decayed (optax's mask None)."""
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "ln/s": (5,), "emb": (6, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    jtx = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(1e-2, weight_decay=0.01))
    ttx = optim.chain(optim.clip_by_global_norm(1.0),
                      optim.adamw(1e-2, weight_decay=0.01))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for g in grads:
        jupd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = ttx.update({k: torch.from_numpy(v)
                                   for k, v in g.items()}, tstate, tp)
        optim.apply_updates(tp, tupd)
        for k in shapes:
            np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, err_msg=k)


def test_build_model_errors_match_jax():
    for kw in (dict(tensor_parallel=True, use_pallas_attention=True),
               dict(tp_sequence_parallel=True)):
        with pytest.raises(ValueError, match="tensor_parallel"):
            jbert.build_model(jbert.tiny_config(**kw))
        with pytest.raises(ValueError, match="tensor_parallel"):
            tbert.build_model(tbert.tiny_config(**kw))
    model = tbert.build_model(tbert.tiny_config())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.init_fn(torch.Generator(), "cuda")
    # the published shape: BERT-large
    cfg = tbert.BertConfig()
    assert (cfg.hidden_dim, cfg.num_heads, cfg.mlp_dim, cfg.num_layers,
            cfg.max_len, cfg.padded_vocab) == (1024, 16, 4096, 24, 512,
                                               30522)
