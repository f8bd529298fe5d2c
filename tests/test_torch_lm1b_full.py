"""The port's LM1B full-softmax baseline (``build_model(cfg,
full_softmax=True)``, ``build_full_softmax_model``) against the JAX
package's.

fp32 unless stated, ``tiny_config`` with keep_prob 1 (no randomness
enters the loss), the JAX initial tree carried across with
``weights.lm1b_params_from_jax``.

(a) The loss, ``words`` and every gradient against ``jax.value_and_grad``
    of the JAX full-softmax ``loss_fn`` (the port's LSTM kernel route
    and its plain scan, the vocabulary unpadded and padded), within 1e-5
    of each leaf's peak.
(b) At the bf16 compute dtype the logits product takes bf16 operands
    (``matmul_dtype``): the loss of one batch against the JAX model's on
    the same weights, within 2e-3 relative (bf16's 8-bit mantissa in
    both LSTMs' rounding, which the packages place differently), and
    against the port's own loss with exact fp32 logits, which it must
    not equal.
(c) Three session steps against the JAX session (HYBRID, dense Adagrad
    after a clip over every variable): losses and every parameter after
    within 1e-4 relative; ``softmax_w`` and ``softmax_b`` classified
    dense and ``emb`` sparse, as in JAX; no slice state and no touched-
    rows Adagrad, whatever ``sparse_grad_mode`` and ``max_touched_rows``
    say.
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
from parallax_tpu_torch.core.classify import flatten
from parallax_tpu_torch.models import lm1b as tlm1b
from parallax_tpu_torch.weights import lm1b_params_from_jax

STEPS = 3


def _flat(tree):
    return {jclassify._pathname(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _inputs(dtype, parts, B=4, T=5):
    jcfg = jlm1b.tiny_config(keep_prob=1.0, num_partitions=parts,
                             compute_dtype=dtype)
    jmodel = jlm1b.build_full_softmax_model(jcfg)
    init = jax.tree.map(np.asarray, jmodel.init_fn(jax.random.PRNGKey(0)))
    batch = jlm1b.make_batch(np.random.default_rng(3), B, T,
                             jcfg.vocab_size)
    batch["w"][0, -2:] = 0.0
    return jcfg, jmodel, init, batch


def _port_loss(init, batch, dtype, parts, lstm_impl, grad=False):
    cfg = tlm1b.tiny_config(keep_prob=1.0, num_partitions=parts,
                            compute_dtype=dtype, lstm_impl=lstm_impl)
    params = lm1b_params_from_jax(init, cfg, "cpu")
    leaves = dict(flatten(params))
    for leaf in leaves.values():
        leaf.requires_grad_(grad)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = tlm1b.build_full_softmax_model(cfg).loss_fn(
        params, tbatch, torch.Generator())
    return loss, aux, leaves


@pytest.mark.parametrize("lstm_impl,parts", [("kernel", 1), ("scan", 1),
                                             ("kernel", 8)])
def test_loss_and_gradients_match_jax(lstm_impl, parts):
    jcfg, jmodel, init, batch = _inputs(jnp.float32, parts)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, batch, jax.random.PRNGKey(1)),
        has_aux=True)(init)
    loss, aux, leaves = _port_loss(init, batch, torch.float32, parts,
                                   lstm_impl, grad=True)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-6)
    assert float(aux["words"]) == float(jaux["words"]) == 4 * 5 - 2
    want = _flat(jgrads)
    assert set(want) == set(leaves)
    for (path, _), g in zip(leaves.items(), grads):
        peak = max(float(np.abs(want[path]).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want[path], rtol=0,
                                   atol=1e-5 * peak, err_msg=path)
    # the full softmax reaches every row of the output tables
    assert bool((dict(zip(leaves, grads))["softmax_w"].abs().sum(1)
                 > 0).all())


def test_bf16_logits_product():
    jcfg, jmodel, init, batch = _inputs(jnp.bfloat16, 1)
    jloss, _ = jmodel.loss_fn(init, batch, jax.random.PRNGKey(1))
    loss, _, _ = _port_loss(init, batch, torch.bfloat16, 1, "scan")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-3)
    # the same hidden states through exact fp32 logits differ: the bf16
    # operands are taken
    from parallax_tpu_torch.ops import sampled_softmax as tss
    calls = []
    real = tss.full_softmax_loss

    def spy(*a, **kw):
        calls.append(kw.get("matmul_dtype"))
        return real(*a, **kw)

    tss.full_softmax_loss = spy
    try:
        _port_loss(init, batch, torch.bfloat16, 1, "scan")
        _port_loss(init, batch, torch.float32, 1, "scan")
    finally:
        tss.full_softmax_loss = real
    assert calls == [torch.bfloat16, None]


def test_three_session_steps_match_jax():
    kw = dict(keep_prob=1.0, num_partitions=8)
    jcfg = jlm1b.tiny_config(compute_dtype=jnp.float32, **kw)
    rng = np.random.default_rng(0)
    batches = [jlm1b.make_batch(rng, 16, 6, jcfg.vocab_size)
               for _ in range(STEPS)]
    jsess, *_ = jparallax.parallel_run(
        jlm1b.build_full_softmax_model(jcfg), seed=0,
        parallax_config=jparallax.Config(run_option="HYBRID",
                                         search_partitions=False))
    try:
        jsess.prepare(batches[0])
        init = jax.tree.map(np.asarray, jsess.state.params)
        jlosses = [float(jsess.run("loss", feed_dict=b)) for b in batches]
        jfinal = _flat(jsess.state.params)
        jsparse = {p for p, s in jsess.engine.plan.var_specs.items()
                   if s.is_sparse}
    finally:
        jsess.close()
    # slices mode and max_touched_rows leave the full-softmax model's
    # dense Adagrad as it is, as in JAX
    for extra in ({}, dict(sparse_grad_mode="slices"),
                  dict(max_touched_rows=64)):
        tcfg = tlm1b.tiny_config(compute_dtype=torch.float32,
                                 lstm_impl="kernel", **kw, **extra)
        model = tlm1b.build_model(tcfg, full_softmax=True)
        assert not model.slice_updaters
        sess, *_ = tparallax.parallel_run(
            model, seed=0, device="cpu",
            parallax_config=tparallax.Config(run_option="HYBRID"))
        sess.prepare(batches[0])
        carried = dict(flatten(lm1b_params_from_jax(init, tcfg, "cpu")))
        with torch.no_grad():
            for path, leaf in flatten(sess.state.params):
                leaf.copy_(carried[path])
        losses = [float(sess.run("loss", feed_dict=b)) for b in batches]
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        assert sess.state.slice_state is None
        assert {p for p, s in sess.engine.plan.var_specs.items()
                if s.is_sparse} == jsparse == {"emb"}
        # one Adagrad accumulator a variable, tables included
        acc = sess.state.opt_state[1][0]
        assert sorted(acc) == sorted(jfinal)
        got = {p: t.detach().numpy() for p, t in flatten(sess.state.params)}
        for path, want in jfinal.items():
            np.testing.assert_allclose(got[path], want, rtol=1e-4,
                                       atol=1e-6, err_msg=path)
        sess.close()
