"""The port's Adam and schedules against optax.

``core/optim.adam`` with the NMT warmup schedule, after
``clip_by_global_norm``, takes the same numpy gradients as ``optax`` over
5 updates from the same parameters. fp32; the two compute the same
formulas in fp32, so updates and parameters agree to rtol 1e-6 (atol
1e-9 for the exact zeros of the first update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parallax_tpu_torch.core import optim

LR, WARMUP = 1e-3, 3


def _jax_sched():
    return optax.join_schedules(
        [optax.linear_schedule(0.0, LR, WARMUP), optax.constant_schedule(LR)],
        [WARMUP])


def _torch_sched():
    return optim.join_schedules(
        [optim.linear_schedule(0.0, LR, WARMUP), optim.constant_schedule(LR)],
        [WARMUP])


def test_schedule_values_match_optax():
    js, ts = _jax_sched(), _torch_sched()
    for count in range(8):
        assert ts(count) == pytest.approx(float(js(count)), rel=1e-7,
                                          abs=0.0)
    assert ts(0) == 0.0              # the first update is a zero update
    lin = optim.linear_schedule(2.0, 0.5, 4)
    jlin = optax.linear_schedule(2.0, 0.5, 4)
    for count in range(9):
        assert lin(count) == pytest.approx(float(jlin(count)), rel=1e-7)
    # no warmup: the joined schedule is the constant from the start
    flat = optim.join_schedules([optim.linear_schedule(0.0, LR, 0),
                                 optim.constant_schedule(LR)], [0])
    jflat = optax.join_schedules([optax.linear_schedule(0.0, LR, 0),
                                  optax.constant_schedule(LR)], [0])
    for count in range(3):
        assert flat(count) == pytest.approx(float(jflat(count)), rel=1e-7)


@pytest.mark.parametrize("max_norm", [5.0, 0.5], ids=["unclipped",
                                                      "clipped"])
def test_adam_with_warmup_matches_optax_over_five_updates(max_norm):
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b/c": (5,), "d": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]

    jtx = optax.chain(optax.clip_by_global_norm(max_norm),
                      optax.adam(_jax_sched()))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    ttx = optim.chain(optim.clip_by_global_norm(max_norm),
                      optim.adam(_torch_sched()))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttx.init(tp)
    for step, g in enumerate(grads):
        jupd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = ttx.update({k: torch.from_numpy(v)
                                   for k, v in g.items()}, tstate, tp)
        optim.apply_updates(tp, tupd)
        for k in shapes:
            np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"step {step} {k}")
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, err_msg=f"step {step} {k}")
        if step == 0:
            assert all(bool((u == 0).all()) for u in tupd.values())
    # the optimizer state carries the same moments and counts
    tadam, tsched = tstate[1]
    jadam, jsched = jstate[1]
    assert tadam["count"] == int(jadam.count) == 5
    assert tsched["count"] == int(jsched.count) == 5
    for k in shapes:
        np.testing.assert_allclose(tadam["mu"][k].numpy(),
                                   np.asarray(jadam.mu[k]), rtol=1e-6)
        np.testing.assert_allclose(tadam["nu"][k].numpy(),
                                   np.asarray(jadam.nu[k]), rtol=1e-6)


def test_constant_learning_rate_adam_matches_optax():
    rng = np.random.default_rng(1)
    p = rng.standard_normal((6,)).astype(np.float32)
    g = rng.standard_normal((6,)).astype(np.float32)
    jupd, _ = optax.adam(0.01).update(jnp.asarray(g),
                                      optax.adam(0.01).init(jnp.asarray(p)))
    ttx = optim.adam(0.01)
    tupd, _ = ttx.update({"p": torch.from_numpy(g)},
                         ttx.init({"p": torch.from_numpy(p)}))
    np.testing.assert_allclose(tupd["p"].numpy(), np.asarray(jupd),
                               rtol=1e-6)


def _ndim_mask(params):
    return jax.tree.map(lambda x: x.ndim > 1, params)


@pytest.mark.parametrize("momentum,nesterov,mask", [
    (0.9, False, "callable"), (0.9, True, "callable"), (0.9, False, "dict"),
    (None, False, "callable")],
    ids=["momentum", "nesterov", "dict_mask", "no_momentum"])
def test_sgd_with_masked_weight_decay_matches_optax(momentum, nesterov,
                                                    mask):
    """The CNN chain, ``add_decayed_weights(wd, mask=ndim > 1)`` then
    ``sgd(lr, momentum)``, over 3 updates: optax's trace is ``g + m * t``
    and its update ``-lr * t`` (no dampening). Leaves of one dimension
    (BatchNorm scale and bias, dense bias) are not decayed. fp32, rtol
    1e-6."""
    rng = np.random.default_rng(2)
    shapes = {"conv/kernel": (3, 3, 4, 8), "dense/kernel": (8, 5),
              "bn/scale": (8,), "dense/bias": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    wd, lr = 4e-2, 0.1
    jtx = optax.chain(optax.add_decayed_weights(wd, mask=_ndim_mask),
                      optax.sgd(lr, momentum=momentum, nesterov=nesterov))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tmask = (lambda p: {k: v.dim() > 1 for k, v in p.items()}) \
        if mask == "callable" else {k: len(s) > 1 for k, s in shapes.items()}
    ttx = optim.chain(optim.add_decayed_weights(wd, mask=tmask),
                      optim.sgd(lr, momentum=momentum, nesterov=nesterov))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttx.init(tp)
    for step, g in enumerate(grads):
        jupd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = ttx.update({k: torch.from_numpy(v)
                                   for k, v in g.items()}, tstate, tp)
        optim.apply_updates(tp, tupd)
        for k in shapes:
            np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"step {step} {k}")
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, err_msg=f"step {step} {k}")
    if momentum is not None:
        ttrace = tstate[1][0]
        jtrace = jstate[1][0].trace
        for k in shapes:
            np.testing.assert_allclose(ttrace[k].numpy(),
                                       np.asarray(jtrace[k]), rtol=1e-6)
    # an undecayed one-dimensional leaf moves by the gradients alone
    if momentum is None:
        want = params["bn/scale"] - lr * sum(g["bn/scale"] for g in grads)
        np.testing.assert_allclose(tp["bn/scale"].numpy(), want, rtol=1e-6)


def test_sgd_without_momentum_is_the_scaled_gradient():
    tx = optim.sgd(0.5)
    upd, state = tx.update({"p": torch.tensor([2.0, -4.0])},
                           tx.init({"p": torch.zeros(2)}))
    assert state == () and torch.equal(upd["p"], torch.tensor([-1.0, 2.0]))
    with pytest.raises(ValueError, match="params"):
        optim.add_decayed_weights(0.1).update({"p": torch.ones(1)}, ())


def test_nmt_chain_with_device_counts_matches_optax_over_twelve_updates():
    """NMT's own optimizer, clip then Adam on the warmup-then-constant
    schedule, in both packages over 12 updates that cross the warmup
    (4): the count and the bias corrections are int32 and fp32 tensors
    on the params' device, updated in place, and the run agrees with
    optax at this file's tolerances."""
    from parallax_tpu.models import nmt as jnmt
    from parallax_tpu_torch.models import nmt as tnmt
    jtx = jnmt.build_model(jnmt.tiny_config(warmup_steps=4)).optimizer
    ttx = tnmt.build_model(tnmt.tiny_config(warmup_steps=4)).optimizer
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttx.init(tp)
    adam, sched = tstate[1]
    assert adam["count"].dtype == torch.int32 and adam["count"].dim() == 0
    tensors = [adam["count"], sched["count"], *adam["mu"].values(),
               *adam["nu"].values()]
    ptrs = [t.data_ptr() for t in tensors]
    for step in range(12):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32)
             for k, s in shapes.items()}
        jupd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = ttx.update({k: torch.from_numpy(v)
                                   for k, v in g.items()}, tstate, tp)
        optim.apply_updates(tp, tupd)
        for k in shapes:
            np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"step {step} {k}")
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, err_msg=f"step {step} {k}")
    assert tstate[1][0] is adam and tstate[1][1] is sched
    assert [t.data_ptr() for t in tensors] == ptrs
    assert int(adam["count"]) == int(jstate[1][0].count) == 12
    assert int(sched["count"]) == int(jstate[1][1].count) == 12
