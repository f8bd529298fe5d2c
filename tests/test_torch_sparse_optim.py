"""The port's sparse optimizers against the JAX package's, on one rank.

* ``SliceAdam`` (lazy Adam over gradient slices) takes the same slices
  as ``parallax_tpu.ops.sparse_optim.SliceAdam`` over 3 updates, with
  duplicate and out-of-range ids, summed and averaged: the table and
  both moments within rtol 1e-5 / atol 1e-7, untouched rows unchanged.
* ``row_sparse_adagrad`` inside ``multi_transform`` (LM1B's dense-mode
  table optimizer) takes the same dense gradients as the JAX chain over
  3 updates, with a bound that holds and one that overflows: updates,
  accumulators and ``collect_overflow_steps`` as JAX's.
fp32 throughout.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parallax_tpu.ops import sparse_optim as jso
from parallax_tpu_torch.core import optim
from parallax_tpu_torch.ops import sparse_optim as tso

V, D = 12, 3


def _slices(rng, n=10):
    ids = rng.integers(-2, V + 2, size=(n,)).astype(np.int32)
    ids[:3] = 4                                   # duplicates
    drows = rng.standard_normal((n, D)).astype(np.float32)
    return ids, drows


@pytest.mark.parametrize("average", [False, True])
def test_slice_adam_matches_jax(average):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((V, D)).astype(np.float32)
    jupd = jso.SliceAdam(0.05, grad_scale=2.0)
    tupd = tso.SliceAdam(0.05, grad_scale=2.0)
    jp, js = jnp.asarray(table), jupd.init(jnp.asarray(table))
    tp = torch.from_numpy(table.copy())
    ts = tupd.init(tp)
    touched = set()
    for _ in range(3):
        ids, drows = _slices(rng)
        touched |= {int(i) for i in ids if 0 <= i < V}
        jp, js = jupd.update(jp, js, jnp.asarray(ids), jnp.asarray(drows),
                             average=average)
        tupd.update(tp, ts, torch.from_numpy(ids), torch.from_numpy(drows),
                    average=average)
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)
    assert int(ts.count) == int(js.count) == 3
    untouched = [r for r in range(V) if r not in touched]
    np.testing.assert_array_equal(tp.numpy()[untouched], table[untouched])


@pytest.mark.parametrize("bound", [V, 4], ids=["holds", "overflows"])
def test_row_sparse_adagrad_matches_jax(bound):
    rng = np.random.default_rng(5)
    params = {"emb": rng.standard_normal((V, D)).astype(np.float32),
              "w": rng.standard_normal((D,)).astype(np.float32)}
    labels = {"emb": "table", "w": "rest"}
    jtx = optax.multi_transform(
        {"table": jso.row_sparse_adagrad(0.1, bound,
                                         initial_accumulator_value=1.0),
         "rest": optax.adagrad(0.1, initial_accumulator_value=1.0)},
        param_labels=labels)
    ttx = optim.multi_transform(
        {"table": tso.row_sparse_adagrad(0.1, bound,
                                         initial_accumulator_value=1.0),
         "rest": optim.adagrad(0.1, initial_accumulator_value=1.0)},
        param_labels=labels)
    jstate = jtx.init({k: jnp.asarray(v) for k, v in params.items()})
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttx.init(tparams)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        # 6 of the 12 table rows touched a step
        g["emb"][rng.permutation(V)[:6]] = 0.0
        jup, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate)
        tup, tstate = ttx.update({k: torch.from_numpy(v) for k, v in
                                  g.items()}, tstate)
        for k in params:
            np.testing.assert_allclose(tup[k].numpy(), np.asarray(jup[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(
        tstate["table"].sum_of_squares["emb"].numpy(),
        np.asarray(jstate.inner_states["table"].inner_state
                   .sum_of_squares["emb"]), rtol=1e-6)
    want = jso.collect_overflow_steps(jstate)
    assert tso.collect_overflow_steps(tstate) == want == \
        (3 if bound == 4 else 0)
