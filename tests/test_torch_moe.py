"""The port's switch MoE (``parallax_tpu_torch.ops.moe``) against the JAX
package's ``parallax_tpu.ops.moe``.

fp32 throughout, B 64 tokens of D 16, F 32, E 8 (JAX's
``tests/test_moe.py`` sizes), inputs drawn with numpy from fixed seeds.

(a) One process, no mesh (the dense path): the output, the aux loss and
    the gradient of every input of sum(out * cot) + 0.1 aux against
    ``jax.value_and_grad`` at k = 1 and 2, within 1e-5 of each peak; the
    zero router (every choice a tie: JAX gives the lowest expert, and so
    must the port) has aux loss 1 and JAX's output; ``top_k_stable`` on
    tied rows equals ``lax.top_k``; JAX's ``top_k`` errors.
(b) The capacity path on 4 gloo ranks (``torch_dist_ranks.moe_ops``) on
    (1, 4) and (2, 2) meshes, rank ``r * shard + s`` holding the JAX
    mesh's device ``(r, s)`` and its 16 rows: against JAX's mesh path on
    the same mesh shape of CPU devices, the rows of the output, the aux
    loss, the dropped share, the tokens' gradients and the world's sums
    of the router's and experts' gradients, within 1e-5 of each peak: at
    a generous capacity (k 1 and 2, nothing dropped), a tight one (JAX
    ``tests/test_moe.py:73-90``: drops, accounted), first-choice priority
    (:112-128, k 1 against k 2 at capacity factor 1), the zero router
    (every token ties onto expert 0, or 0 and 1: the lowest experts, as
    JAX breaks the ties, and most pairs drop) and E = 6, which does not
    divide a shard axis of 4 (the dense fallback, no all-to-all) and
    does divide one of 2. A forward issues two ``all_to_all``s on an
    expert-parallel mesh and none on the fallback; JAX's ``top_k`` error
    is raised on the ranks too.
(c) The fallback's warning, once.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.core import mesh as jmesh
from parallax_tpu.ops import moe as jmoe
from parallax_tpu_torch.ops import collectives, moe as tmoe, topk
from test_torch_dist import join_ranks, shared, start_ranks

B, D, F, E = 64, 16, 32, 8
TOL = 1e-5
SHAPES = ((1, 4), (2, 2))


def _weights(seed=0, e=E):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((D, e)).astype(np.float32) * 0.5,
            rng.standard_normal((e, D, F)).astype(np.float32) * 0.1,
            rng.standard_normal((e, F, D)).astype(np.float32) * 0.1)


def _tokens(seed=1):
    return np.random.default_rng(seed).standard_normal((B, D)) \
        .astype(np.float32)


def _close(got, want, what, tol=TOL):
    want = np.asarray(want)
    peak = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * peak, err_msg=what)


def _jax_value_and_grads(x, router, w1, w2, mesh, cf, k, cot, c):
    def f(x, router, w1, w2):
        out, aux, dropped = jmoe.switch_moe(x, router, w1, w2, mesh,
                                            capacity_factor=cf, top_k=k)
        return jnp.sum(out * cot) + c * aux, (out, aux, dropped)

    (_, (out, aux, dropped)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2, 3), has_aux=True))(x, router, w1, w2)
    return (np.asarray(out), float(aux), float(dropped),
            [np.asarray(g) for g in grads])


# -- (a) the dense path -------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
def test_dense_path_matches_jax(k):
    x, (router, w1, w2) = _tokens(), _weights()
    cot = np.random.default_rng(2).standard_normal((B, D)).astype(np.float32)
    want_out, want_aux, want_drop, want_grads = _jax_value_and_grads(
        x, router, w1, w2, None, 1.25, k, cot, 0.1)
    xs = [torch.tensor(a, requires_grad=True) for a in (x, router, w1, w2)]
    out, aux, dropped = tmoe.switch_moe(*xs, None, top_k=k)
    grads = torch.autograd.grad((out * torch.tensor(cot)).sum() + 0.1 * aux,
                                xs)
    _close(out.detach(), want_out, "out")
    np.testing.assert_allclose(float(aux.detach()), want_aux, rtol=1e-6)
    assert float(dropped) == want_drop == 0.0
    for name, g, w in zip(("tokens", "router", "w1", "w2"), grads,
                          want_grads):
        _close(g, w, name)


@pytest.mark.parametrize("k", [1, 2])
def test_zero_router_ties_and_aux_of_one(k):
    """All-zero router: every probability ties, JAX routes every token to
    the lowest experts, and the aux loss is exactly balanced (1)."""
    x = np.ones((32, D), np.float32)
    _, w1, w2 = _weights()
    router = np.zeros((D, E), np.float32)
    want, want_aux, _ = jmoe.switch_moe(x, router, w1, w2, None, top_k=k)
    got, aux, _ = tmoe.switch_moe(*(torch.tensor(a) for a in
                                    (x, router, w1, w2)), None, top_k=k)
    _close(got, want, "out")
    np.testing.assert_allclose(float(aux), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_top_k_stable_breaks_ties_as_lax_top_k():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 4, (16, 40)).astype(np.float32)
    x[3] = 0.0
    x[4, ::2] = -1e9
    for k in (1, 3, 7):
        jv, ji = jax.lax.top_k(x, k)
        tv, ti = topk.top_k_stable(torch.tensor(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_bad_top_k_rejected():
    x, (router, w1, w2) = _tokens(), _weights()
    args = [torch.tensor(a) for a in (x, router, w1, w2)]
    for k in (0, E + 1):
        with pytest.raises(ValueError, match="top_k"):
            jmoe.switch_moe(x, router, w1, w2, None, top_k=k)
        with pytest.raises(ValueError, match="top_k"):
            tmoe.switch_moe(*args, None, top_k=k)


def test_all_to_all_is_the_identity_without_a_group():
    x = torch.arange(12.0).reshape(4, 3)
    assert collectives.all_to_all(x, None) is x
    with collectives.count_scope() as counts:
        collectives.all_to_all(x, None)
    assert counts["all_to_all"] == 0


# -- (b) the capacity path on gloo ranks --------------------------------------

# name: (tokens seed, weights (seed, E), capacity factor, k, zero router)
CASES = {
    "generous_k1": (1, (0, E), float(E), 1, False),
    "generous_k2": (1, (0, E), float(E), 2, False),
    "tight": (1, (0, E), 0.5, 1, False),
    "priority_k1": (3, (0, E), 1.0, 1, False),
    "priority_k2": (3, (0, E), 1.0, 2, False),
    "zero_router_k1": (1, (0, E), 1.25, 1, True),
    "zero_router_k2": (1, (0, E), 1.25, 2, True),
    "six_experts": (1, (0, 6), 1.25, 1, False),
}
AUX_WEIGHT = 0.1


def _case_arrays(name):
    seed, (wseed, e), cf, k, zero = CASES[name]
    x = _tokens(seed)
    router, w1, w2 = _weights(wseed, e)
    if zero:
        x = np.ones_like(x)
        router = np.zeros_like(router)
    cot = np.random.default_rng(7).standard_normal((B, D)) \
        .astype(np.float32)
    return x, router, w1, w2, cf, k, cot


def _moe_runs(tmp):
    cases = [(name, *_case_arrays(name), AUX_WEIGHT) for name in CASES]
    handle = start_ranks(tmp, 4, "moe_ops", deadline_s=120,
                         shapes=list(SHAPES), cases=cases)
    want = {}
    for shape in SHAPES:
        mesh = jmesh.build_mesh(jax.devices()[:4], shape=shape)
        for name in CASES:
            x, router, w1, w2, cf, k, cot = _case_arrays(name)
            want[shape, name] = _jax_value_and_grads(
                x, router, w1, w2, mesh, cf, k, cot, AUX_WEIGHT)
    return want, join_ranks(handle)


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    return shared(tmp_path_factory, "moe_ops", _moe_runs)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
def test_capacity_path_matches_jax_mesh(moe_runs, shape, name):
    want, ranks = moe_runs
    want_out, want_aux, want_drop, want_grads = want[shape, name]
    n = B // 4
    e = CASES[name][1][1]
    ep = e % shape[1] == 0
    for rank, r in enumerate(ranks):
        got = r[shape][name]
        assert r[shape]["coords"] == divmod(rank, shape[1])
        rows = slice(rank * n, (rank + 1) * n)
        _close(got["out"], want_out[rows], f"rank {rank} out")
        np.testing.assert_allclose(got["aux"], want_aux, rtol=1e-6)
        np.testing.assert_allclose(got["dropped"], want_drop, rtol=1e-6,
                                   atol=0)
        _close(got["x_grad"], want_grads[0][rows], f"rank {rank} tokens")
        for what, g, w in zip(("router", "w1", "w2"), got["w_grads"],
                              want_grads[1:]):
            _close(g, w, f"rank {rank} {what}")
        assert got["counts"]["all_to_all"] == (2 if ep else 0)
    if name == "tight" or name.startswith("zero_router"):
        assert want_drop > 0
    if not ep or name.startswith("generous"):
        assert want_drop == 0.0


@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
def test_first_choice_keeps_its_service_at_top2(moe_runs, shape):
    want, ranks = moe_runs
    out1 = np.concatenate([r[shape]["priority_k1"]["out"] for r in ranks])
    out2 = np.concatenate([r[shape]["priority_k2"]["out"] for r in ranks])
    served1 = np.abs(out1).sum(1) > 0
    served2 = np.abs(out2).sum(1) > 0
    assert (served2 >= served1).all()
    assert not served1.all()


def test_top_k_error_on_the_ranks(moe_runs):
    _, ranks = moe_runs
    for r in ranks:
        for shape in SHAPES:
            assert "top_k=0 must be in [1, 8]" in r[shape]["top_k_error"]


# -- (c) the fallback's warning -----------------------------------------------


def test_indivisible_experts_warn_once(caplog):
    from parallax_tpu_torch.core import mesh as tmesh
    mesh = tmesh.Mesh(torch.device("cpu"), repl=1, shard=4)
    x = torch.tensor(_tokens())
    router, w1, w2 = (torch.tensor(a) for a in _weights(0, 6))
    tmoe._WARNED.discard((6, 4))
    with caplog.at_level(logging.WARNING, logger="PARALLAX"):
        for _ in range(2):
            out, _, dropped = tmoe.switch_moe(x, router, w1, w2, mesh)
    msgs = [r.getMessage() for r in caplog.records
            if "not divisible by shard axis" in r.getMessage()]
    assert msgs == ["switch_moe: 6 experts not divisible by shard axis 4; "
                    "running the replicated (non-EP) path"]
    assert float(dropped) == 0.0
    want, _, _ = jmoe.switch_moe(_tokens(), *_weights(0, 6), None)
    _close(out, want, "fallback out")
