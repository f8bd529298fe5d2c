"""The port's ring attention against the JAX package's.

Ranks are spawned gloo processes (``test_torch_dist.run_ranks``; bodies
in ``torch_dist_ranks.py``, which imports no JAX), rank ``s`` holding
block ``s`` of the sequence on a (1, n) mesh. The JAX side runs
``parallax_tpu.ops.ring_attention.ring_attention`` over 'shard' of a
(1, n) mesh of the conftest's emulated CPU devices, its flash blocks in
Pallas interpret mode as its own tests run them. fp32, B 2, T 32, H 2,
D 8 (``tests/test_ring_attention.py``'s inputs), n = 2 and 4:

* contiguous and zig-zag placements (zig-zag inputs permuted with
  ``zigzag_permutation``, as the JAX tests permute them), causal and
  not, with the plain (``'xla'``) and the flash (``'pallas'``) block
  cores: each rank's output block and its q, k, v gradients of
  sum(out * cot) against the JAX function's, at JAX's tolerances
  (rtol 2e-5 / atol 2e-6 forward and 5e-5 / 5e-6 gradients with plain
  blocks; 2e-4 / 5e-4 with flash blocks);
* the forward's rotations: 2 (n - 1) ``collective_permute`` (one K and
  one V shift a rotation) and no other collective; none at n = 1;
* the zig-zag permutations equal JAX's, and the JAX ``ValueError``s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from parallax_tpu.ops import ring_attention as jra
from parallax_tpu_torch.core import mesh as tmesh
from parallax_tpu_torch.ops import ring_attention as tra
from parallax_tpu_torch.ops import tensor_parallel as ttp
from test_torch_dist import join_ranks, shared, start_ranks

B, T, H, D = 2, 32, 2, 8
# (placement, causal, block core)
CASES = [("contiguous", False, "xla"), ("contiguous", True, "xla"),
         ("zigzag", True, "xla"), ("zigzag", False, "xla"),
         ("contiguous", True, "pallas"), ("zigzag", True, "pallas"),
         ("contiguous", False, "pallas")]
TOL = {"xla": ((2e-5, 2e-6), (5e-5, 5e-6)),
       "pallas": ((2e-4, 5e-4), (2e-4, 5e-4))}


def _name(case):
    return "_".join(str(c) for c in case)


def _inputs(n):
    rng = np.random.default_rng(n)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(4)]


def _jax(n, case, q, k, v, cot):
    """The JAX ring's output and q, k, v gradients on a (1, n) mesh."""
    placement, causal, impl = case
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(1, n),
                ("repl", "shard"))

    def f(q, k, v):
        return jra.ring_attention(q, k, v, mesh, "shard", causal=causal,
                                  placement=placement, block_impl=impl)

    args = [jnp.asarray(a) for a in (q, k, v)]
    out, vjp = jax.vjp(jax.jit(f), *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _runs(tmp, n):
    q, k, v, cot = _inputs(n)
    cases = []
    for case in CASES:
        if case[0] == "zigzag":
            perm = jra.zigzag_permutation(T, n)
            args = [a[:, perm] for a in (q, k, v, cot)]
        else:
            args = [q, k, v, cot]
        cases.append((_name(case), *case, *args))
    handle = start_ranks(tmp, n, "ring_ops", cases=cases)
    oracle = {c[0]: _jax(n, CASES[i], *c[4:]) for i, c in enumerate(cases)}
    return join_ranks(handle), oracle


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def ring_runs(request, tmp_path_factory):
    n = request.param
    return (n,) + tuple(shared(tmp_path_factory, f"ring{n}",
                               lambda tmp: _runs(tmp, n)))


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_ring_attention_matches_jax(ring_runs, case):
    n, ranks, oracle = ring_runs
    want_out, want_grads = oracle[_name(case)]
    (frtol, fatol), (grtol, gatol) = TOL[case[2]]
    blk = T // n
    assert [r["coords"] for r in ranks] == [(0, s) for s in range(n)]
    for s, r in enumerate(ranks):
        got = r[_name(case)]
        sl = slice(s * blk, (s + 1) * blk)
        np.testing.assert_allclose(got["out"], want_out[:, sl],
                                   rtol=frtol, atol=fatol, err_msg="out")
        for name, g, w in zip("qkv", got["grads"], want_grads):
            np.testing.assert_allclose(g, w[:, sl], rtol=grtol, atol=gatol,
                                       err_msg=f"d{name}")
        assert got["counts"] == {"all_reduce": 0, "all_gather": 0,
                                 "reduce_scatter": 0, "all_to_all": 0,
                                 "collective_permute": 2 * (n - 1)}


def test_one_block_ring_moves_nothing():
    """n = 1 (a mesh of one rank, as on one card): no rotation, and the
    one causal tile equals the unsharded reference."""
    q, k, v, _ = (torch.tensor(a) for a in _inputs(1))
    mesh = tmesh.Mesh(torch.device("cpu"))
    for impl in ("xla", "pallas"):
        counts = ttp.count_collectives(lambda: tra.ring_attention(
            q, k, v, mesh, causal=True, block_impl=impl))
        assert counts["collective_permute"] == 0
        got = tra.ring_attention(q, k, v, mesh, causal=True,
                                 block_impl=impl)
        want = jra.full_attention_reference(
            *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)
    want = jra.full_attention_reference(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    np.testing.assert_allclose(
        tra.full_attention_reference(q, k, v).numpy(), np.asarray(want),
        rtol=2e-5, atol=2e-6)


def test_zigzag_permutations_and_errors_match_jax():
    for Tz, n in ((32, 2), (32, 4), (48, 3), (16, 8)):
        np.testing.assert_array_equal(tra.zigzag_permutation(Tz, n),
                                      jra.zigzag_permutation(Tz, n))
        np.testing.assert_array_equal(
            tra.inverse_zigzag_permutation(Tz, n),
            jra.inverse_zigzag_permutation(Tz, n))
    with pytest.raises(ValueError, match="divisible"):
        tra.zigzag_permutation(30, 4)
    q = torch.zeros((1, 5, 2, 8))
    with pytest.raises(ValueError, match="unknown placement"):
        tra.ring_attention(q, q, q, placement="striped")
    with pytest.raises(ValueError, match="unknown block_impl"):
        tra.ring_attention(q, q, q, block_impl="triton")
    with pytest.raises(ValueError, match="divisible by 2"):
        tra.ring_attention(q, q, q, causal=True, placement="zigzag")
