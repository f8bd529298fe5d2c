"""The port's NMT inference math against the JAX package's.

One JAX parameter tree (``build_model(cfg).init_fn``) is carried across
with ``weights.params_from_jax``; the same numpy sources then go through
both packages' encoder, cross K/V, paged decode steps (through the
paged-attention kernel and through the gather executor) and greedy
decode. fp32 throughout: encoder outputs within 1e-5, logits within
1e-4, tokens identical. JAX's Pallas kernels run in interpret mode, the
port's kernel wrappers in their plain versions (CPU tensors).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.models import nmt as jnmt
from parallax_tpu_torch.models import nmt as tnmt
from parallax_tpu_torch.weights import params_from_jax

CFG = dict(vocab_size=64, model_dim=16, num_heads=2, mlp_dim=32,
           num_layers=2, max_len=16, num_partitions=1)


def _cfgs(**kw):
    return (jnmt.tiny_config(**CFG, compute_dtype=jnp.float32, **kw),
            tnmt.tiny_config(**CFG, compute_dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs()
    return jnmt.build_model(jcfg).init_fn(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    _, tcfg = _cfgs()
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu")


def _srcs():
    rng = np.random.default_rng(7)
    src = rng.integers(3, 64, (3, 8)).astype(np.int32)
    src[1, 5:] = jnmt.PAD_ID
    src[2, 2:] = jnmt.PAD_ID
    return src


def test_params_from_jax_carries_every_leaf(jparams, tparams):
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(jl) == len(jax.tree_util.tree_leaves(tparams))
    for path, leaf in jl:
        node = tparams
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_params_from_jax_refuses_a_wrong_shape(jparams):
    _, tcfg = _cfgs()
    bad = jax.tree.map(np.asarray, jparams)
    bad["out_proj"] = bad["out_proj"][:, :-1]
    with pytest.raises(ValueError, match="out_proj"):
        params_from_jax(bad, tcfg, device="cpu")


@pytest.mark.parametrize("pallas", [False, True])
def test_encode_and_cross_kv_match_jax(jparams, tparams, pallas):
    jcfg, tcfg = _cfgs(use_pallas_attention=pallas)
    src = _srcs()
    j_enc, j_valid = jnmt._encode(jcfg, jparams, jnp.asarray(src))
    t_enc, t_valid = tnmt._encode(tcfg, tparams, torch.from_numpy(src))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc),
                               atol=1e-5)
    j_ck, j_cv = jnmt._cross_kv(jcfg, jparams, j_enc)
    t_ck, t_cv = tnmt._cross_kv(tcfg, tparams, t_enc)
    np.testing.assert_allclose(t_ck.numpy(), np.asarray(j_ck), atol=1e-5)
    np.testing.assert_allclose(t_cv.numpy(), np.asarray(j_cv), atol=1e-5)


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_ten_paged_steps_match_jax(jparams, tparams, impl):
    jcfg, tcfg = _cfgs(use_pallas_attention=True)
    src = _srcs()
    S, ps, pool_pages = src.shape[0], 4, 12
    pages = np.full((S, 4), pool_pages, np.int32)
    pages[0, :3] = [0, 1, 2]
    pages[1, :3] = [5, 3, 4]
    pages[2, :3] = [8, 7, 6]

    j_enc, j_valid = jnmt._encode(jcfg, jparams, jnp.asarray(src))
    j_ck, j_cv = jnmt._cross_kv(jcfg, jparams, j_enc)
    j_kc, j_vc = jnmt._init_paged_self_cache(jcfg, pool_pages, ps)
    t_enc, t_valid = tnmt._encode(tcfg, tparams, torch.from_numpy(src))
    t_ck, t_cv = tnmt._cross_kv(tcfg, tparams, t_enc)
    t_kc, t_vc = tnmt._init_paged_self_cache(tcfg, pool_pages, ps, "cpu")

    j_step = jax.jit(functools.partial(
        jnmt._decode_tokens_cached, jcfg, page_size=ps, attn_impl=impl))
    j_tok = np.full((S,), jnmt.BOS_ID, np.int32)
    t_tok = j_tok.copy()
    for step in range(10):
        t = np.full((S,), step, np.int32)
        j_logits, j_kc, j_vc = j_step(
            jparams, jnp.asarray(j_tok)[:, None], jnp.asarray(t),
            j_kc, j_vc, j_ck, j_cv, j_valid, pages=jnp.asarray(pages))
        t_logits, t_kc, t_vc = tnmt._decode_tokens_cached(
            tcfg, tparams, torch.from_numpy(t_tok).long()[:, None],
            torch.from_numpy(t), t_kc, t_vc, t_ck, t_cv, t_valid,
            pages=torch.from_numpy(pages), page_size=ps, attn_impl=impl)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=1e-4)
        j_tok = np.asarray(jnp.argmax(j_logits[:, 0], -1)).astype(np.int32)
        t_tok = torch.argmax(t_logits[:, 0], -1).to(torch.int32).numpy()
        np.testing.assert_array_equal(t_tok, j_tok)


@pytest.mark.parametrize("pallas", [False, True])
def test_greedy_decode_tokens_match_jax(jparams, tparams, pallas):
    jcfg, tcfg = _cfgs(use_pallas_attention=pallas)
    src = _srcs()
    ref = np.asarray(jnmt.greedy_decode(jparams, jcfg, src, max_len=12))
    out = tnmt.greedy_decode(tparams, tcfg, src, max_len=12)
    assert out.dtype == torch.int32 and out.shape == (3, 12)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_init_params_has_the_jax_tree_layout(jparams):
    _, tcfg = _cfgs()
    params = tnmt.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    tshapes = jax.tree.map(lambda a: tuple(a.shape), params)
    assert jshapes == tshapes
