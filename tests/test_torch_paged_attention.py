"""The port's paged-decode attention against the JAX package's.

The same numpy inputs go through ``parallax_tpu.ops.
pallas_paged_attention`` (the Pallas kernel in interpret mode) and
through ``parallax_tpu_torch.ops.paged_attention`` on CPU tensors (its
plain version, the function the CUDA kernel is held to on the card),
on a ragged page table with a sentinel tail and a slot that holds no
page at all. fp32, atol 2e-5. Also: the sentinel write coordinates and
the read gather against JAX's, and the port's own pool layout — the
spare page that sentinel writes land in.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.ops import pallas_paged_attention as jppa
from parallax_tpu_torch.models import nmt
from parallax_tpu_torch.ops import paged_attention as tppa

ATOL = 2e-5
S, D, H, PS, P, POOL = 4, 32, 2, 4, 4, 12


def _ragged(G, seed=0):
    """The ragged table: slot 0 owns 4 pages, slot 1 two, slot 2 one,
    slot 3 none (all sentinel)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, G, D)).astype(np.float32)
    kp = rng.standard_normal((POOL, PS, D)).astype(np.float32)
    vp = rng.standard_normal((POOL, PS, D)).astype(np.float32)
    pages = np.full((S, P), POOL, np.int32)
    pages[0, :4] = [0, 1, 2, 3]
    pages[1, :2] = [4, 5]
    pages[2, :1] = [6]
    pos = np.asarray([[13, 14, 15], [5, 6, 7], [1, 2, 3],
                      [0, 1, 2]], np.int32)[:, :G]
    return q, kp, vp, pages, pos


@pytest.mark.parametrize("G", [1, 3])
def test_matches_jax_kernel_on_ragged_table(G):
    q, kp, vp, pages, pos = _ragged(G)
    kw = dict(num_heads=H, page_size=PS)
    ref = np.asarray(jppa.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, pages, pos)), impl="kernel",
        interpret=True, **kw))
    out = tppa.paged_decode_attention(
        *map(torch.from_numpy, (q, kp, vp, pages, pos)), **kw)
    assert out.shape == (S, G, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    # slot 3 holds ZERO live pages: exact zeros, never NaN
    assert torch.equal(out[3], torch.zeros_like(out[3]))


@pytest.mark.parametrize("G", [1, 3])
def test_spare_page_is_masked_like_a_sentinel(G):
    """A pool with one spare page past ``pool_pages`` (the port's
    layout) gives the same result as the pool without it, whatever the
    spare page holds."""
    q, kp, vp, pages, pos = _ragged(G)
    spare = np.full((1, PS, D), 1e3, np.float32)
    kw = dict(num_heads=H, page_size=PS)
    base = tppa.paged_decode_attention(
        *map(torch.from_numpy, (q, kp, vp, pages, pos)), **kw)
    with_spare = tppa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(np.concatenate([kp, spare])),
        torch.from_numpy(np.concatenate([vp, spare])),
        torch.from_numpy(pages), torch.from_numpy(pos), pool_pages=POOL,
        **kw)
    assert torch.equal(base, with_spare)


def test_sentinel_write_coords_match_jax():
    rng = np.random.default_rng(1)
    pages = rng.integers(0, 10, (5, 4)).astype(np.int32)
    pages[1, 2:] = 10                 # sentinel tail
    pages[4] = 10                     # no page at all
    pos = rng.integers(0, 20, (5, 3)).astype(np.int32)   # some past P*ps
    jpg, joff = jppa.sentinel_write_coords(jnp.asarray(pages),
                                           jnp.asarray(pos), 4, 10)
    tpg, toff = tppa.sentinel_write_coords(torch.from_numpy(pages),
                                           torch.from_numpy(pos), 4, 10)
    np.testing.assert_array_equal(tpg.numpy(), np.asarray(jpg))
    np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))


def test_paged_gather_matches_jax():
    q, kp, vp, pages, pos = _ragged(1)
    ref = np.asarray(jppa.paged_gather(jnp.asarray(kp),
                                       jnp.asarray(pages)))
    out = tppa.paged_gather(torch.from_numpy(kp), torch.from_numpy(pages))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_kernel_hbm_bytes_matches_jax():
    args = (64, 3, 512, 128, 64 * 16, 2)
    assert tppa.kernel_hbm_bytes(*args, num_layers=6) == \
        jppa.kernel_hbm_bytes(*args, num_layers=6)


def test_decode_writes_land_in_own_pages_or_the_spare_page():
    """One paged decode step: slot 0 writes position 5 into its second
    page; slot 1 has no page for position 9 (sentinel) and slot 2's
    position lies past the table — both write the spare page, and no
    other page changes."""
    cfg = nmt.tiny_config(vocab_size=64, model_dim=16, num_heads=2,
                          mlp_dim=32, num_layers=2, max_len=16,
                          num_partitions=1, compute_dtype=torch.float32)
    params = nmt.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    pool_pages, ps = 6, 4
    kc, vc = nmt._init_paged_self_cache(cfg, pool_pages, ps, "cpu")
    assert kc.shape == (2, pool_pages + 1, ps, 16)
    pages = torch.tensor([[0, 1, 6, 6], [2, 3, 6, 6], [4, 5, 6, 6]],
                         dtype=torch.int32)
    t = torch.tensor([5, 9, 17], dtype=torch.int32)
    tok = torch.tensor([[3], [4], [5]])
    src = torch.tensor([[3, 4, 5, 0]] * 3)
    enc, valid = nmt._encode(cfg, params, src)
    ck, cv = nmt._cross_kv(cfg, params, enc)
    nmt._decode_tokens_cached(cfg, params, tok, t, kc, vc, ck, cv, valid,
                              pages=pages, page_size=ps)
    written = (kc != 0).any(dim=-1)              # [L, pool+1, ps]
    for layer in range(cfg.num_layers):
        hit = {(int(p), int(o)) for p, o in written[layer].nonzero()}
        assert hit == {(1, 1), (pool_pages, 1)}
