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

import math

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


# -- the kernel's work split and arithmetic ---------------------------------


@pytest.mark.parametrize("args,want", [
    # the serving path's decode step: 64 slots, 8 heads of 64, 8 pages of 16
    ((64, 8, 64, 8, 16, 2), (2, 1, 128)),
    ((64, 8, 64, 8, 16, 4), (1, 1, 128)),
    # FLAGSHIP_DECODE: 64 slots, 16 pages of 128
    ((64, 8, 64, 16, 128, 2), (2, 1, 2048)),
    ((64, 8, 64, 16, 128, 4), (1, 1, 2048)),
    # eight slots of the flagship spread over eight ranges
    ((8, 8, 64, 16, 128, 2), (2, 8, 256)),
    # the gpu tests' shapes
    ((5, 4, 64, 6, 12, 2), (2, 1, 96)),
    ((4, 2, 128, 2, 256, 2), (1, 8, 64)),
    ((4, 8, 64, 200, 1, 2), (2, 3, 96)),
    ((4, 2, 64, 40, 12, 2), (2, 5, 96)),
    # an odd head count keeps one head a block; an empty table one range
    ((3, 3, 64, 10, 16, 2), (1, 2, 96)),
    ((4, 8, 64, 0, 16, 2), (2, 1, 32)),
])
def test_split_plan_is_a_function_of_shapes(args, want):
    plan = tppa.split_plan(*args, 132)
    assert tuple(plan) == want
    S, H, hd, P, ps, itemsize = args
    T = P * ps
    # ranges of whole chunks that cover the table, none wholly past it
    assert plan.positions % tppa.CHUNK == 0
    assert plan.nsplit * plan.positions >= T
    assert (plan.nsplit - 1) * plan.positions < max(T, 1)
    assert plan.nsplit == 1 or plan.positions >= tppa.MIN_SPLIT
    assert plan.positions <= max(tppa.MAX_SPLIT, tppa.CHUNK)
    assert H % plan.heads == 0
    # a row segment of heads * hd elements is 256 bytes where it can be
    if itemsize == 2 and H % 2 == 0:
        assert plan.heads * hd * itemsize == 256


def test_split_plan_spreads_few_slots_and_caps_long_tables():
    """Few slots spread over more ranges; a long table is cut into
    ranges of at most MAX_SPLIT positions whatever the slot count."""
    few = tppa.split_plan(2, 8, 64, 64, 16, 2, 132)
    many = tppa.split_plan(512, 8, 64, 64, 16, 2, 132)
    assert few.nsplit > many.nsplit == 1
    long = tppa.split_plan(512, 8, 64, 1000, 16, 2, 132)
    assert long.positions <= tppa.MAX_SPLIT and long.nsplit == 4


def _emulate_kernel(q, kp, vp, pages, pos, H, ps, pool_pages, plan):
    """``csrc/paged_attention.cu``'s arithmetic in plain fp32 torch: each
    split's range cut at the slot's frontier (empty past it); in each
    range, chunks of CHUNK positions, sub-warp ``sw`` of 8 (the fp32
    kernel's; 16 in bf16) taking positions ``8 i + sw`` of a chunk with
    its own online softmax updated
    once a chunk; the sub-warps merged in order, then the splits in order
    (those with l = 0 skipped); a sentinel page or a position past the
    range zero-filled and masked."""
    S, G, D = q.shape
    hd = D // H
    T = pages.shape[1] * ps
    nsw = 8
    neg = -1e30
    out = torch.zeros((S, G, H, hd))
    for s in range(S):
        frontier = int(pos[s].max())
        qh = q[s].reshape(G, H, hd)
        parts = []
        for split in range(plan.nsplit):
            t0 = split * plan.positions
            t_end = min(t0 + plan.positions, frontier + 1, T)
            if t0 >= t_end:
                parts.append((torch.full((G, H), neg), torch.zeros((G, H)),
                              torch.zeros((G, H, hd))))
                continue
            m = torch.full((nsw, G, H), neg)
            l = torch.zeros((nsw, G, H))
            acc = torch.zeros((nsw, G, H, hd))
            for cs in range(t0, t_end, tppa.CHUNK):
                for sw in range(nsw):
                    ts = range(cs + sw, cs + tppa.CHUNK, nsw)
                    sc = torch.full((len(ts), G, H), neg)
                    vr = torch.zeros((len(ts), H, hd))
                    for i, t in enumerate(ts):
                        page = int(pages[s, t // ps]) if t < t_end else -1
                        if not 0 <= page < pool_pages:
                            continue
                        k = kp[page, t % ps].reshape(H, hd)
                        vr[i] = vp[page, t % ps].reshape(H, hd)
                        dot = (qh * k).sum(-1) / math.sqrt(hd)
                        sc[i] = torch.where((t <= pos[s])[:, None], dot,
                                            torch.tensor(neg))
                    mx = torch.maximum(m[sw], sc.amax(0))
                    alpha = torch.exp(m[sw] - mx)
                    p = torch.where(sc > neg / 2, torch.exp(sc - mx), 0.0)
                    l[sw] = l[sw] * alpha + p.sum(0)
                    acc[sw] = acc[sw] * alpha[..., None] + torch.einsum(
                        "igh,ihd->ghd", p, vr)
                    m[sw] = mx
            parts.append(_merge_in_order(m, l, acc, neg))
        M, L, A = _merge_in_order(*map(torch.stack, zip(*parts)), neg)
        out[s] = A / L.clamp_min(1e-30)[..., None]
    return out.reshape(S, G, D)


def _merge_in_order(m, l, acc, neg):
    """(m, l, acc) partials along dim 0 merged in index order; a partial
    that saw no visible position (l = 0) adds nothing."""
    M = m.amax(0)
    L = torch.zeros_like(l[0])
    A = torch.zeros_like(acc[0])
    for i in range(m.shape[0]):
        e = torch.where(l[i] > 0, torch.exp(m[i] - M), 0.0)
        L = L + l[i] * e
        A = A + acc[i] * e[..., None]
    return M, L, A


def _split_table(G, ps, seed, T=96):
    """Four slots over a T-position table: slot 0 owns every page but
    two sentinel holes (page 1, and the page holding position T / 3,
    where the second of three ranges begins); slot 1 half its pages with its frontier
    at their end, so later ranges lie wholly past it; slot 2 one page
    with its frontier at the table's end, so later ranges hold only
    sentinel pages; slot 3 no page (exact zeros)."""
    P = T // ps
    pool = 4 * P
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((4, G, D)).astype(np.float32)
    kp = rng.standard_normal((pool, ps, D)).astype(np.float32)
    vp = rng.standard_normal((pool, ps, D)).astype(np.float32)
    perm = rng.permutation(pool).astype(np.int32)
    pages = np.full((4, P), pool, np.int32)
    pages[0] = perm[:P]
    pages[0, [1, T // 3 // ps]] = pool
    pages[1, :P // 2] = perm[P:P + P // 2]
    pages[2, 0] = perm[2 * P]
    last = np.asarray([P * ps - 1, (P // 2) * ps - 1, P * ps - 1, G - 1])
    pos = (last[:, None] - (G - 1) + np.arange(G)[None, :]).astype(np.int32)
    pos[0, 0] = 40                    # verify queries at other frontiers
    return q, kp, vp, pages, pos, pool


@pytest.mark.parametrize("nsplit", [1, 3])
@pytest.mark.parametrize("G,ps", [(1, 1), (2, 4), (3, 12), (4, 4),
                                  (3, 1), (1, 12)])
def test_kernel_arithmetic_matches_jax_kernel_and_plain(G, ps, nsplit):
    q, kp, vp, pages, pos, pool = _split_table(G, ps, seed=G * 13 + ps)
    kw = dict(num_heads=H, page_size=ps)
    ref = np.asarray(jppa.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, pages, pos)), impl="kernel",
        interpret=True, **kw))
    t = [torch.from_numpy(x) for x in (q, kp, vp, pages, pos)]
    plain = tppa.paged_decode_attention_plain(*t, **kw)
    plan = tppa.SplitPlan(1, nsplit, -(-96 // nsplit))
    assert plan.positions % tppa.CHUNK == 0
    got = _emulate_kernel(*t, H, ps, pool, plan)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    assert torch.equal(got[3], torch.zeros_like(got[3]))


def test_kernel_arithmetic_under_the_planned_split():
    """The split ``split_plan`` picks for a few slots on a small card
    (several ranges, some wholly past a frontier) gives the plain
    version's result."""
    q, kp, vp, pages, pos, pool = _split_table(3, 4, seed=5, T=192)
    plan = tppa.split_plan(4, H, D // H, pages.shape[1], 4, 4, 32)
    assert tuple(plan) == (1, 3, 64)
    t = [torch.from_numpy(x) for x in (q, kp, vp, pages, pos)]
    plain = tppa.paged_decode_attention_plain(*t, num_heads=H, page_size=4)
    got = _emulate_kernel(*t, H, 4, pool, plan)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)


def test_kernel_refuses_a_misaligned_base():
    """16-byte copies: a q or pool view that starts off a 16-byte
    boundary is refused before anything launches."""
    hd, heads = 64, 2
    flat = torch.zeros(4 * 4 * heads * hd + 1, dtype=torch.bfloat16)
    pool = flat[1:].view(4, 4, heads * hd)
    assert pool.is_contiguous() and pool.data_ptr() % 16
    q = torch.zeros((2, 1, heads * hd), dtype=torch.bfloat16)
    good = torch.zeros((4, 4, heads * hd), dtype=torch.bfloat16)
    pages = torch.zeros((2, 1), dtype=torch.int32)
    pos = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte"):
        tppa._check_kernel_inputs(q, pool, good, pages, pos, heads)
    with pytest.raises(ValueError, match="16-byte"):
        tppa._check_kernel_inputs(q, good, pool, pages, pos, heads)
    tppa._check_kernel_inputs(q, good, good, pages, pos, heads)
