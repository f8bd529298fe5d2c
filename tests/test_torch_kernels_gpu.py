"""The CUDA kernels against their plain versions, on the card.

Ragged and odd shapes the serving path does not reach (Tq and Tk off
the 64-row tile, Tq != Tk under causal masking, hd = 128, G = 2, page
sizes that do not divide the 128-position chunk), fp32 with TF32 off
(atol 2e-5) and bf16 (atol 2e-2 of the plain output's peak). Every test
here needs a CUDA card and skips without one; run them on the card
with ``python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q``.
"""

import numpy as np
import pytest
import torch

from parallax_tpu_torch.ops import flash_attention as fa
from parallax_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    tol = 2e-5 if dtype == torch.float32 else \
        2e-2 * want.float().abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,Tk,H,hd,causal,masked", [
    (2, 100, 37, 3, 64, False, True),
    (1, 37, 100, 2, 128, True, False),
    (3, 130, 130, 2, 128, True, True),
    (1, 1, 65, 1, 64, False, True),
])
def test_flash_kernel_matches_plain(cuda, dtype, B, Tq, Tk, H, hd, causal,
                                    masked):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, Tq, H, hd), generator=g, device=cuda, dtype=dtype)
    k = torch.randn((B, Tk, H, hd), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((B, Tk, H, hd), generator=g, device=cuda, dtype=dtype)
    mask = None
    if masked:
        mask = (torch.rand((B, Tk), generator=g, device=cuda) < 0.6).int()
        mask[0] = 0                      # batch 0: every row fully masked
    before = fa.launches
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal, kv_mask=mask)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            kv_mask=mask)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    _close(out, ref, dtype)
    live = slice(1, None) if masked else slice(None)
    np.testing.assert_allclose(lse[live].cpu().numpy(),
                               ref_lse[live].cpu().numpy(), atol=1e-4,
                               rtol=1e-5)
    if masked:
        assert torch.all(out[0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,G,H,hd,ps,P", [
    (5, 2, 4, 64, 12, 6),
    (4, 4, 2, 128, 256, 2),
    (4, 1, 8, 64, 1, 200),
])
def test_paged_kernel_matches_plain(cuda, dtype, S, G, H, hd, ps, P):
    rng = np.random.default_rng(0)
    pool_pages = S * P
    D = H * hd
    pages = np.full((S, P), pool_pages, np.int32)
    pos = np.zeros((S, G), np.int32)
    perm = rng.permutation(pool_pages)
    for s in range(S):
        n = [P, P // 2, 1, 0][s % 4]
        pages[s, :n] = perm[s * P:s * P + n]
        last = max(n * ps - 1, G - 1)
        pos[s] = last - (G - 1) + np.arange(G)
    pages[0, 1] = pool_pages              # a sentinel hole mid-table
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((S, G, D), generator=g, device=cuda, dtype=dtype)
    kp = torch.randn((pool_pages + 1, ps, D), generator=g, device=cuda,
                     dtype=dtype)
    vp = torch.randn((pool_pages + 1, ps, D), generator=g, device=cuda,
                     dtype=dtype)
    args = (q, kp, vp, torch.from_numpy(pages).to(cuda),
            torch.from_numpy(pos).to(cuda))
    kw = dict(num_heads=H, page_size=ps, pool_pages=pool_pages)
    before = pa.launches
    out = pa.paged_decode_attention(*args, **kw)
    ref = pa.paged_decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    _close(out, ref, dtype)
    assert torch.all(out[3] == 0)         # the slot with no page


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="takes"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((2, 5, 128), device=cuda)
    pool = torch.zeros((4, 4, 128), device=cuda)
    pages = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    pos = torch.zeros((2, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="G <="):
        pa.paged_decode_attention(q, pool, pool, pages, pos, num_heads=2,
                                  page_size=4)
