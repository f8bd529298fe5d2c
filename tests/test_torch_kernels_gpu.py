"""The CUDA kernels against their plain versions, on the card.

Ragged and odd shapes the main paths do not reach (Tq and Tk off the
64-row tile, Tq != Tk under causal masking, hd = 128, fully masked rows
for the flash forward and backward, G = 2, page sizes
that do not divide the 128-position chunk; LSTM B, H and P off every
tile, T = 1, B = 1), fp32 with TF32 off (atol 2e-5; the flash gradients
2e-5 of max(1, peak), they sum over a whole sequence; the LSTM kernels
1e-4 of max(1, peak), their time loops compound the reassociation) and
bf16 (atol 2e-2 of the plain output's peak). Every test
here needs a CUDA card and skips without one; run them on the card
with ``python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q``.
"""

import numpy as np
import pytest
import torch

from parallax_tpu_torch.ops import flash_attention as fa
from parallax_tpu_torch.ops import lstm
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


def _grad_close(got, want, dtype):
    """Gradients sum over a whole sequence: fp32 atol 2e-5 of max(1,
    peak), bf16 2e-2 of the peak."""
    peak = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    tol = 2e-5 * max(1.0, peak) if dtype == torch.float32 else 2e-2 * peak
    assert err <= tol, (err, tol)


def _flash_bwd_inputs(cuda, dtype, B, Tq, Tk, H, hd, masked, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def r(shape):
        return torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    q, k, v, dout = r((B, Tq, H, hd)), r((B, Tk, H, hd)), \
        r((B, Tk, H, hd)), r((B, Tq, H, hd))
    mask = None
    if masked:
        mask = (torch.rand((B, Tk), generator=g, device=cuda) < 0.6).int()
        mask[0] = 0                      # batch 0: every row fully masked
    return q, k, v, dout, mask


FLASH_BWD_CASES = [
    (2, 100, 37, 3, 64, False, True),
    (1, 37, 100, 2, 128, True, False),
    (3, 130, 130, 2, 128, True, True),
    (1, 1, 65, 1, 64, False, True),
    (2, 65, 64, 2, 64, True, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tq,Tk,H,hd,causal,masked", FLASH_BWD_CASES)
def test_flash_backward_kernels_match_plain(cuda, dtype, B, Tq, Tk, H, hd,
                                            causal, masked):
    """B5 and B6 against their plain versions on the same out and lse."""
    q, k, v, dout, mask = _flash_bwd_inputs(cuda, dtype, B, Tq, Tk, H, hd,
                                            masked)
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal, kv_mask=mask)
    delta = fa.flash_delta(out, dout)
    args = (q, k, v, mask, dout, lse, delta, causal)
    before = (fa.launches_dq, fa.launches_dkv)
    dq = fa.flash_dq(*args)
    dk, dv = fa.flash_dkv(*args)
    ref_dq = fa.flash_dq_plain(*args)
    ref_dk, ref_dv = fa.flash_dkv_plain(*args)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkv) == tuple(n + 1 for n in before)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == dtype
        _grad_close(got, want, dtype)
    if masked:
        for got in (dq, dk, dv):
            assert torch.all(got[0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradient_is_bitwise_repeatable_and_launches_once(cuda,
                                                                dtype):
    """Two backward runs give the same bits (no atomics); each autograd
    call launches the forward, dq and dk/dv kernels once each, and the
    gradient agrees with the plain attention's own gradient."""
    q, k, v, dout, mask = _flash_bwd_inputs(cuda, dtype, 2, 70, 90, 2, 64,
                                            True, seed=3)
    grads = []
    for _ in range(2):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (fa.launches, fa.launches_dq, fa.launches_dkv)
        out, lse = fa.flash_attention_lse(*qkv, kv_mask=mask)
        torch.autograd.backward((out, lse), (dout, torch.ones_like(lse)))
        torch.cuda.synchronize()
        assert (fa.launches, fa.launches_dq, fa.launches_dkv) == \
            tuple(n + 1 for n in before)
        grads.append([t.grad for t in qkv])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = fa.flash_attention_lse(*qkv, kv_mask=mask, xla_backward=True)
    torch.autograd.backward((out, lse), (dout, torch.ones_like(lse)))
    for got, want in zip(grads[0], (t.grad for t in qkv)):
        _grad_close(got, want, dtype)


def test_flash_backward_kernels_refuse_what_they_do_not_take(cuda):
    lse = torch.zeros((1, 2, 8), device=cuda)
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="takes"):
        fa.flash_dq(q, q, q, None, q, lse, lse)
    q = torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_dkv(q, q, q, None, q, lse, lse)
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="on cpu"):
        fa.flash_dq(q, q.cpu(), q, None, q, lse, lse)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_dq(q, q, q, None, q.transpose(1, 2).contiguous()
                    .transpose(1, 2), lse, lse)


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


def _lstm_close(got, want, dtype, what):
    got, want = got.float(), want.float()
    peak = want.abs().max().item()
    tol = 1e-4 * max(1.0, peak) if dtype == torch.float32 else 2e-2 * peak
    err = (got - want).abs().max().item()
    assert err <= tol, (what, err, tol)


def _lstm_inputs(cuda, dtype, T, B, H, P):
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=g, device=cuda) * scale).to(dt)
    return (r((T, B, 4 * H), 1.0), r((P, 4 * H), 1.0 / np.sqrt(P)),
            r((H, P), 1.0 / np.sqrt(H)), r((T, B, P), 1.0, torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H,P", [
    (5, 6, 40, 24),
    (1, 3, 12, 8),
    (3, 1, 70, 33),
    (4, 130, 100, 65),
    (2, 128, 2048, 512),
])
def test_lstm_kernels_match_plain(cuda, dtype, T, B, H, P):
    xw, w_h, w_proj, gout = _lstm_inputs(cuda, dtype, T, B, H, P)
    before = (lstm.launches_fwd, lstm.launches_fwd_res, lstm.launches_bwd)
    hs = lstm.lstm_recurrence(xw, w_h, w_proj)
    res = lstm.lstm_recurrence(xw, w_h, w_proj, residuals=True)
    ref = lstm.lstm_recurrence_plain(xw, w_h, w_proj, residuals=True)
    # B3 on the plain residuals, so both versions see the same inputs
    dxw, dhtot = lstm.lstm_bwd_recurrence(gout, ref[1], ref[2], w_h,
                                          w_proj)
    ref_dxw, ref_dhtot = lstm.lstm_bwd_recurrence_plain(
        gout, ref[1], ref[2], w_h, w_proj)
    torch.cuda.synchronize()
    assert (lstm.launches_fwd, lstm.launches_fwd_res,
            lstm.launches_bwd) == tuple(n + 1 for n in before)
    _lstm_close(hs, ref[0], dtype, "B1 hs")
    for got, want, what in zip(res, ref, ("hs", "gates", "c")):
        assert got.dtype == dtype
        _lstm_close(got, want, dtype, f"B2 {what}")
    assert dxw.dtype == dtype and dhtot.dtype == torch.float32
    _lstm_close(dxw, ref_dxw, dtype, "B3 d_xw")
    _lstm_close(dhtot, ref_dhtot, dtype, "B3 dh_total")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_scan_kernel_grads_match_scan_backward(cuda, dtype):
    """The autograd.Function on the card: B2 forward and B3 backward
    against the plain residual backward (``bwd_impl="scan"``)."""
    T, B, E, H, P = 4, 10, 24, 36, 20
    g = torch.Generator(device=cuda).manual_seed(1)

    def r(shape, scale):
        return (torch.randn(shape, generator=g, device=cuda)
                * scale).to(dtype).requires_grad_()
    args = (r((T, B, E), 0.5), r((E + P, 4 * H), 1.0 / np.sqrt(E + P)),
            r((4 * H,), 0.1), r((H, P), 1.0 / np.sqrt(H)))
    gout = torch.randn((T, B, P), generator=g, device=cuda)
    grads = {}
    for bwd in ("kernel", "scan"):
        before = (lstm.launches_fwd_res, lstm.launches_bwd)
        out = lstm.lstm_scan(*args, impl="kernel", bwd_impl=bwd)
        grads[bwd] = torch.autograd.grad((out.float() * gout).sum(), args)
        torch.cuda.synchronize()
        assert lstm.launches_fwd_res == before[0] + 1
        assert lstm.launches_bwd == before[1] + (bwd == "kernel")
    for got, want, name in zip(grads["kernel"], grads["scan"],
                               ("x", "w", "b", "w_proj")):
        _lstm_close(got, want, dtype, name)


def test_lstm_kernels_refuse_what_they_do_not_take(cuda):
    xw = torch.zeros((2, 3, 32), device=cuda)
    w_h = torch.zeros((4, 32), device=cuda)
    w_proj = torch.zeros((8, 4), device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        lstm.lstm_recurrence(xw, w_h.bfloat16(), w_proj)
    with pytest.raises(ValueError, match="takes"):
        lstm.lstm_recurrence(xw.half(), w_h.half(), w_proj.half())
    with pytest.raises(ValueError, match="do not fit"):
        lstm.lstm_recurrence(xw, w_h[:, :16], w_proj)
    with pytest.raises(ValueError, match="contiguous"):
        lstm.lstm_recurrence(xw.transpose(0, 1).contiguous().transpose(0, 1),
                             w_h, w_proj)
