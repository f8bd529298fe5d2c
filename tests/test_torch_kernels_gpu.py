"""The CUDA kernels against their plain versions, on the card.

Ragged and odd shapes the main paths do not reach (Tq and Tk off the
64-row tile, Tq != Tk under causal masking, hd = 128, more streamed
tiles than the bf16 kernels' ring has stages (T 300 and 1024), fully masked
rows for the flash forward and backward, G = 2, page sizes
that do not divide the 32-position chunk, paged ranges wholly past a
frontier or holding only sentinel pages; LSTM B, H and P off every
tile, T = 1, B = 1), fp32 with TF32 off (atol 2e-5; the flash gradients
2e-5 of max(1, peak), they sum over a whole sequence; the LSTM kernels
1e-4 of max(1, peak), their time loops compound the reassociation) and
bf16 (atol 2e-2 of the plain output's peak). Every test
here needs a CUDA card and skips without one; run them on the card
with ``python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q``.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from parallax_tpu_torch.ops import _cuda
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
    (2, 300, 300, 2, 64, False, True),
    (1, 1024, 1024, 2, 128, True, False),
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
        assert torch.all(lse[0] < -1e29)


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
    (2, 300, 300, 2, 64, False, True),
    (1, 1024, 1024, 2, 128, True, False),
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dkv_without_queries_gives_zeros(cuda, dtype):
    """Tq = 0: no query sees a key, so dk and dv are zeros; the bf16
    kernel builds no tensor map over the empty q and dO."""
    q = torch.zeros((2, 0, 2, 64), device=cuda, dtype=dtype)
    k = torch.randn((2, 70, 2, 64), device=cuda, dtype=dtype)
    lse = torch.zeros((2, 2, 0), device=cuda)
    before = fa.launches_dkv
    dk, dv = fa.flash_dkv(q, k, k, None, q, lse, lse)
    torch.cuda.synchronize()
    assert fa.launches_dkv == before + 1
    assert torch.all(dk == 0) and torch.all(dv == 0)


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


def _kernel_names(fn):
    """Names of the CUDA kernels ``fn`` launches, from the profiler. The
    window starts and ends with 16 one-element fills, so that a record the
    profiler loses at a window's edge is not one of ``fn``'s."""
    from torch.profiler import ProfilerActivity, profile
    pad = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(16):
            pad.fill_(0.0)
        fn()
        for _ in range(16):
            pad.fill_(0.0)
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dtype_picks_the_kernel(cuda, dtype):
    """bf16 forward, dq and dk/dv launch the sm90 (TMA + wgmma) kernels,
    fp32 the fp32-FMA ones; each call counts one launch either way."""
    q, k, v, dout, mask = _flash_bwd_inputs(cuda, dtype, 2, 64, 64, 2, 64,
                                            True)
    out, lse = fa.flash_attention_plain(q, k, v, kv_mask=mask)
    delta = fa.flash_delta(out, dout)
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    names = _kernel_names(lambda: (
        fa.flash_attention_lse(q, k, v, kv_mask=mask),
        fa.flash_dq(q, k, v, mask, dout, lse, delta),
        fa.flash_dkv(q, k, v, mask, dout, lse, delta)))
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == \
        tuple(n + 1 for n in before)
    for kernel in ("flash_fwd_kernel", "flash_dq_kernel",
                   "flash_dkv_kernel"):
        sm90 = [n for n in names if f"{kernel}_sm90" in n]
        fp32 = [n for n in names if kernel in n and "sm90" not in n]
        assert (len(sm90), len(fp32)) == \
            ((1, 0) if dtype == torch.bfloat16 else (0, 1)), names


def test_flash_bf16_refuses_a_misaligned_view(cuda):
    """TMA needs each base pointer on 16 bytes: a contiguous view that
    starts one element in raises instead of launching anything."""
    shape = (1, 64, 2, 64)
    flat = torch.zeros(int(np.prod(shape)) + 1, device=cuda,
                       dtype=torch.bfloat16)
    bad = flat[1:].view(shape)
    good = torch.zeros(shape, device=cuda, dtype=torch.bfloat16)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(bad, good, good)
    lse = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_dq(good, good, good, None, bad, lse, lse)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_dkv(good, good, good, None, bad, lse, lse)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == before


def _cuobjdump():
    tool = shutil.which("cuobjdump")
    if tool is None and os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        tool = "/usr/local/cuda/bin/cuobjdump"
    if tool is None:
        pytest.skip("cuobjdump not found (PATH, /usr/local/cuda/bin)")
    return tool


def test_flash_sm90_kernels_use_tma_and_wgmma(cuda):
    """The built library's SASS: the three kernels (at hd 64 and 128)
    issue HGMMA (wgmma) and UTMALDG (TMA loads)."""
    _cuda.library("flash_attention_sm90")
    sass = subprocess.run(
        [_cuobjdump(), "-sass",
         str(_cuda.library_path("flash_attention_sm90"))],
        capture_output=True, text=True, check=True).stdout
    functions = {}
    for part in sass.split("Function : ")[1:]:
        functions[part.split("\n", 1)[0].strip()] = part
    for kernel in ("flash_fwd_kernel_sm90", "flash_dq_kernel_sm90",
                   "flash_dkv_kernel_sm90"):
        bodies = [b for name, b in functions.items() if kernel in name]
        assert len(bodies) == 2, (kernel, list(functions))   # hd 64, 128
        for body in bodies:
            assert "HGMMA" in body and "UTMALDG" in body, kernel


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


def _paged_inputs(cuda, dtype, pages, pos, H, hd, ps, pool_pages, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    S, G = pos.shape
    q = torch.randn((S, G, H * hd), generator=g, device=cuda, dtype=dtype)
    # the port's pool layout: one spare page past pool_pages
    kp = torch.randn((pool_pages + 1, ps, H * hd), generator=g, device=cuda,
                     dtype=dtype)
    vp = torch.randn((pool_pages + 1, ps, H * hd), generator=g, device=cuda,
                     dtype=dtype)
    return (q, kp, vp, torch.from_numpy(pages).to(cuda),
            torch.from_numpy(pos).to(cuda))


def _paged_plan(args, H):
    q, kp, _, pages, _ = args
    return pa.split_plan(q.shape[0], H, q.shape[2] // H, pages.shape[1],
                         kp.shape[1], q.element_size(),
                         torch.cuda.get_device_properties(q.device)
                         .multi_processor_count)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,H,hd,ps,P", [
    (3, 2, 64, 12, 40),
    (1, 4, 128, 4, 64),
    (4, 3, 64, 1, 300),
    (2, 2, 64, 256, 3),
])
def test_paged_kernel_splits_match_plain(cuda, dtype, G, H, hd, ps, P):
    """Shapes whose plan splits each slot's positions: slot 0 owns every
    page but a sentinel hole where its second range begins, slot 1 half
    its pages (later ranges lie past its frontier), slot 2 one page with
    its frontier at the table's end (later ranges hold only sentinel
    pages), slot 3 none (exact zeros). Each call launches the decode
    kernel once and the combine kernel once, as ``split_plan`` says."""
    pool_pages = 4 * P
    rng = np.random.default_rng(1)
    perm = rng.permutation(pool_pages).astype(np.int32)
    pages = np.full((4, P), pool_pages, np.int32)
    pages[0] = perm[:P]
    pages[1, :P // 2] = perm[P:P + P // 2]
    pages[2, 0] = perm[2 * P]
    last = np.asarray([P * ps - 1, (P // 2) * ps - 1, P * ps - 1, G - 1])
    pos = (last[:, None] - (G - 1) + np.arange(G)[None, :]).astype(np.int32)
    pos[0, 0] = min(40, P * ps - 1)   # verify queries at other frontiers
    args = _paged_inputs(cuda, dtype, pages, pos, H, hd, ps, pool_pages)
    plan = _paged_plan(args, H)
    assert plan.nsplit > 1
    pages[0, plan.positions // ps] = pool_pages
    args = args[:3] + (torch.from_numpy(pages).to(cuda),) + args[4:]
    kw = dict(num_heads=H, page_size=ps, pool_pages=pool_pages)
    before = (pa.launches, pa.launches_combine)
    out = pa.paged_decode_attention(*args, **kw)
    ref = pa.paged_decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert (pa.launches, pa.launches_combine) == (before[0] + 1,
                                                  before[1] + 1)
    _close(out, ref, dtype)
    assert torch.all(out[3] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("occupancy", [1.0, 0.25])
def test_paged_kernel_matches_plain_at_flagship(cuda, dtype, G, occupancy):
    """FLAGSHIP_DECODE (64 slots, 8 heads of 64, 16 pages of 128): each
    slot but slot 0 (no page) owns ``occupancy`` of its table, frontier
    at its last live position."""
    F = pa.FLAGSHIP_DECODE
    S, P, ps, pool_pages = F["S"], F["P"], F["page_size"], F["pool_pages"]
    rng = np.random.default_rng(2)
    perm = rng.permutation(pool_pages).astype(np.int32)
    pages = np.full((S, P), pool_pages, np.int32)
    pos = np.zeros((S, G), np.int32)
    n = int(P * occupancy)
    for s in range(1, S):
        pages[s, :n] = perm[(s - 1) * n:s * n]
        pos[s] = n * ps - G + np.arange(G)
    pos[0] = np.arange(G)
    args = _paged_inputs(cuda, dtype, pages, pos, F["num_heads"],
                         F["D"] // F["num_heads"], ps, pool_pages)
    kw = dict(num_heads=F["num_heads"], page_size=ps, pool_pages=pool_pages)
    plan = _paged_plan(args, F["num_heads"])
    before = (pa.launches, pa.launches_combine)
    out = pa.paged_decode_attention(*args, **kw)
    ref = pa.paged_decode_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert (pa.launches, pa.launches_combine) == (
        before[0] + 1, before[1] + int(plan.nsplit > 1))
    _close(out, ref, dtype)
    assert torch.all(out[0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_is_bitwise_repeatable(cuda, dtype):
    """No atomics: 10 back-to-back calls and a call on a second stream
    give the same bits, at a shape whose plan splits the positions."""
    S, G, H, hd, ps, P = 8, 3, 8, 64, 16, 32
    pool_pages = S * P
    rng = np.random.default_rng(3)
    pages = rng.permutation(pool_pages).astype(np.int32).reshape(S, P)
    pages[1, 5:] = pool_pages
    pos = (rng.integers(G, P * ps, (S, 1)) - np.arange(G)).astype(np.int32)
    args = _paged_inputs(cuda, dtype, pages, pos, H, hd, ps, pool_pages)
    assert _paged_plan(args, H).nsplit > 1
    kw = dict(num_heads=H, page_size=ps, pool_pages=pool_pages)
    outs = [pa.paged_decode_attention(*args, **kw) for _ in range(10)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs.append(pa.paged_decode_attention(*args, **kw))
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    _close(outs[0], pa.paged_decode_attention_plain(*args, **kw), dtype)


def test_paged_kernel_refuses_a_misaligned_pool(cuda):
    """16-byte cp.async copies: a contiguous pool view that starts one
    element in raises instead of launching anything."""
    H, hd, ps = 2, 64, 4
    flat = torch.zeros(5 * ps * H * hd + 1, device=cuda,
                       dtype=torch.bfloat16)
    bad = flat[1:].view(5, ps, H * hd)
    good = torch.zeros((5, ps, H * hd), device=cuda, dtype=torch.bfloat16)
    q = torch.zeros((2, 1, H * hd), device=cuda, dtype=torch.bfloat16)
    pages = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    pos = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    before = (pa.launches, pa.launches_combine)
    for k, v in ((bad, good), (good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            pa.paged_decode_attention(q, k, v, pages, pos, num_heads=H,
                                      page_size=ps, pool_pages=4)
    assert (pa.launches, pa.launches_combine) == before


def test_paged_kernel_uses_cp_async(cuda):
    """The built library's SASS: the decode kernel (20 instantiations:
    fp32 hd 64/128, bf16 hd 64 with one or two heads a block and hd 128,
    each for G 1-4) issues LDGSTS (cp.async), and no first kernel is
    left in it."""
    _cuda.library("paged_attention")
    sass = subprocess.run(
        [_cuobjdump(), "-sass", str(_cuda.library_path("paged_attention"))],
        capture_output=True, text=True, check=True).stdout
    functions = {}
    for part in sass.split("Function : ")[1:]:
        functions[part.split("\n", 1)[0].strip()] = part
    bodies = [b for name, b in functions.items()
              if "paged_decode_kernel_sm90" in name]
    assert len(bodies) == 20, list(functions)
    for body in bodies:
        assert "LDGSTS" in body
    stale = [n for n in functions if "paged_decode_kernel" in n
             and "paged_decode_kernel_sm90" not in n]
    assert not stale, stale


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
    # bf16 runs these on the persistent kernel (csrc/lstm_sm90.cu): T 1
    # and B 1; B 100 (a ragged second row tile); H 1040 and P 520 (P and H
    # off the 64-wide chunks: zero fill); H 4096 (32 units a block)
    (1, 1, 256, 64),
    (3, 100, 512, 128),
    (3, 128, 1040, 520),
    (2, 64, 4096, 256),
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


def test_lstm_sm90_kernel_uses_tma_and_wgmma(cuda):
    """The built library's SASS: the persistent forward (B1 and B2, 16 and
    32 units a block) issues HGMMA (wgmma) and UTMALDG (TMA loads)."""
    _cuda.library("lstm_sm90")
    sass = subprocess.run(
        [_cuobjdump(), "-sass", str(_cuda.library_path("lstm_sm90"))],
        capture_output=True, text=True, check=True).stdout
    bodies = [part for part in sass.split("Function : ")[1:]
              if "lstm_fwd_kernel_sm90" in part.split("\n", 1)[0]]
    assert len(bodies) == 4, sass[:2000]    # G 1, 2 x B1, B2
    for body in bodies:
        assert "HGMMA" in body and "UTMALDG" in body


def test_lstm_bf16_lm1b_shape_takes_the_sm90_route(cuda):
    """At the LM1B step's shape bf16 B1 and B2 launch the persistent
    kernel, one launch a call, and fp32 the first kernel; each call counts
    one launch either way."""
    T, B, H, P = 20, 128, 2048, 512
    for dtype, sm90 in ((torch.bfloat16, True), (torch.float32, False)):
        xw, w_h, w_proj, _ = _lstm_inputs(cuda, dtype, T, B, H, P)
        assert (lstm.device_fwd_route(xw, w_proj).source == "lstm_sm90") \
            == sm90
        before = (lstm.launches_fwd, lstm.launches_fwd_res)
        names = _kernel_names(lambda: (
            lstm.lstm_recurrence(xw, w_h, w_proj),
            lstm.lstm_recurrence(xw, w_h, w_proj, residuals=True)))
        assert (lstm.launches_fwd, lstm.launches_fwd_res) == \
            (before[0] + 1, before[1] + 1)
        persistent = [n for n in names if "lstm_fwd_kernel_sm90" in n]
        first = [n for n in names if "lstm_gates_kernel" in n]
        assert (len(persistent), len(first)) == \
            ((2, 0) if sm90 else (0, 2)), names


def test_lstm_sm90_is_bitwise_repeatable(cuda):
    """10 back-to-back B2 calls at the LM1B shape give the same bits in
    hs, gates and c, and so do calls on a second stream (each call zeroes
    its own grid-barrier counter on the stream it runs on)."""
    xw, w_h, w_proj, _ = _lstm_inputs(cuda, torch.bfloat16, 20, 128, 2048,
                                      512)
    first = lstm.lstm_recurrence(xw, w_h, w_proj, residuals=True)
    runs = [lstm.lstm_recurrence(xw, w_h, w_proj, residuals=True)
            for _ in range(9)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs += [lstm.lstm_recurrence(xw, w_h, w_proj, residuals=True)
                 for _ in range(2)]
    torch.cuda.synchronize()
    for run in runs:
        for got, want in zip(run, first):
            assert torch.equal(got, want)


def test_lstm_sm90_refuses_a_misaligned_weight(cuda):
    """The persistent kernel copies w_h and w_proj with 16-byte loads: a
    contiguous view that starts one element in raises before anything
    launches."""
    xw, w_h, w_proj, _ = _lstm_inputs(cuda, torch.bfloat16, 2, 64, 256, 64)
    flat = torch.zeros(w_proj.numel() + 1, device=cuda,
                       dtype=torch.bfloat16)
    bad = flat[1:].view(w_proj.shape)
    bad.copy_(w_proj)
    before = lstm.launches_fwd
    with pytest.raises(ValueError, match="16-byte"):
        lstm.lstm_recurrence(xw, w_h, bad)
    assert lstm.launches_fwd == before


# -- the persistent bf16 backward (B3, csrc/lstm_sm90.cu) ----------------------


@pytest.mark.parametrize("T,B,H,P,groups", [
    (20, 128, 2048, 512, 2),    # the LM1B step: 64 blocks of 32 units
    (1, 1, 256, 64, 2),         # T 1 (no partial, no reduction), B 1
    (5, 100, 1040, 72, 1),      # ragged B; P off 64; 65 blocks of 16
    (3, 128, 2048, 1024, 1),    # P 1024: 16 units a block to fit
    (2, 64, 4096, 256, 2),      # 128 blocks of 32
])
def test_lstm_sm90_bwd_matches_plain(cuda, T, B, H, P, groups):
    """bf16 B3 on the persistent backward against its plain version on the
    same residuals, within 2e-2 of the plain peak; one launch a call."""
    xw, w_h, w_proj, gout = _lstm_inputs(cuda, torch.bfloat16, T, B, H, P)
    _, gates, cseq = lstm.lstm_recurrence_plain(xw, w_h, w_proj,
                                                residuals=True)
    route = lstm.device_bwd_route(gout, w_proj)
    assert (route.source, route.groups) == ("lstm_sm90", groups)
    before = lstm.launches_bwd
    dxw, dhtot = lstm.lstm_bwd_recurrence(gout, gates, cseq, w_h, w_proj)
    ref_dxw, ref_dhtot = lstm.lstm_bwd_recurrence_plain(gout, gates, cseq,
                                                        w_h, w_proj)
    torch.cuda.synchronize()
    assert lstm.launches_bwd == before + 1
    assert dxw.dtype == torch.bfloat16 and dhtot.dtype == torch.float32
    _lstm_close(dxw, ref_dxw, torch.bfloat16, "B3 d_xw")
    _lstm_close(dhtot, ref_dhtot, torch.bfloat16, "B3 dh_total")


def test_lstm_sm90_bwd_kernel_uses_tma_and_wgmma(cuda):
    """The built library's SASS: the persistent backward (16 and 32 units a
    block) issues HGMMA (wgmma) and UTMALDG (TMA loads)."""
    _cuda.library("lstm_sm90")
    sass = subprocess.run(
        [_cuobjdump(), "-sass", str(_cuda.library_path("lstm_sm90"))],
        capture_output=True, text=True, check=True).stdout
    bodies = [part for part in sass.split("Function : ")[1:]
              if "lstm_bwd_kernel_sm90" in part.split("\n", 1)[0]]
    assert len(bodies) == 2, sass[:2000]    # G 1, 2
    for body in bodies:
        assert "HGMMA" in body and "UTMALDG" in body


def test_lstm_bf16_lm1b_shape_takes_the_sm90_bwd_route(cuda):
    """At the LM1B step's shape bf16 B3 launches the persistent backward,
    once a call, and fp32 the first kernels (cell and dh, a step each);
    each call counts one launch either way."""
    T, B, H, P = 20, 128, 2048, 512
    for dtype, sm90 in ((torch.bfloat16, True), (torch.float32, False)):
        xw, w_h, w_proj, gout = _lstm_inputs(cuda, dtype, T, B, H, P)
        _, gates, cseq = lstm.lstm_recurrence_plain(xw, w_h, w_proj,
                                                    residuals=True)
        assert (lstm.device_bwd_route(gout, w_proj).source == "lstm_sm90") \
            == sm90
        before = lstm.launches_bwd
        names = _kernel_names(lambda: lstm.lstm_bwd_recurrence(
            gout, gates, cseq, w_h, w_proj))
        assert lstm.launches_bwd == before + 1
        persistent = [n for n in names if "lstm_bwd_kernel_sm90" in n]
        first = [n for n in names
                 if "lstm_bwd_cell_kernel" in n or "lstm_bwd_dh_" in n]
        assert (len(persistent), bool(first)) == \
            ((1, False) if sm90 else (0, True)), names


def test_lstm_sm90_bwd_is_bitwise_repeatable(cuda):
    """10 back-to-back bf16 B3 calls at the LM1B shape give the same bits
    in d_xw and dh_total, and so do calls on a second stream (one owner
    sums each element's partials in block order; no atomics)."""
    xw, w_h, w_proj, gout = _lstm_inputs(cuda, torch.bfloat16, 20, 128,
                                         2048, 512)
    _, gates, cseq = lstm.lstm_recurrence_plain(xw, w_h, w_proj,
                                                residuals=True)

    def call():
        return lstm.lstm_bwd_recurrence(gout, gates, cseq, w_h, w_proj)
    first = call()
    runs = [call() for _ in range(9)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs += [call() for _ in range(2)]
    torch.cuda.synchronize()
    for run in runs:
        for got, want in zip(run, first):
            assert torch.equal(got, want)


def test_lstm_sm90_bwd_refuses_a_misaligned_view(cuda):
    """The persistent backward loads g with 8-byte and the weights with
    16-byte vectors: a contiguous view that starts one element in raises
    before anything launches."""
    xw, w_h, w_proj, gout = _lstm_inputs(cuda, torch.bfloat16, 2, 64, 256,
                                         64)
    _, gates, cseq = lstm.lstm_recurrence_plain(xw, w_h, w_proj,
                                                residuals=True)
    flat = torch.zeros(gout.numel() + 1, device=cuda)
    bad = flat[1:].view(gout.shape)
    bad.copy_(gout)
    before = lstm.launches_bwd
    with pytest.raises(ValueError, match="16-byte"):
        lstm.lstm_bwd_recurrence(bad, gates, cseq, w_h, w_proj)
    assert lstm.launches_bwd == before
