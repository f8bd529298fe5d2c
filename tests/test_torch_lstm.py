"""The port's LSTM scan (ops/lstm.py) against the JAX package's
(ops/pallas_lstm.py).

The same numpy inputs go through both. The JAX side runs its Pallas
kernels in interpret mode (``impl="pallas", interpret=True,
bwd_impl="kernel"``); the port runs on CPU tensors, so its kernel
wrappers take their plain versions. Tolerances: fp32 1e-4 relative and
1e-5 absolute (the time loop and the epilogue products sum in another
order); bf16 2e-2 of the JAX output's peak, as tests/test_pallas_lstm.py
budgets bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.ops import pallas_lstm
from parallax_tpu_torch.ops import lstm as tl

# (T, B, E, H, P): the JAX test's shape, a ragged one (B, H and P off any
# power of two), and T = 1
SHAPES = [(6, 8, 16, 32, 16), (5, 6, 24, 40, 24), (1, 3, 8, 12, 8)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed=0):
    T, B, E, H, P = shape
    rng = np.random.default_rng(seed)

    def t(s, scale):
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return (t((T, B, E), 0.3), t((E + P, 4 * H), 1.0 / np.sqrt(E + P)),
            t((4 * H,), 0.1), t((H, P), 1.0 / np.sqrt(H)),
            t((T, B, P), 1.0))


def _close(got, want, dtype_name, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=what)
    else:
        peak = np.abs(want).max() or 1.0
        assert np.abs(got - want).max() <= 2e-2 * peak, what


def _jax_args(arrs, jdt):
    return [jnp.asarray(a, jdt) for a in arrs]


def _torch_args(arrs, tdt, grad=False):
    return [torch.tensor(a, dtype=tdt, requires_grad=grad) for a in arrs]


def _np(x):
    return x.detach().float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_and_residuals_match_jax(shape, dtype):
    """B1's hs and B2's (hs, gates, c) against the Pallas kernels."""
    jdt, tdt = DTYPES[dtype]
    x, w, b, wp, _ = _inputs(shape)
    jx, jw, jb, jwp = _jax_args((x, w, b, wp), jdt)
    j_hs = pallas_lstm._forward(jx, jw, jb, jwp, 128, True)
    j_res = pallas_lstm._forward(jx, jw, jb, jwp, 128, True,
                                 save_residuals=True)
    tx, tw, tb, twp = _torch_args((x, w, b, wp), tdt)
    w_x, w_h = tl._split_w(tw, twp)
    xw = tl._hoisted_xw(tx, w_x, tb)
    t_hs = tl.lstm_recurrence(xw, w_h, twp)
    t_res = tl.lstm_recurrence(xw, w_h, twp, residuals=True)
    assert t_hs.dtype == tdt and t_res[1].dtype == tdt
    _close(_np(t_hs), j_hs, dtype, "hs (B1)")
    for got, want, what in zip(t_res, j_res, ("hs", "gates", "c")):
        _close(_np(got), want, dtype, f"{what} (B2)")


def _jax_grads(args, g, **kw):
    def f(x, w, b, wp):
        out = pallas_lstm.lstm_scan(x, w, b, wp, **kw)
        return jnp.sum(out.astype(jnp.float32) * g)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(*args)


def _torch_grads(args, g, **kw):
    out = tl.lstm_scan(*args, **kw)
    return torch.autograd.grad((out.float() * g).sum(), args)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_grads_match_jax(shape, dtype):
    """All four grads through B2 + B3 + the epilogue, against the Pallas
    forward and time-reversed backward kernels."""
    jdt, tdt = DTYPES[dtype]
    x, w, b, wp, g = _inputs(shape, seed=1)
    want = _jax_grads(_jax_args((x, w, b, wp), jdt), jnp.asarray(g),
                      impl="pallas", interpret=True, bwd_impl="kernel")
    got = _torch_grads(_torch_args((x, w, b, wp), tdt, grad=True),
                       torch.tensor(g), impl="kernel", bwd_impl="kernel")
    for gt, wt, name in zip(got, want, ("x", "w", "b", "w_proj")):
        assert gt.dtype == tdt
        _close(_np(gt), wt, dtype, name)


@pytest.mark.parametrize("bwd_impl", ["scan", "recompute", "auto"])
def test_every_bwd_impl_matches_jax_fp32(bwd_impl):
    x, w, b, wp, g = _inputs(SHAPES[0], seed=2)
    want = _jax_grads(_jax_args((x, w, b, wp), jnp.float32),
                      jnp.asarray(g), impl="pallas", interpret=True,
                      bwd_impl=bwd_impl)
    got = _torch_grads(_torch_args((x, w, b, wp), torch.float32,
                                   grad=True), torch.tensor(g),
                       impl="kernel", bwd_impl=bwd_impl)
    for gt, wt, name in zip(got, want, ("x", "w", "b", "w_proj")):
        _close(_np(gt), wt, "float32", f"{bwd_impl}:{name}")


def test_scan_impl_matches_jax_reference_and_its_grads():
    """``impl="scan"`` is the plain reference scan under autograd (the
    JAX package's ``impl="xla"``)."""
    x, w, b, wp, g = _inputs(SHAPES[1], seed=3)
    jargs = _jax_args((x, w, b, wp), jnp.float32)
    want_out = pallas_lstm.lstm_scan(*jargs, impl="xla")
    want = _jax_grads(jargs, jnp.asarray(g), impl="xla")
    targs = _torch_args((x, w, b, wp), torch.float32, grad=True)
    out = tl.lstm_scan(*targs, impl="scan")
    _close(_np(out), want_out, "float32", "hs")
    got = torch.autograd.grad((out * torch.tensor(g)).sum(), targs)
    for gt, wt, name in zip(got, want, ("x", "w", "b", "w_proj")):
        _close(_np(gt), wt, "float32", name)


def test_primal_forward_has_no_gradient_path():
    """With no input requiring grad, or grad mode off, the kernel impl
    runs the primal forward (B1) outside the autograd.Function, and it
    equals the forward under differentiation."""
    x, w, b, wp, _ = _inputs(SHAPES[0])
    plain = tl.lstm_scan(*_torch_args((x, w, b, wp), torch.float32),
                         impl="kernel")
    assert plain.grad_fn is None
    targs = _torch_args((x, w, b, wp), torch.float32, grad=True)
    with torch.no_grad():
        off = tl.lstm_scan(*targs, impl="kernel")
    assert off.grad_fn is None
    diff = tl.lstm_scan(*targs, impl="kernel")
    assert diff.grad_fn is not None
    np.testing.assert_array_equal(_np(plain), _np(diff))
    np.testing.assert_array_equal(_np(off), _np(diff))


def test_bwd_impl_is_validated_and_env_overrides(monkeypatch):
    x, w, b, wp, _ = _inputs(SHAPES[2])
    targs = _torch_args((x, w, b, wp), torch.float32, grad=True)
    with pytest.raises(ValueError, match="bwd_impl"):
        tl.lstm_scan(*targs, impl="kernel", bwd_impl="fast")
    with pytest.raises(ValueError, match="impl"):
        tl.lstm_scan(*targs, impl="xla")
    monkeypatch.setenv("PARALLAX_LSTM_BWD", "recompute")
    assert tl.resolve_bwd_impl("kernel", torch.device("cpu")) == "recompute"
    monkeypatch.delenv("PARALLAX_LSTM_BWD")
    assert tl.resolve_bwd_impl("auto", torch.device("cpu")) == "scan"
    assert tl.resolve_bwd_impl("auto", torch.device("cuda")) == "kernel"


def test_kernel_wrappers_keep_cpu_tensors_on_the_plain_version():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    before = (tl.launches_fwd, tl.launches_fwd_res, tl.launches_bwd)
    x, w, b, wp, g = _inputs(SHAPES[2])
    targs = _torch_args((x, w, b, wp), torch.float32, grad=True)
    _torch_grads(targs, torch.tensor(g), impl="kernel", bwd_impl="kernel")
    assert (tl.launches_fwd, tl.launches_fwd_res, tl.launches_bwd) == before


def test_kernel_hbm_bytes_is_the_jax_byte_model():
    flagship = (20, 128, 512, 2048, 512, 2, 2)
    for bwd in ("kernel", "scan", "recompute"):
        assert tl.kernel_hbm_bytes(*flagship, bwd=bwd) == \
            pallas_lstm.kernel_hbm_bytes(*flagship, bwd=bwd)
    # the gates product is skipped at one step of the 20: h_0 = 0
    assert tl.pass_flops(20, 128, 2048, 512) == \
        2 * 128 * (19 * 512 * 4 * 2048 + 20 * 2048 * 512)


# -- the persistent bf16 forward (csrc/lstm_sm90.cu): its route and its
# arithmetic ----------------------------------------------------------------

LM1B = (20, 128, 2048, 512)     # T, B, H, P of the LM1B training step


@pytest.mark.parametrize("dtype,shape,sms,want", [
    # the LM1B step on an H100 SXM: 128 blocks of 16 units
    (torch.bfloat16, LM1B, 132, ("lstm_sm90", 1, 4)),
    # fp32: the persistent 3xTF32 forward, 128 blocks of 16 units
    (torch.float32, LM1B, 132, ("lstm_f32_sm90", 0, 0)),
    # P 33 (66-byte rows: no TMA), H 70 (not 16-unit groups), B 1
    (torch.bfloat16, (3, 1, 70, 33), 132, ("lstm", 0, 0)),
    # 114 SMs (H100 PCIe): 128 blocks of 16 cannot all be resident, 64
    # blocks of 32 units can, with a 3-stage ring to fit 227 KB
    (torch.bfloat16, LM1B, 114, ("lstm_sm90", 2, 3)),
    # more blocks than SMs at every group size: the first kernel
    (torch.bfloat16, LM1B, 60, ("lstm", 0, 0)),
    # B past two 64-row tiles
    (torch.bfloat16, (20, 130, 2048, 512), 132, ("lstm", 0, 0)),
    # H 4096: 16-unit groups would need 256 blocks
    (torch.bfloat16, (2, 64, 4096, 256), 132, ("lstm_sm90", 2, 4)),
    # fp32: H 70 (not 16-unit blocks), P 33 (not 8-column tiles)
    (torch.float32, (3, 1, 70, 32), 132, ("lstm", 0, 0)),
    (torch.float32, (3, 1, 64, 33), 132, ("lstm", 0, 0)),
    # fp32 at lm1b_eval's B 16 and the drift sentinels' pair (T6 B8 H32
    # P16): the persistent forward
    (torch.float32, (20, 16, 2048, 512), 132, ("lstm_f32_sm90", 0, 0)),
    (torch.float32, (6, 8, 32, 16), 132, ("lstm_f32_sm90", 0, 0)),
    # fp32 on 114 SMs (H100 PCIe): 128 blocks cannot all be resident, and
    # the fp32 forward has no 32-unit blocks
    (torch.float32, LM1B, 114, ("lstm", 0, 0)),
    # fp32 B past 128; P whose w_h slice does not fit (576); P 544 fits
    (torch.float32, (20, 130, 2048, 512), 132, ("lstm", 0, 0)),
    (torch.float32, (3, 128, 1040, 576), 132, ("lstm", 0, 0)),
    (torch.float32, (3, 128, 1040, 544), 132, ("lstm_f32_sm90", 0, 0)),
])
def test_fwd_route_is_a_function_of_dtype_shape_and_sms(dtype, shape, sms,
                                                        want):
    T, B, H, P = shape
    route = tl.fwd_route(dtype, T, B, H, P, sms)
    assert tuple(route) == want
    if route.source == "lstm_sm90":
        blocks = H // (16 * route.groups)
        assert blocks <= sms and blocks % (P // 8) == 0
        assert tl.sm90_smem_bytes(route.groups, H, P, route.stages) \
            <= tl.SM90_SMEM
    if route.source == "lstm_f32_sm90":
        assert H // 16 <= sms and tl.f32_smem_bytes(P) <= tl.SM90_SMEM


def _sigmoid_ex2(x):
    return 1.0 / (1.0 + torch.exp2(-x * 1.4426950408889634))


def _tanh_ex2(x):
    return 1.0 - 2.0 / (1.0 + torch.exp2(2.0 * 1.4426950408889634 * x))


def _chunked(a, b, lo, hi):
    """sum over 64-wide chunks k0 in [lo, hi) of a[:, k0:] @ b[k0:], in
    order, each chunk's product in fp32 (a wgmma chunk)."""
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(lo, hi, 64):
        acc = acc + a[:, k0:k0 + 64] @ b[k0:k0 + 64]
    return acc


def _sm90_emulation(xw, w_h, w_proj):
    """The persistent kernel's arithmetic on the CPU: gates summed over
    64-wide chunks of P, sigma and tanh through 2^x and a reciprocal, the
    projection's two halves over H (one per warpgroup) summed in chunks
    and added once, bf16 stores."""
    T, B, _ = xw.shape
    H, P = w_proj.shape
    wh, wp = w_h.float(), w_proj.float()
    half = (-(-H // 64) + 1) // 2 * 64
    c = torch.zeros((B, H))
    hs, gates, cs = [], [], []
    for t in range(T):
        g = xw[t].float()
        if t > 0:
            g = _chunked(hs[-1].float(), wh, 0, P) + g
        i, f, gg, o = g.chunk(4, dim=-1)
        i, f = _sigmoid_ex2(i), _sigmoid_ex2(f + 1.0)
        gg, o = _tanh_ex2(gg), _sigmoid_ex2(o)
        c = f * c + i * gg
        hf = (o * _tanh_ex2(c)).bfloat16().float()
        hs.append((_chunked(hf, wp, 0, half)
                   + _chunked(hf, wp, half, H)).bfloat16())
        gates.append(torch.cat([i, f, gg, o], dim=-1).bfloat16())
        cs.append(c.bfloat16())
    return torch.stack(hs), torch.stack(gates), torch.stack(cs)


def test_sm90_arithmetic_stays_within_the_bf16_budget():
    """The kernel's accumulation split and its sigma/tanh, emulated at the
    LM1B shape over all T = 20 steps, stay within 2e-2 of the plain
    version's peak in hs, the gates and c (the c carry compounds any
    error of the transcendentals)."""
    T, B, H, P = LM1B
    rng = np.random.default_rng(0)

    def t(s, scale):
        return torch.from_numpy(
            (rng.standard_normal(s) * scale).astype(np.float32)).bfloat16()
    xw = t((T, B, 4 * H), 1.0)
    w_h = t((P, 4 * H), 1.0 / np.sqrt(P))
    w_proj = t((H, P), 1.0 / np.sqrt(H))
    got = _sm90_emulation(xw, w_h, w_proj)
    want = tl.lstm_recurrence_plain(xw, w_h, w_proj, residuals=True)
    for g, w, what in zip(got, want, ("hs", "gates", "c")):
        _close(g.float().numpy(), w.float().numpy(), "bfloat16", what)


# -- the persistent fp32 forward (csrc/lstm_f32_sm90.cu): its arithmetic -----

# T20 (LM1B's steps) at narrow widths: the narrowest shape tried at which
# one TF32 product breaks the fp32 budget with room (1.6e-4 to 2.9e-4 over
# three seeds; T6 B8 H32 P16 gives 0.9e-4 to 1.4e-4)
F32_NARROW = (20, 8, 32, 128, 64)


def _tf32(x):
    """fp32 rounded to TF32 as the kernel rounds it (cvt.rna.tf32.f32:
    nearest, ties away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product3(a, b):
    """a @ b as the kernel forms one 64-deep chunk: the three split
    products (lo.hi, hi.lo, hi.hi), exact, rounded once to fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    d = torch.float64
    return (al.to(d) @ bh.to(d) + ah.to(d) @ bl.to(d)
            + ah.to(d) @ bh.to(d)).float()


def _product1(a, b):
    """One TF32 product: each operand rounded once."""
    return (_tf32(a).double() @ _tf32(b).double()).float()


def _chunked_by(a, b, lo, hi, product):
    """sum over 64-deep chunks k0 in [lo, hi) of ``product`` of the chunk,
    in order, in fp32: each chunk summed from zero and added."""
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(lo, hi, 64):
        k1 = min(k0 + 64, hi)
        acc = acc + product(a[:, k0:k1], b[k0:k1])
    return acc


def _f32_emulation(xw, w_h, w_proj, product):
    """The persistent fp32 forward's arithmetic on the CPU: gates = xw +
    the recurrent product in 64-deep chunks of P, the cell in fp32, the
    projection's two halves over H (one per warp group, the first holding
    ceil(H / 128) chunks) each summed in chunks and added once."""
    T, B, _ = xw.shape
    H, P = w_proj.shape
    half = min(H, (-(-H // 64) + 1) // 2 * 64)
    c = torch.zeros((B, H))
    hs, gates, cs = [], [], []
    for t in range(T):
        g = xw[t]
        if t > 0:
            g = _chunked_by(hs[-1], w_h, 0, P, product) + g
        i, f, gg, o = g.chunk(4, dim=-1)
        i, f = torch.sigmoid(i), torch.sigmoid(f + 1.0)
        gg, o = torch.tanh(gg), torch.sigmoid(o)
        c = f * c + i * gg
        hf = o * torch.tanh(c)
        hs.append(_chunked_by(hf, w_proj, 0, half, product)
                  + _chunked_by(hf, w_proj, half, H, product))
        gates.append(torch.cat([i, f, gg, o], dim=-1))
        cs.append(c)
    return torch.stack(hs), torch.stack(gates), torch.stack(cs)


def _f32_xw(shape, seed=0):
    x, w, b, wp, _ = _inputs(shape, seed)
    tx, tw, tb, twp = _torch_args((x, w, b, wp), torch.float32)
    w_x, w_h = tl._split_w(tw, twp)
    return (x, w, b, wp), tl._hoisted_xw(tx, w_x, tb), w_h, twp


def _f32_errs(got, want):
    """max |got - want| of hs, gates and c, each against 1e-4 of max(1,
    the peak): the fp32 LSTM kernels' contract."""
    return [(float(np.abs(np.asarray(g, np.float32)
                          - np.asarray(w, np.float32)).max()),
             1e-4 * max(1.0, float(np.abs(np.asarray(w)).max())))
            for g, w in zip(got, want)]


@pytest.mark.parametrize("shape", SHAPES + [F32_NARROW], ids=str)
def test_f32_split_arithmetic_matches_plain_and_jax(shape):
    """The 3xTF32 recurrence, emulated, within 1e-4 of max(1, peak) of
    lstm_recurrence_plain and of the JAX Pallas forward with residuals
    (interpret mode) in hs, gates and c."""
    arrs, xw, w_h, w_proj = _f32_xw(shape)
    got = _f32_emulation(xw, w_h, w_proj, _product3)
    plain = tl.lstm_recurrence_plain(xw, w_h, w_proj, residuals=True)
    jx, jw, jb, jwp = _jax_args(arrs, jnp.float32)
    jres = pallas_lstm._forward(jx, jw, jb, jwp, 128, True,
                                save_residuals=True)
    for want in ([_np(x) for x in plain], jres):
        errs = _f32_errs([_np(g) for g in got], want)
        assert all(e <= t for e, t in errs), errs


def test_one_tf32_product_breaks_the_fp32_budget():
    """The argument of the kernel's source note: rounding each operand of
    the two products once moves hs, the gates and c past 1e-4 of the plain
    version over T 20, where the split products stay within it."""
    _, xw, w_h, w_proj = _f32_xw(F32_NARROW)
    plain = [_np(x) for x in tl.lstm_recurrence_plain(xw, w_h, w_proj,
                                                       residuals=True)]
    one = _f32_errs([_np(g) for g in _f32_emulation(xw, w_h, w_proj,
                                                    _product1)], plain)
    split = _f32_errs([_np(g) for g in _f32_emulation(xw, w_h, w_proj,
                                                      _product3)], plain)
    assert all(e > t for e, t in one), one
    assert all(e <= t / 100 for e, t in split), split


# -- the persistent bf16 backward (csrc/lstm_sm90.cu): its route and its
# arithmetic ----------------------------------------------------------------


@pytest.mark.parametrize("dtype,shape,sms,want", [
    # the LM1B step on an H100 SXM: 64 blocks of 32 units (fewer partials
    # of dh than 128 blocks of 16), a 2-stage ring
    (torch.bfloat16, LM1B, 132, ("lstm_sm90", 2, 2)),
    # and on a card with fewer SMs than even 64 blocks: the first kernel
    (torch.bfloat16, LM1B, 60, ("lstm", 0, 0)),
    # fp32 keeps the first kernel (a TF32 wgmma breaks the 1e-4 contract)
    (torch.float32, LM1B, 132, ("lstm", 0, 0)),
    # B past two 64-row tiles
    (torch.bfloat16, (20, 130, 2048, 512), 132, ("lstm", 0, 0)),
    # P 33 (66-byte rows: no TMA)
    (torch.bfloat16, (3, 1, 64, 33), 132, ("lstm", 0, 0)),
    # H 1040: 65 blocks of 16 units, not of 32
    (torch.bfloat16, (3, 128, 1040, 520), 132, ("lstm_sm90", 1, 2)),
    # P 1024: 32 units' slices do not fit 227 KB, 16 units' do
    (torch.bfloat16, (3, 128, 2048, 1024), 132, ("lstm_sm90", 1, 2)),
    # H 4096: 128 blocks of 32 units; H 8192 would need 256
    (torch.bfloat16, (2, 64, 4096, 256), 132, ("lstm_sm90", 2, 2)),
    (torch.bfloat16, (2, 64, 8192, 256), 132, ("lstm", 0, 0)),
])
def test_bwd_route_is_a_function_of_dtype_shape_and_sms(dtype, shape, sms,
                                                        want):
    T, B, H, P = shape
    route = tl.bwd_route(dtype, T, B, H, P, sms)
    assert tuple(route) == want
    if route.source == "lstm_sm90":
        assert H // (16 * route.groups) <= sms
        assert tl.sm90_bwd_smem_bytes(route.groups, P, route.stages) \
            <= tl.SM90_SMEM


def _sm90_bwd_emulation(g, gates, cseq, w_h, w_proj, units=32):
    """The persistent backward's arithmetic on the CPU: d_hfull summed over
    64-wide chunks of P from the bf16 dh_tot; tanh(c) through 2^x and a
    reciprocal; dh as one fp32 partial per block of ``units`` hidden units
    (its 4 x units gate columns), the partials summed in block order and
    then added to g; d_xw stored in bf16."""
    T, B, P = g.shape
    H = w_proj.shape[0]
    nb = H // units
    wh, wpt = w_h.float(), w_proj.float().t()
    # block j's gate columns, gate-major: q H + j units + ul
    cols = (torch.arange(4)[:, None] * H
            + torch.arange(units)[None, :]).reshape(-1)
    cols = cols[None, :] + (torch.arange(nb) * units)[:, None]   # [nb, 4U]
    wh_blocks = wh[:, cols]                                      # [P, nb, 4U]
    dc = torch.zeros((B, H))
    dh = torch.zeros((B, P))
    dxw, dhtot = [], []
    for s in reversed(range(T)):
        i, f, ga, o = gates[s].float().chunk(4, dim=-1)
        c_t = cseq[s].float()
        c_prev = cseq[s - 1].float() if s > 0 else torch.zeros_like(c_t)
        dh_tot = g[s] + dh
        dhtot.append(dh_tot)
        d_hfull = _chunked(dh_tot.bfloat16().float(), wpt, 0, P)
        tc = _tanh_ex2(c_t)
        d_o = d_hfull * tc
        dc_tot = dc + d_hfull * o * (1.0 - tc * tc)
        d_i, d_f, d_g = dc_tot * ga, dc_tot * c_prev, dc_tot * i
        dc = dc_tot * f
        d_gates = torch.cat([d_i * i * (1.0 - i), d_f * f * (1.0 - f),
                             d_g * (1.0 - ga * ga), d_o * o * (1.0 - o)],
                            dim=-1).bfloat16()
        dxw.append(d_gates)
        parts = torch.einsum("bjk,pjk->jbp", d_gates.float()[:, cols],
                             wh_blocks)
        dh = torch.zeros((B, P))
        for part in parts:
            dh = dh + part
    return torch.stack(dxw[::-1]), torch.stack(dhtot[::-1])


def test_sm90_bwd_arithmetic_stays_within_the_bf16_budget():
    """The persistent backward's accumulation split (64-wide chunks for
    d_hfull, per-block partials of dh summed in block order) and its tanh,
    emulated at the LM1B shape over all T = 20 steps, stay within 2e-2 of
    the plain version's peak in d_xw and dh_total (the dc and dh carries
    compound any error)."""
    T, B, H, P = LM1B
    rng = np.random.default_rng(1)

    def t(s, scale):
        return torch.from_numpy(
            (rng.standard_normal(s) * scale).astype(np.float32)).bfloat16()
    xw = t((T, B, 4 * H), 1.0)
    w_h = t((P, 4 * H), 1.0 / np.sqrt(P))
    w_proj = t((H, P), 1.0 / np.sqrt(H))
    g = t((T, B, P), 1.0).float()
    _, gates, cseq = tl.lstm_recurrence_plain(xw, w_h, w_proj,
                                              residuals=True)
    got = _sm90_bwd_emulation(g, gates, cseq, w_h, w_proj)
    want = tl.lstm_bwd_recurrence_plain(g, gates, cseq, w_h, w_proj)
    for gt, wt, what in zip(got, want, ("d_xw", "dh_total")):
        assert gt.dtype == wt.dtype
        _close(gt.float().numpy(), wt.float().numpy(), "bfloat16", what)
