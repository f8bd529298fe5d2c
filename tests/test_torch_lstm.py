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
    assert tl.pass_flops(20, 128, 2048, 512) == \
        2 * 20 * 128 * (512 * 4 * 2048 + 2048 * 512)
