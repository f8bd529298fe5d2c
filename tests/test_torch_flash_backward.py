"""The port's flash-attention backward against the JAX package's.

The same numpy inputs and cotangents go through ``jax.grad`` of
``parallax_tpu.ops.pallas_attention.flash_attention`` /
``flash_attention_lse`` (the Pallas backward kernels in interpret mode)
and through torch autograd of ``parallax_tpu_torch.ops.flash_attention``
on CPU tensors (the gradient's plain dq and dk/dv versions, the
functions the CUDA kernels are held to on the card). fp32, atol 2e-5 and
rtol 1e-5: the two sum the same products in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.ops import pallas_attention as jfa
from parallax_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-5
RTOL = 1e-5

# (B, Tq, Tk, H, hd, causal, masked): the forward test's cases
CASES = [
    (2, 16, 16, 2, 8, False, True),
    (2, 16, 16, 2, 8, True, False),
    (2, 16, 16, 2, 8, True, True),
    (1, 8, 24, 2, 16, False, True),
    (1, 24, 8, 2, 16, False, False),
    (1, 12, 20, 1, 8, True, True),
]


def _inputs(B, Tq, Tk, H, hd, masked, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, hd)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, hd)).astype(np.float32)
    g = rng.standard_normal((B, Tq, H, hd)).astype(np.float32)
    h = rng.standard_normal((B, H, Tq)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random((B, Tk)) < 0.7).astype(np.int32)
        mask[0, : Tk // 2] = 1          # batch 0: some keys visible
        mask[-1] = 0                    # last batch: every row fully masked
        if B == 1:
            mask[0, :3] = 1
    return q, k, v, g, h, mask


def _jax_grads(q, k, v, g, h, mask, causal, with_lse):
    m = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        if with_lse:
            out, lse = jfa.flash_attention_lse(q, k, v, causal=causal,
                                               kv_mask=m, interpret=True)
            return jnp.sum(out * g) + jnp.sum(lse * h)
        out = jfa.flash_attention(q, k, v, causal=causal, kv_mask=m,
                                  interpret=True)
        return jnp.sum(out * g)
    grads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in grads]


def _torch_grads(q, k, v, g, h, mask, causal, with_lse, **kw):
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    if with_lse:
        out, lse = tfa.flash_attention_lse(*qkv, causal=causal, kv_mask=m,
                                           **kw)
        obj = (out * torch.from_numpy(g)).sum() \
            + (lse * torch.from_numpy(h)).sum()
    else:
        out = tfa.flash_attention(*qkv, causal=causal, kv_mask=m, **kw)
        obj = (out * torch.from_numpy(g)).sum()
    return [x.numpy() for x in torch.autograd.grad(obj, qkv)]


@pytest.mark.parametrize("with_lse", [False, True], ids=["out", "out+lse"])
@pytest.mark.parametrize("B,Tq,Tk,H,hd,causal,masked", CASES)
def test_grads_match_jax(B, Tq, Tk, H, hd, causal, masked, with_lse):
    q, k, v, g, h, mask = _inputs(B, Tq, Tk, H, hd, masked)
    want = _jax_grads(q, k, v, g, h, mask, causal, with_lse)
    got = _torch_grads(q, k, v, g, h, mask, causal, with_lse)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")
    if masked and B > 1:
        # the last batch's rows see no key: exact zeros, as on the TPU
        for a in got:
            assert np.all(a[-1] == 0)


@pytest.mark.parametrize("with_lse", [False, True], ids=["out", "out+lse"])
@pytest.mark.parametrize("B,Tq,Tk,H,hd,causal,masked", CASES)
def test_xla_backward_agrees_with_the_kernel_backward(B, Tq, Tk, H, hd,
                                                      causal, masked,
                                                      with_lse):
    q, k, v, g, h, mask = _inputs(B, Tq, Tk, H, hd, masked, seed=1)
    flash = _torch_grads(q, k, v, g, h, mask, causal, with_lse)
    plain = _torch_grads(q, k, v, g, h, mask, causal, with_lse,
                         xla_backward=True)
    for name, a, b in zip("qkv", flash, plain):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


def test_backward_runs_the_dq_and_dkv_functions_not_autograd_of_plain(
        monkeypatch):
    """On CPU tensors the gradient calls the plain dq and dk/dv versions
    once per attention, with δ from the saved out, and never
    differentiates the plain forward."""
    q, k, v, g, _, mask = _inputs(2, 16, 16, 2, 8, masked=True)
    calls = []
    real_dq, real_dkv = tfa.flash_dq_plain, tfa.flash_dkv_plain
    monkeypatch.setattr(tfa, "flash_dq_plain",
                        lambda *a, **kw: calls.append("dq") or
                        real_dq(*a, **kw))
    monkeypatch.setattr(tfa, "flash_dkv_plain",
                        lambda *a, **kw: calls.append("dkv") or
                        real_dkv(*a, **kw))
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*qkv, kv_mask=torch.from_numpy(mask))
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__.startswith("_FlashAttention")
    (out * torch.from_numpy(g)).sum().backward()
    assert calls == ["dq", "dkv"]


def test_no_grad_call_saves_nothing_and_matches_the_forward():
    q, k, v, _, _, mask = _inputs(1, 8, 24, 2, 16, masked=True)
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        out, lse = tfa.flash_attention_lse(*qkv,
                                           kv_mask=torch.from_numpy(mask))
    assert out.grad_fn is None
    ref, ref_lse = tfa.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        kv_mask=torch.from_numpy(mask))
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def test_bf16_backward_rounds_where_the_kernels_round():
    """dq is scaled once and rounded once; dk is rounded unscaled."""
    q, k, v, g, _, _ = _inputs(1, 8, 8, 1, 16, masked=False, seed=3)
    qb, kb, vb, gb = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    scale = 0.3
    out, lse = tfa.flash_attention_plain(qb, kb, vb, scale=scale)
    delta = tfa.flash_delta(out, gb)
    dq = tfa.flash_dq(qb, kb, vb, None, gb, lse, delta, scale=scale)
    dk, dv = tfa.flash_dkv(qb, kb, vb, None, gb, lse, delta, scale=scale)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    qs = (qb * scale).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kb.float())
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gb.float(), vb.float())
              - delta[..., None])
    want_dq = (torch.einsum("bhqk,bkhd->bqhd", ds, kb.float())
               * scale).bfloat16()
    want_dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs).bfloat16()
    assert torch.equal(dq, want_dq)
    assert torch.equal(dk, want_dk)


def test_kernel_entry_refuses_what_it_does_not_take():
    """The checks run before anything is built or launched."""
    q = torch.zeros((1, 8, 2, 64), dtype=torch.float16)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="takes"):
        tfa._dq_kernel(q, q, q, None, q, lse, lse, False, 0.125)
    q = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="head dims"):
        tfa._dkv_kernel(q, q, q, None, q, lse, lse, False, 0.125)
    q = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="lse"):
        tfa._dq_kernel(q, q, q, None, q, lse.double(), lse, False, 0.125)
    with pytest.raises(ValueError, match="dO"):
        tfa._dkv_kernel(q, q, q, None, q.bfloat16(), lse, lse, False, 0.125)
