"""The split-operand (3xTF32) arithmetic of the fp32 flash kernels
(``csrc/flash_attention_f32_sm90.cu``), emulated on the CPU.

The kernels feed the tensor cores TF32 operands: each fp32 value x is
split as hi = tf32(x), lo = tf32(x - hi), rounded as ``cvt.rna.tf32.f32``
does (nearest, ties away from zero), and every product a.b is summed as
a_lo.b_hi + a_hi.b_lo + a_hi.b_hi. Here those three products are formed
exactly (float64) and rounded once to fp32, at the places the kernels
form them: the forward's Q.Kᵀ and P.V, and dk/dv's K.q̂ᵀ, V.dOᵀ, Pᵀ.dO and
dSᵀ.q̂, with the softmax, the masking and ds in fp32 as the plain versions
take them. On seeded numpy inputs the split attention and its dk/dv stay
within the card tests' 2e-5 (2e-5 of max(1, peak) for the gradients) of
``flash_attention_plain`` and ``flash_dkv_plain``, and the forward within
it of the JAX package's flash attention (its Pallas kernel in interpret
mode); one TF32 product (operands rounded once) does not. What the
tensor cores add beyond this, their truncating accumulation, is measured
on the card (``tests/test_torch_kernels_gpu.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.ops import pallas_attention as jfa
from parallax_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-5
NEG_INF = -1e30

# (B, Tq, Tk, H, hd, causal, masked): batch 0 of a masked case sees no key
CASES = {
    "t64": (2, 64, 64, 2, 64, False, False),
    "t64_causal_masked": (2, 64, 80, 2, 64, True, True),
    "hd128_ragged": (2, 37, 100, 2, 128, False, True),
    "t512_causal": (1, 512, 512, 2, 64, True, False),
}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: half an ulp of
    TF32 added to the magnitude's bits, the 13 dropped bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product3(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the kernels form it: the three split
    products, exact, rounded once to fp32."""
    (ah, al), (bh, bl) = split(a), split(b)
    d = torch.float64
    return (torch.einsum(eq, al.to(d), bh.to(d))
            + torch.einsum(eq, ah.to(d), bl.to(d))
            + torch.einsum(eq, ah.to(d), bh.to(d))).float()


def product1(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product: each operand rounded once."""
    d = torch.float64
    return torch.einsum(eq, tf32(a).to(d), tf32(b).to(d)).float()


def _masked(s, causal, kv_mask):
    Tq, Tk = s.shape[-2:]
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, NEG_INF)
    if causal:
        s = torch.where(torch.ones((Tq, Tk), dtype=torch.bool).tril(), s,
                        NEG_INF)
    return s


def attention(q, k, v, causal, kv_mask, product):
    """(out, lse) of the forward kernel's arithmetic with ``product``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _masked(product("bqhd,bkhd->bhqk", q * scale, k), causal, kv_mask)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(s > NEG_INF / 2, p, 0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)
    out = product("bhqk,bkhd->bqhd", p, v) / l.transpose(1, 2)[..., None]
    return out, m + torch.log(l)


def dkv(q, k, v, kv_mask, dout, lse, delta, causal, product):
    """(dk, dv) of the dk/dv kernel's arithmetic with ``product``."""
    qs = q * (1.0 / math.sqrt(q.shape[-1]))
    s = _masked(product("bqhd,bkhd->bhqk", qs, k), causal, kv_mask)
    p = torch.exp(s - lse[..., None])
    p = torch.where(s > NEG_INF / 2, p, 0.0)
    dp = product("bqhd,bkhd->bhqk", dout, v)
    ds = p * (dp - delta[..., None])
    return (product("bhqk,bqhd->bkhd", ds, qs),
            product("bhqk,bqhd->bkhd", p, dout))


def _inputs(B, Tq, Tk, H, hd, masked, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))
    q, k, v, dout = r(B, Tq, H, hd), r(B, Tk, H, hd), r(B, Tk, H, hd), \
        r(B, Tq, H, hd)
    mask = None
    if masked:
        mask = torch.from_numpy((rng.random((B, Tk)) < 0.6).astype(np.int32))
        mask[0] = 0
    return q, k, v, dout, mask


def _forward_err(case, product):
    B, Tq, Tk, H, hd, causal, masked = CASES[case]
    q, k, v, _, mask = _inputs(B, Tq, Tk, H, hd, masked)
    out, lse = attention(q, k, v, causal, mask, product)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal=causal,
                                             kv_mask=mask)
    live = slice(1, None) if masked else slice(None)
    return ((out - ref).abs().max().item(),
            (lse[live] - ref_lse[live]).abs().max().item(), out, lse)


def _dkv_errs(case, product):
    """(err, tolerance) of dk and dv against the plain version, on the
    plain forward's out and lse."""
    B, Tq, Tk, H, hd, causal, masked = CASES[case]
    q, k, v, dout, mask = _inputs(B, Tq, Tk, H, hd, masked)
    out, lse = tfa.flash_attention_plain(q, k, v, causal=causal,
                                         kv_mask=mask)
    delta = tfa.flash_delta(out, dout)
    got = dkv(q, k, v, mask, dout, lse, delta, causal, product)
    want = tfa.flash_dkv_plain(q, k, v, mask, dout, lse, delta, causal)
    return [((g - w).abs().max().item(),
             ATOL * max(1.0, w.abs().max().item()))
            for g, w in zip(got, want)], got, mask


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                      # of TF32 at 1.0
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2 ** -23,
                      -(1.0 + ulp / 2), 1.0 + 1.5 * ulp, 3.0e-39],
                     dtype=torch.float32)
    got = tf32(x).tolist()
    assert got[:5] == [1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp]
    assert (tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()
    hi, lo = split(x[:5])
    # hi + lo is x within 2^-22 of |x| (lo is rounded too)
    assert torch.all((hi.double() + lo.double() - x[:5].double()).abs()
                     <= 2.0 ** -22 * x[:5].double().abs())


@pytest.mark.parametrize("case", list(CASES))
def test_split_forward_within_the_fp32_tolerance(case):
    err, lse_err, out, lse = _forward_err(case, product3)
    assert err <= ATOL and lse_err <= ATOL, (err, lse_err)
    if CASES[case][-1]:
        # batch 0 sees no key: out 0, lse m + log(1e-30)
        assert torch.all(out[0] == 0) and torch.all(lse[0] < -1e29)


@pytest.mark.parametrize("case", list(CASES))
def test_split_dkv_within_the_fp32_tolerance(case):
    errs, (dk, dv), mask = _dkv_errs(case, product3)
    assert all(e <= t for e, t in errs), errs
    if mask is not None:
        assert torch.all(dk[0] == 0) and torch.all(dv[0] == 0)


@pytest.mark.parametrize("case", list(CASES))
def test_one_tf32_product_breaks_the_fp32_tolerance(case):
    """The argument of the kernels' source note: rounding each operand
    once puts the forward and dk and dv outside the fp32 tolerance."""
    err, _, _, _ = _forward_err(case, product1)
    errs, _, _ = _dkv_errs(case, product1)
    assert err > ATOL and all(e > t for e, t in errs), (err, errs)


@pytest.mark.parametrize("case", ["t64_causal_masked", "hd128_ragged"])
def test_split_forward_matches_jax(case):
    """The emulated kernel against the JAX package's flash attention (the
    Pallas forward in interpret mode) on the same numpy inputs."""
    B, Tq, Tk, H, hd, causal, masked = CASES[case]
    q, k, v, _, mask = _inputs(B, Tq, Tk, H, hd, masked)
    out, lse = attention(q, k, v, causal, mask, product3)
    jout, jlse = jfa.flash_attention_lse(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=causal,
        kv_mask=None if mask is None else jnp.asarray(mask.numpy()),
        interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    live = slice(1, None) if masked else slice(None)
    np.testing.assert_allclose(lse[live].numpy(), np.asarray(jlse)[live],
                               atol=ATOL, rtol=0)
