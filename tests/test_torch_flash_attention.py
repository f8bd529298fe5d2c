"""The port's flash-attention forward against the JAX package's.

The same numpy inputs go through ``parallax_tpu.ops.pallas_attention``
(the Pallas kernel in interpret mode) and through
``parallax_tpu_torch.ops.flash_attention`` on CPU tensors (its plain
version, the function the CUDA kernel is held to on the card). fp32,
atol 2e-5: the two sum the same products in another order.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.ops import pallas_attention as jfa
from parallax_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-5

# (B, Tq, Tk, H, hd, causal, masked)
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
    mask = None
    if masked:
        mask = (rng.random((B, Tk)) < 0.7).astype(np.int32)
        mask[0, : Tk // 2] = 1          # batch 0: some keys visible
        mask[-1] = 0                    # last batch: every row fully masked
        if B == 1:
            mask[0, :3] = 1
    return q, k, v, mask


def _torch(x):
    return None if x is None else torch.from_numpy(x)


def _jax(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("B,Tq,Tk,H,hd,causal,masked", CASES)
def test_out_and_lse_match_jax(B, Tq, Tk, H, hd, causal, masked):
    q, k, v, mask = _inputs(B, Tq, Tk, H, hd, masked)
    j_out, j_lse = jfa.flash_attention_lse(
        _jax(q), _jax(k), _jax(v), causal=causal, kv_mask=_jax(mask),
        interpret=True)
    t_out, t_lse = tfa.flash_attention_lse(
        _torch(q), _torch(k), _torch(v), causal=causal,
        kv_mask=_torch(mask))
    assert t_out.shape == (B, Tq, H, hd) and t_lse.shape == (B, H, Tq)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               atol=ATOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse),
                               atol=ATOL, rtol=1e-6)
    # flash_attention is the out half of flash_attention_lse
    j_only = jfa.flash_attention(_jax(q), _jax(k), _jax(v), causal=causal,
                                 kv_mask=_jax(mask), interpret=True)
    t_only = tfa.flash_attention(_torch(q), _torch(k), _torch(v),
                                 causal=causal, kv_mask=_torch(mask))
    np.testing.assert_allclose(t_only.numpy(), np.asarray(j_only),
                               atol=ATOL)


def test_fully_masked_rows_are_exact_zeros():
    q, k, v, mask = _inputs(2, 8, 8, 2, 8, masked=True)
    out, lse = tfa.flash_attention_lse(_torch(q), _torch(k), _torch(v),
                                       kv_mask=_torch(mask))
    assert torch.all(out[-1] == 0)
    # lse = m + log(1e-30) with m = -1e30: finite, hugely negative
    assert torch.all(torch.isfinite(lse[-1]))
    assert torch.all(lse[-1] < -1e29)


def test_scale_applies_in_the_input_dtype():
    """bf16: q is rounded after scaling, as the TPU kernel rounds."""
    q, k, v, _ = _inputs(1, 8, 8, 1, 16, masked=False, seed=3)
    qb = torch.from_numpy(q).bfloat16()
    kb, vb = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    scale = 0.3
    out, lse = tfa.flash_attention_lse(qb, kb, vb, scale=scale)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    qs = (qb * scale).float()        # the bf16-rounded scaled q
    ref = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qs, kb.float()),
                        dim=-1)
    ref_lse = torch.logsumexp(
        torch.einsum("bqhd,bkhd->bhqk", qs, kb.float()), dim=-1)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5)
    np.testing.assert_allclose(
        out.float().numpy(),
        torch.einsum("bhqk,bkhd->bqhd", ref, vb.float()).numpy(),
        atol=2e-2)


# -- the bf16 kernel's rounding points, emulated ---------------------------------

# chip_smoke.py's shapes (B, Tq, Tk, H, hd, causal, mask): the NMT
# training encoder, T 512 with and without the causal mask, hd 128, and a
# ragged Tq 100 / Tk 37
SM90_CASES = {
    "train_enc": (64, 64, 64, 8, 64, False, "pad"),
    "t512": (8, 512, 512, 8, 64, False, None),
    "t512_causal": (8, 512, 512, 8, 64, True, None),
    "hd128": (4, 256, 256, 4, 128, True, "pad"),
    "ragged": (2, 100, 37, 8, 64, False, "pad"),
}
GPU_BF16_REL = 2e-2     # the card's bf16 tolerance: 2e-2 x the plain peak


def _bf16_inputs(B, Tq, Tk, H, hd, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (B, T, H, hd)).astype(np.float32)).bfloat16() for T in (Tq, Tk, Tk))
    mask = None
    if mask_kind == "pad":              # each row padded after [16, Tk] keys
        lengths = rng.integers(min(16, Tk), Tk + 1, B)
        mask = torch.from_numpy(
            (np.arange(Tk)[None, :] < lengths[:, None]).astype(np.int32))
    return q, k, v, mask


def _sm90_forward(q, k, v, causal, kv_mask, block_k=64):
    """The bf16 sm90 forward's arithmetic in plain torch: fp32 scores of
    the bf16-scaled q, 64-key tiles through the online softmax, row sums of
    fp32 p, and p rounded to bf16 before P.V."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = tfa._masked_scores((q * scale).to(q.dtype), k, causal, kv_mask)
    B, H, Tq, Tk = s.shape
    m = torch.full((B, H, Tq), -1e30)
    l = torch.zeros((B, H, Tq))
    acc = torch.zeros((B, H, Tq, q.shape[-1]))
    for j in range(0, Tk, block_k):
        st = s[..., j:j + block_k]
        m_new = torch.maximum(m, st.amax(dim=-1))
        alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
        p = torch.where(st > -1e30 / 2, torch.exp(st - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.bfloat16().float(),
            v[:, j:j + block_k].float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("case", list(SM90_CASES))
def test_bf16_p_rounding_stays_within_the_gpu_tolerance(case):
    """The sm90 kernel rounds p to bf16 before P.V where every other
    version keeps it fp32; at chip_smoke.py's shapes that moves the output
    well inside the card's bf16 tolerance of the plain version."""
    B, Tq, Tk, H, hd, causal, mask_kind = SM90_CASES[case]
    q, k, v, mask = _bf16_inputs(B, Tq, Tk, H, hd, mask_kind)
    want, _ = tfa.flash_attention_plain(q, k, v, causal=causal,
                                        kv_mask=mask)
    got = _sm90_forward(q, k, v, causal, mask)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GPU_BF16_REL * want.float().abs().max().item(), err
