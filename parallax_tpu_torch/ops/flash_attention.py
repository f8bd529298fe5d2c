"""Flash attention, forward and backward: CUDA kernels, their plain
versions and the gradient that joins them.

Replaces ``parallax_tpu/ops/pallas_attention.py``: the forward TPU
kernel ``_flash_fwd_kernel`` and the two backward ones,
``_flash_dq_kernel`` and ``_flash_dkv_kernel``. bf16 forward, dq and
dk/dv run in ``csrc/flash_attention_sm90.cu`` (TMA-fed tiles, wgmma
products, a producer warp); fp32 forward, dq and dk/dv in
``csrc/flash_attention_f32_sm90.cu`` (mma.sync tensor-core products of
split operands, x = tf32 hi + tf32 lo, three TF32 products each, which
keeps the fp32 contract one TF32 product would break; the first fp32
kernels of ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``
stay built, off the route, as the earlier time chip_smoke.py reports
beside the new). The forward streams 64-row
K/V tiles past a resident q tile with the online softmax in registers;
the backward recomputes p from the forward's lse, dq in one kernel (a
block per q tile, streaming K/V) and dk/dv in another (a block per k
tile, streaming q/dO), so no [Tq, Tk] matrix reaches device memory.
Each source says what bounds it on the H100.

The public layout is the JAX package's: q, k, v ``[B, T, H, hd]`` in
and out, lse ``[B, H, Tq]`` fp32, ``kv_mask [B, Tk]`` marking
attendable keys; ``causal`` is the top-left aligned tril. Every version
rounds where the TPU kernels round: q is scaled in the input dtype
before each dot, dO, k and v are widened to fp32, products accumulate in
fp32 with fp32 p, masked scores are -1e30 and p is zeroed where the
score is at or below -1e30 / 2 (a fully masked row gives out = 0, lse =
m + log(1e-30), and zero gradients), dq is scaled once at the end and dk
is not (q was pre-scaled). Exceptions, bf16 only: the sm90 kernels
round p (forward, dk/dv) and ds (dq, dk/dv) to bf16 before the second
product (P.V, dS.K, Pᵀ.dO, dSᵀ.q̂), which the TPU kernels and the plain
versions here take in fp32; and dk/dv folds ``scale`` into its fp32
products (scores scale·(K.qᵀ), dK scale·(dSᵀ.q)) instead of rounding q̂,
which gives the same bits at hd 64 (scale 2⁻³) and skips q̂'s rounding at
hd 128. The kernels are held to the plain versions within 2e-2 of the
plain output's peak, as every bf16 kernel is.

The gradient (``_FlashAttention``, the counterpart of the JAX
``custom_vjp`` pair) saves q, k, v, kv_mask, out and lse, and computes
δ = rowsum(dO · out), less the lse cotangent when there is one, with
torch ops as the JAX package does outside Pallas. ``xla_backward=True``
differentiates the plain attention instead (``_xla_attention_lse``): an
explicit choice, never a fallback.

Executor: a CUDA tensor launches the kernels (or raises: wrong dtype, an
unsupported head dim, a failed build); a CPU tensor takes the plain
versions, which are also what ``chip_smoke.py`` holds the kernels
against on the card. Every kernel loads 16-byte rows (TMA in bf16,
cp.async in fp32), which needs each base pointer on 16 bytes: the
wrappers pass a contiguous copy of a q, k, v or dO view that is not
(``_cuda.aligned``), so such a view gives the bits an aligned tensor
gives.
Launches are counted in ``launches`` (forward), ``launches_dq`` and
``launches_dkv``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from parallax_tpu_torch.compile import graphs as graphs_lib
from parallax_tpu_torch.ops import _cuda

_NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# pt_flash_fwd_tf32x3 (fp32), pt_flash_fwd_sm90 (bf16): (q, k, v, kv_mask,
# out, lse, B, H, Tq, Tk, hd, scale, causal, stream)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# pt_flash_dq_tf32x3 (fp32), pt_flash_dq_sm90 (bf16): (q, k, v, kv_mask, dout,
# lse, delta, dq, B, H, Tq, Tk, hd, scale, causal, stream)
_DQ_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# pt_flash_dkv_tf32x3 (fp32), pt_flash_dkv_sm90 (bf16): (q, k, v, kv_mask,
# dout, lse, delta, dk, dv, B, H, Tq, Tk, hd, scale, causal, stream)
_DKV_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# (source, launcher) of the forward, dq and dk/dv kernels by input dtype
_FWD = {torch.float32: ("flash_attention_f32_sm90", "pt_flash_fwd_tf32x3"),
        torch.bfloat16: ("flash_attention_sm90", "pt_flash_fwd_sm90")}
_DQ = {torch.float32: ("flash_attention_f32_sm90", "pt_flash_dq_tf32x3"),
       torch.bfloat16: ("flash_attention_sm90", "pt_flash_dq_sm90")}
_DKV = {torch.float32: ("flash_attention_f32_sm90", "pt_flash_dkv_tf32x3"),
        torch.bfloat16: ("flash_attention_sm90", "pt_flash_dkv_sm90")}

# kernel launches since the last reset (``launches = 0`` etc.)
launches = 0        # forward
launches_dq = 0     # dq
launches_dkv = 0    # dk / dv


# -- plain versions -------------------------------------------------------------


def _masked_scores(qs, k, causal, kv_mask):
    """fp32 scores of the pre-scaled q against k, -1e30 where masked."""
    Tq, Tk = qs.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, _NEG_INF)
    if causal:
        tri = torch.ones((Tq, Tk), dtype=torch.bool,
                         device=qs.device).tril()
        s = torch.where(tri, s, _NEG_INF)
    return s


def flash_attention_plain(q, k, v, causal: bool = False,
                          scale: Optional[float] = None,
                          kv_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch ops: (out, lse)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q * scale).to(q.dtype)     # scaled in the input dtype
    s = _masked_scores(qs, k, causal, kv_mask)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(s > _NEG_INF / 2, p, 0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)                  # [B, H, Tq]
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(l)


def _backward_terms(q, k, v, kv_mask, dout, lse, delta, causal, scale):
    """(pre-scaled q, p, ds) as the backward kernels recompute them."""
    qs = (q * scale).to(q.dtype)
    s = _masked_scores(qs, k, causal, kv_mask)
    p = torch.exp(s - lse[..., None])
    p = torch.where(s > _NEG_INF / 2, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return qs, p, p * (dp - delta[..., None])


def flash_dq_plain(q, k, v, kv_mask, dout, lse, delta, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """The dq kernel's function in plain PyTorch ops: dq in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _, _, ds = _backward_terms(q, k, v, kv_mask, dout, lse, delta, causal,
                               scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return (dq * scale).to(q.dtype)


def flash_dkv_plain(q, k, v, kv_mask, dout, lse, delta, causal: bool = False,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function in plain PyTorch ops: (dk, dv) in k's
    and v's dtypes; dk is unscaled, q having been pre-scaled."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qs, p, ds = _backward_terms(q, k, v, kv_mask, dout, lse, delta, causal,
                                scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _xla_attention_lse(q, k, v, causal, scale, kv_mask):
    """The JAX package's ``_xla_attention_lse``: plain attention whose
    autograd gradient is the ``xla_backward=True`` backward."""
    s = _masked_scores((q * scale).to(q.dtype), k, causal, kv_mask)
    lse = torch.logsumexp(s, dim=-1)
    # clamp so fully masked rows yield 0, not exp(nan)
    p = torch.exp(s - lse.clamp_min(_NEG_INF)[..., None])
    p = torch.where(s > _NEG_INF / 2, p, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


# -- the kernels ----------------------------------------------------------------


def _check_kernel_inputs(q, k, v, kv_mask) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, q "
                             f"on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {x.dtype}, q "
                             f"is {q.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be "
                             f"contiguous [B, T, H, hd]")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash_attention kernel takes {KERNEL_DTYPES}, "
                         f"got {q.dtype}")
    B, Tq, H, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, hd):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if kv_mask is not None:
        if kv_mask.device != q.device or kv_mask.dtype != torch.int32 \
                or tuple(kv_mask.shape) != (B, k.shape[1]) \
                or not kv_mask.is_contiguous():
            raise ValueError(
                f"flash_attention: kv_mask must be a contiguous int32 "
                f"[B, Tk]=({B}, {k.shape[1]}) tensor on {q.device}, got "
                f"{kv_mask.dtype} {tuple(kv_mask.shape)} on "
                f"{kv_mask.device}")


def _check_backward_inputs(q, k, v, kv_mask, dout, lse, delta) -> None:
    _check_kernel_inputs(q, k, v, kv_mask)
    if dout.device != q.device or dout.dtype != q.dtype \
            or dout.shape != q.shape or not dout.is_contiguous():
        raise ValueError(
            f"flash_attention backward: dO must be a contiguous "
            f"{q.dtype} {tuple(q.shape)} tensor on {q.device}, got "
            f"{dout.dtype} {tuple(dout.shape)} on {dout.device}")
    B, Tq, H, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x.device != q.device or x.dtype != torch.float32 \
                or tuple(x.shape) != (B, H, Tq) or not x.is_contiguous():
            raise ValueError(
                f"flash_attention backward: {name} must be a contiguous "
                f"float32 [B, H, Tq]=({B}, {H}, {Tq}) tensor on "
                f"{q.device}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")


def _row_loads(*tensors):
    """The tensors (q, k, ...) a kernel is handed: every kernel loads
    16-byte rows (TMA in bf16, cp.async in fp32), so each one on 16 bytes
    (``_cuda.aligned`` copies a view that is not); the bf16 (TMA) kernels
    also need at least one key."""
    if tensors[0].dtype == torch.bfloat16 and tensors[1].shape[1] == 0:
        raise ValueError("flash_attention: the bf16 kernels need Tk >= 1")
    return tuple(_cuda.aligned(x) for x in tensors)


def _mask_ptr(kv_mask):
    return None if kv_mask is None else kv_mask.data_ptr()


def _kernel(q, k, v, causal, scale, kv_mask):
    _check_kernel_inputs(q, k, v, kv_mask)
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if B * Tq * H == 0:
        return out, lse
    source, symbol = _FWD[q.dtype]
    q, k, v = _row_loads(q, k, v)
    fn = _cuda.function(source, symbol, _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(kv_mask),
              out.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, hd,
              float(scale), int(bool(causal)),
              torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(source, code, "flash_attention")
    graphs_lib.count_launch(__name__, "launches")
    return out, lse


def _dq_kernel(q, k, v, kv_mask, dout, lse, delta, causal, scale):
    _check_backward_inputs(q, k, v, kv_mask, dout, lse, delta)
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    dq = torch.empty_like(q)
    if B * Tq * H == 0:
        return dq
    source, symbol = _DQ[q.dtype]
    q, k, v, dout = _row_loads(q, k, v, dout)
    fn = _cuda.function(source, symbol, _DQ_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(kv_mask),
              dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              dq.data_ptr(), B, H, Tq, Tk, hd, float(scale),
              int(bool(causal)),
              torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(source, code, "flash_attention dq")
    graphs_lib.count_launch(__name__, "launches_dq")
    return dq


def _dkv_kernel(q, k, v, kv_mask, dout, lse, delta, causal, scale):
    _check_backward_inputs(q, k, v, kv_mask, dout, lse, delta)
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if B * Tk * H == 0:
        return dk, dv
    source, symbol = _DKV[q.dtype]
    q, k, v, dout = _row_loads(q, k, v, dout)
    fn = _cuda.function(source, symbol, _DKV_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(kv_mask),
              dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              dk.data_ptr(), dv.data_ptr(), B, H, Tq, Tk, hd, float(scale),
              int(bool(causal)),
              torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(source, code, "flash_attention dk/dv")
    graphs_lib.count_launch(__name__, "launches_dkv")
    return dk, dv


def flash_forward(q, k, v, causal: bool, scale: float, kv_mask):
    """(out, lse): the forward kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.is_cuda:
        return _kernel(q, k, v, causal, scale, kv_mask)
    with _cuda.stand_in():
        return flash_attention_plain(q, k, v, causal, scale, kv_mask)


def flash_dq(q, k, v, kv_mask, dout, lse, delta, causal: bool = False,
             scale: Optional[float] = None) -> torch.Tensor:
    """B5's function: the dq kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _dq_kernel(q, k, v, kv_mask, dout, lse, delta, causal, scale)
    with _cuda.stand_in():
        return flash_dq_plain(q, k, v, kv_mask, dout, lse, delta, causal,
                              scale)


def flash_dkv(q, k, v, kv_mask, dout, lse, delta, causal: bool = False,
              scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6's function: the dk/dv kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _dkv_kernel(q, k, v, kv_mask, dout, lse, delta, causal, scale)
    with _cuda.stand_in():
        return flash_dkv_plain(q, k, v, kv_mask, dout, lse, delta, causal,
                               scale)


def flash_delta(out, dout, dlse=None) -> torch.Tensor:
    """δ [B, H, Tq] fp32: rowsum(dO · out), less the lse cotangent (an
    lse cotangent folds into the backward exactly as a shift of δ)."""
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


# -- the gradient ---------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """The forward kernel in ``forward``; the dq and dk/dv kernels (or,
    with ``xla_backward``, the plain attention's own gradient) in
    ``backward``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, xla_backward):
        out, lse = flash_forward(q, k, v, causal, scale, kv_mask)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.xla_backward = xla_backward
        # an output the caller dropped sends None: no lse shift of δ
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        if dout is None:
            dout = torch.zeros_like(out)
        if ctx.xla_backward:
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                o, l = _xla_attention_lse(*qkv, causal, scale, kv_mask)
                outs, cts = [o], [dout]
                if dlse is not None:
                    outs.append(l)
                    cts.append(dlse)
                dq, dk, dv = torch.autograd.grad(outs, qkv, cts)
        else:
            dout = dout.to(q.dtype).contiguous()
            delta = flash_delta(out, dout, dlse)
            dq = flash_dq(q, k, v, kv_mask, dout, lse, delta, causal, scale)
            dk, dv = flash_dkv(q, k, v, kv_mask, dout, lse, delta, causal,
                               scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, causal: bool = False,
                        scale: Optional[float] = None,
                        kv_mask: Optional[torch.Tensor] = None,
                        xla_backward: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention returning (out [B, T, H, hd], lse [B, H, T]),
    differentiable in q, k and v, through lse too."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kv_mask, bool(causal),
                                     float(scale), bool(xla_backward))
    return flash_forward(q, k, v, causal, scale, kv_mask)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None,
                    xla_backward: bool = False) -> torch.Tensor:
    """Fused attention: q, k, v [B, T, H, hd] -> [B, T, H, hd].

    ``kv_mask`` [B, Tk] marks attendable key positions (the NMT source
    padding mask); None means all keys attend. ``xla_backward=True``
    differentiates the plain attention instead of running the backward
    kernels."""
    return flash_attention_lse(q, k, v, causal, scale, kv_mask,
                               xla_backward)[0]


__all__ = ["flash_attention", "flash_attention_lse",
           "flash_attention_plain", "flash_dq", "flash_dkv",
           "flash_dq_plain", "flash_dkv_plain", "flash_delta"]
