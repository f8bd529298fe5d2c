"""Flash-attention forward: a CUDA kernel and its plain version.

Replaces the forward of ``parallax_tpu/ops/pallas_attention.py`` (the
TPU kernel ``_flash_fwd_kernel``). The kernel is
``parallax_tpu_torch/csrc/flash_attention.cu``: one block per (64-row q
tile, head, batch) streams 64-row K/V tiles through shared memory with
the online softmax in registers, so the [Tq, Tk] score matrix never
reaches device memory. Its source says what bounds it on the H100.

The public layout is the JAX package's: q, k, v ``[B, T, H, hd]`` in
and out, lse ``[B, H, Tq]`` fp32, ``kv_mask [B, Tk]`` marking
attendable keys. Both versions round where the TPU kernel rounds: q is
scaled in the input dtype before the dot, QK^T and PV accumulate in
fp32 with fp32 p, masked scores are -1e30 and zeroed after the exp,
and a fully masked row gives out = 0 and lse = m + log(1e-30).

Executor: a CUDA tensor launches the kernel (or raises: wrong dtype,
an unsupported head dim, a failed build); a CPU tensor takes the plain
version, which is also what ``chip_smoke.py`` holds the kernel against
on the card. Only the forward is ported; there is no gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from parallax_tpu_torch.ops import _cuda

_NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# pt_flash_fwd(q, k, v, kv_mask, out, lse, B, H, Tq, Tk, hd, scale,
#              causal, is_bf16, stream)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

# kernel launches since the last reset (``launches = 0``)
launches = 0


def flash_attention_plain(q, k, v, causal: bool = False,
                          scale: Optional[float] = None,
                          kv_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch ops: (out, lse)."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qs = (q * scale).to(q.dtype)     # scaled in the input dtype
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, _NEG_INF)
    if causal:
        tri = torch.ones((Tq, Tk), dtype=torch.bool,
                         device=q.device).tril()
        s = torch.where(tri, s, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(s > _NEG_INF / 2, p, 0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)                  # [B, H, Tq]
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(l)


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


def _kernel(q, k, v, causal, scale, kv_mask):
    global launches
    _check_kernel_inputs(q, k, v, kv_mask)
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if B * Tq * H == 0:
        return out, lse
    fn = _cuda.function("flash_attention", "pt_flash_fwd", _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if kv_mask is None else kv_mask.data_ptr(),
              out.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, hd,
              float(scale), int(bool(causal)),
              int(q.dtype == torch.bfloat16),
              torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check("flash_attention", code, "flash_attention")
    launches += 1
    return out, lse


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, causal: bool = False,
                        scale: Optional[float] = None,
                        kv_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention returning (out [B, T, H, hd], lse [B, H, T])."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.int32).contiguous()
    if q.is_cuda:
        return _kernel(q, k, v, causal, scale, kv_mask)
    return flash_attention_plain(q, k, v, causal, scale, kv_mask)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention: q, k, v [B, T, H, hd] -> [B, T, H, hd].

    ``kv_mask`` [B, Tk] marks attendable key positions (the NMT source
    padding mask); None means all keys attend."""
    return flash_attention_lse(q, k, v, causal, scale, kv_mask)[0]


__all__ = ["flash_attention", "flash_attention_lse",
           "flash_attention_plain"]
