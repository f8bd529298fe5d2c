"""Ring attention: attention with the sequence split over the mesh's
'shard' axis (the port of ``parallax_tpu/ops/ring_attention.py``).

Each rank holds its block of the queries, keys and values ``[B, T/n, H,
D]`` and keeps its queries; the K/V blocks rotate around the shard group
(``collectives.ring_shift``, n - 1 rotations) while each rank folds the
block it holds into running softmax accumulators (m, l, o), so no rank
ever holds the whole sequence or a [T, T] score matrix. The last block
is consumed without the rotation after it (``ring_attention.py:350-356``).
The JAX function takes global arrays inside a ``shard_map``; here the
layout is physical, so ``ring_attention`` takes and returns this rank's
blocks, and every rank of the shard group calls it together.

Placements (``placement``):

* ``'contiguous'``: rank i holds rows [i T/n, (i + 1) T/n); under
  ``causal`` a block from a later rank is fully masked and skipped;
* ``'zigzag'``: rank i holds the low half-block i and the mirrored high
  half-block 2n - 1 - i (each T/2n rows; inputs permuted with
  ``zigzag_permutation``), so every rank does the same causal work: a
  foreign block needs one half tile and no mask.

Block cores (``block_impl``): ``'xla'`` is the plain online-softmax
einsum (fp32 scores of the scaled q, -1e30 where masked); ``'pallas'``
runs each tile through ``ops.flash_attention.flash_attention_lse`` (B4
forward, B5/B6 backward under autograd) and merges the tile into the
accumulators through its lse (``ring_attention.py:180-199``), which
differentiates through lse, so the backward kernels get an lse
cotangent; ``'auto'`` is the flash core for CUDA tensors and the plain
core for CPU tensors (JAX: Pallas on the TPU). Each tile is made
contiguous before the flash call, which refuses views.

Without a mesh (or on a shard axis of 1) the ring has one block: the
rank's own, consumed as one causal (or full) tile, with no
communication.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from parallax_tpu_torch.core.mesh import AXIS_REPL, AXIS_SHARD
from parallax_tpu_torch.ops import collectives

_NEG_INF = -1e30


def zigzag_permutation(T: int, n: int) -> np.ndarray:
    """``perm`` such that the zig-zag layout is ``real[..., perm, ...]``:
    rank i's block is the real half-blocks (i, 2n - 1 - i), each of T/2n
    rows."""
    if T % (2 * n):
        raise ValueError(
            f"zigzag placement needs sequence length divisible by "
            f"2*ring={2 * n}; got T={T}")
    h = T // (2 * n)
    idx = []
    for i in range(n):
        idx.extend(range(i * h, (i + 1) * h))
        idx.extend(range((2 * n - 1 - i) * h, (2 * n - i) * h))
    return np.asarray(idx)


def inverse_zigzag_permutation(T: int, n: int) -> np.ndarray:
    perm = zigzag_permutation(T, n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(T)
    return inv


def _online_update(scores, vh, m, l, o):
    """The flash-style update of (m, l, o) with a new fp32 score tile
    [B, H, q, k] (callers pre-mask)."""
    m_new = torch.maximum(m, scores.amax(dim=-1))
    alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
    p = torch.exp(scores - m_new[..., None])
    # fully masked rows have scores == m_new == -1e30, where exp(0)
    # would leak mass
    p = torch.where(scores > _NEG_INF / 2, p, 0.0)
    l = l * alpha + p.sum(dim=-1)
    o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                            vh.float())
    return m_new, l, o


def _flash_merge(q, k, v, causal, scale, m, l, o):
    """One flash tile (q [B, q, H, D] against k, v [B, k, H, D]) merged
    into the row-aligned (m, l, o) through the tile's lse."""
    from parallax_tpu_torch.ops.flash_attention import flash_attention_lse
    out, lse = flash_attention_lse(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   scale=scale)
    ob = out.transpose(1, 2).float()
    m_new = torch.maximum(m, lse)
    alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
    w = torch.exp(lse - m_new)
    l = l * alpha + w
    o = o * alpha[..., None] + ob * w[..., None]
    return m_new, l, o


def _merge_rows(top, bottom):
    """(m, l, o) of the low rows ``top`` and the high rows ``bottom``."""
    return tuple(torch.cat([a, b], dim=2) for a, b in zip(top, bottom))


def _rows(acc, lo, hi):
    return tuple(t[:, :, lo:hi] for t in acc)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh=None, axis: str = AXIS_SHARD,
                   causal: bool = False, scale: Optional[float] = None,
                   batch_axis: Optional[str] = None,
                   placement: str = "contiguous",
                   block_impl: str = "auto") -> torch.Tensor:
    """Attention of this rank's query block against the whole sequence,
    whose K/V blocks are spread over the shard group of ``mesh`` (the
    engine's mesh when None). q, k, v: this rank's ``[B, T/n, H, D]``
    blocks (zig-zag blocks under ``placement='zigzag'``); returns this
    rank's ``[B, T/n, H, D]``. ``axis`` must be 'shard' and
    ``batch_axis`` None or 'repl' (the port's batch rides 'repl' by the
    feed; the argument is kept for the JAX signature)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if placement not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown placement {placement!r}")
    if block_impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown block_impl {block_impl!r}")
    if axis != AXIS_SHARD or batch_axis not in (None, AXIS_REPL):
        raise ValueError(
            f"ring_attention over axis {axis!r} (batch {batch_axis!r}): "
            f"the port's sequence axis is 'shard', its batch axis 'repl'")
    mesh = mesh if mesh is not None else collectives.current_mesh()
    n = 1 if mesh is None else mesh.shard
    idx = collectives.shard_index(mesh)
    group = None if mesh is None else mesh.shard_group
    use_flash = block_impl == "pallas" or (block_impl == "auto"
                                           and q.is_cuda)
    zigzag = placement == "zigzag"
    B, Tq, H, D = q.shape
    if zigzag and Tq % 2:
        raise ValueError(
            f"zigzag placement needs T divisible by 2*n ({2 * n}); this "
            f"rank's block has {Tq} rows")
    h = Tq // 2

    def positions(origin):
        """Real sequence positions of the block from rank ``origin``."""
        if not zigzag:
            return origin * Tq + torch.arange(Tq, device=q.device)
        return torch.cat([
            origin * h + torch.arange(h, device=q.device),
            (2 * n - 1 - origin) * h + torch.arange(h, device=q.device)])

    qh = (q * scale).to(q.dtype).transpose(1, 2)          # [B, H, Tq, D]
    acc = (torch.full((B, H, Tq), _NEG_INF, device=q.device),
           torch.zeros((B, H, Tq), device=q.device),
           torch.zeros((B, H, Tq, D), device=q.device))

    def scores_of(q_heads, k_blk):
        return torch.einsum("bhqd,bkhd->bhqk", q_heads.float(),
                            k_blk.float())

    def accumulate(k_blk, v_blk, s, acc):
        """The plain core: one whole block, masked by real positions."""
        sc = scores_of(qh, k_blk)
        if causal:
            mask = positions(idx)[:, None] >= \
                positions((idx - s) % n)[None, :]
            sc = torch.where(mask, sc, _NEG_INF)
        return _online_update(sc, v_blk.transpose(1, 2), *acc)

    def rotate(k_blk, v_blk):
        return collectives.ring_shift((k_blk, v_blk), group, idx)

    blocks = (k, v)
    if causal and zigzag and n > 1:
        # the self tile keeps its causal quadrants; a foreign block from
        # an earlier rank meets every local query with its low half only,
        # one from a later rank meets its whole block with the local high
        # half only, and neither half tile needs a mask
        if use_flash:
            lo = _flash_merge(q[:, :h], k[:, :h], v[:, :h], True, scale,
                              *_rows(acc, 0, h))
            hi = _flash_merge(q[:, h:], k[:, :h], v[:, :h], False, scale,
                              *_rows(acc, h, Tq))
            hi = _flash_merge(q[:, h:], k[:, h:], v[:, h:], True, scale,
                              *hi)
            acc = _merge_rows(lo, hi)
        else:
            acc = accumulate(k, v, 0, acc)
        for s in range(1, n):
            blocks = rotate(*blocks)
            k_blk, v_blk = blocks
            if (idx - s) % n < idx:
                if use_flash:
                    acc = _flash_merge(q, k_blk[:, :h], v_blk[:, :h], False,
                                       scale, *acc)
                else:
                    acc = _online_update(scores_of(qh, k_blk[:, :h]),
                                         v_blk[:, :h].transpose(1, 2), *acc)
            else:
                if use_flash:
                    hi = _flash_merge(q[:, h:], k_blk, v_blk, False, scale,
                                      *_rows(acc, h, Tq))
                else:
                    hi = _online_update(scores_of(qh[:, :, h:], k_blk),
                                        v_blk.transpose(1, 2),
                                        *_rows(acc, h, Tq))
                acc = _merge_rows(_rows(acc, 0, h), hi)
    else:
        def consume(k_blk, v_blk, s, acc):
            origin = (idx - s) % n
            if causal and origin > idx:
                return acc              # a later block: fully masked
            if use_flash:
                return _flash_merge(q, k_blk, v_blk,
                                    causal and origin == idx, scale, *acc)
            return accumulate(k_blk, v_blk, s, acc)

        for s in range(n - 1):
            acc = consume(*blocks, s, acc)
            blocks = rotate(*blocks)
        acc = consume(*blocks, n - 1, acc)
    _, l, o = acc
    out = (o / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)
    out = out.to(q.dtype)
    if n > 1:
        out = collectives.anchor(out, *blocks)
    return out


def full_attention_reference(q, k, v, causal: bool = False,
                             scale: Optional[float] = None):
    """Unsharded attention on [B, T, H, D] (tests, one device, the
    serving prefill): q scaled in its dtype, fp32 scores, -1e30 above
    the diagonal under ``causal``, fp32 softmax and PV, the result cast
    back to q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q * scale).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        T = q.shape[1]
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


__all__ = ["ring_attention", "full_attention_reference",
           "zigzag_permutation", "inverse_zigzag_permutation"]
