"""Paged-KV decode attention: a CUDA kernel and its plain version.

Replaces ``parallax_tpu/ops/pallas_paged_attention.py`` (the TPU kernel
``_paged_attn_kernel``). The kernel is
``parallax_tpu_torch/csrc/paged_attention.cu``
(``paged_decode_kernel_sm90``): flash-decoding over the page table. A
block takes one slot, a group of heads (``split_plan``) and one range of
positions; it loads its range's page ids once, streams the live, visible
K/V rows through a ring of 16-byte ``cp.async`` copies, and keeps the
online softmax per query in fp32. When a slot's positions are split
over several blocks, ``paged_combine_kernel`` merges their partials in
split order. Its source says what bounds it on the H100.

Semantics, shared by the kernel and the plain version:

* ``q [S, G, D]`` (G = queries per slot, 1 for a plain step),
  ``k_pool``/``v_pool [pool, page_size, D]`` (one layer of the serve
  pool), ``pages [S, P]`` int32, ``pos [S, G]`` int32;
  ``D = num_heads * hd``. Returns ``[S, G, D]`` in ``q.dtype``.
* A page id ``>= pool_pages`` is a sentinel and is masked by PAGE;
  query g sees cache positions ``<= pos[s, g]``.
* Scores are the fp32 dot divided by ``sqrt(hd)`` after the dot; PV
  uses fp32 p; a query with no live visible position returns exact
  zeros, never NaN.

Pool layout — the one difference from the JAX package: JAX scatters new
K/V with ``.at[pg, off].set(..., mode="drop")``, which discards writes
to the sentinel page id. PyTorch has no dropping scatter, and masking
the writes with a boolean index would sync the host in every layer of
every step. So the port's pools carry ONE spare page at index
``pool_pages`` (shape ``[pool_pages + 1, page_size, D]``): sentinel
writes land there, and every read masks it because its id is the
sentinel. ``pool_pages`` is passed explicitly; it defaults to
``k_pool.shape[0]`` (a pool without the spare page).

Executor: a CUDA tensor launches the kernel (or raises); a CPU tensor
takes the plain version, which is also what ``chip_smoke.py`` holds the
kernel against on the card.

Cost-model records (``parallax_tpu/ops/pallas_paged_attention.py:
425-469``): every call records its static signature and its route
(``impl``: 'kernel', or 'einsum' for the plain version, the JAX
package's name for its gather executor) under the current mesh
(``trace_records``; ``reset_trace_records`` clears them). The tuner
prices the kernel-route records with ``kernel_hbm_bytes``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import weakref
from typing import NamedTuple, Optional

import torch

from parallax_tpu_torch.compile import graphs as graphs_lib
from parallax_tpu_torch.ops import _cuda, collectives

_NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_MAX_G = 4
# pt_paged_decode(q, k_pool, v_pool, pages, pos, out, ws, S, G, H, hd, P,
#                 page_size, pool_pages, hb, nsplit, range, sqrt_hd,
#                 is_bf16, stream)
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# the kernel's chunk (csrc/paged_attention.cu CH): a split's range is a
# multiple of it
CHUNK = 32
# a split takes at least MIN_SPLIT positions and at most MAX_SPLIT (its
# page ids sit in shared memory)
MIN_SPLIT = 64
MAX_SPLIT = 4096

# The flagship decode shape (the JAX package's FLAGSHIP_DECODE):
# continuous serving of the transformer NMT flagship (D=512, 8 heads)
# with a 2048-position cap paged at 128 tokens/page, 64 slots, verify
# width 3.
FLAGSHIP_DECODE = dict(S=64, G=3, D=512, num_heads=8, page_size=128,
                       P=16, pool_pages=1024)

# kernel calls since the last reset (``launches = 0``): each launches
# ``paged_decode_kernel_sm90`` once, and ``paged_combine_kernel`` once
# more when its plan splits the positions (``launches_combine``)
launches = 0
launches_combine = 0


# -- sentinel semantics -----------------------------------------------------


def sentinel_write_coords(pages: torch.Tensor, pos: torch.Tensor,
                          page_size: int, pool_pages: int):
    """Write coordinates for scattering ``[S, G]`` new K/V positions
    through a ``[S, P]`` page table: position ``pos`` lands in page
    ``pages[s, pos // page_size]`` at offset ``pos % page_size``. An
    entry holding the sentinel (``>= pool_pages``) or a position past
    the table width maps to page id ``pool_pages`` — the spare page of
    the port's pool layout, which no read ever sees.

    Returns ``(pg [S, G], off [S, G])``."""
    P = pages.shape[1]
    page_slot = torch.div(pos, page_size, rounding_mode="floor")
    pg = torch.gather(pages, 1, page_slot.clamp(0, P - 1))
    pg = torch.where((page_slot < P) & (pg < pool_pages), pg,
                     torch.full_like(pg, pool_pages))
    return pg, pos % page_size


def paged_gather(pool_layer: torch.Tensor,
                 pages: torch.Tensor) -> torch.Tensor:
    """Clip-then-mask read gather: one slot-contiguous
    ``[S, P * page_size, D]`` view of a ``[pool, page_size, D]`` pool
    layer through a ``[S, P]`` page table. Sentinel entries CLIP to the
    pool's last page — callers MUST mask every gathered position beyond
    the slot's frontier (``pos <= t``) out of attention."""
    pool, ps, D = pool_layer.shape
    S, P = pages.shape
    safe = pages.clamp(0, pool - 1)
    return pool_layer[safe].reshape(S, P * ps, D)


# -- the plain version -------------------------------------------------------


def paged_decode_attention_plain(q, k_pool, v_pool, pages, pos, *,
                                 num_heads: int, page_size: int,
                                 pool_pages: Optional[int] = None):
    """The kernel's function in plain PyTorch ops (it reads every page
    of the table; the kernel reads only live, visible ones). Each query
    of a slot is computed as a one-query call, so a verify over G
    queries gives the bits of G single steps."""
    if q.shape[1] > 1:
        return torch.cat([paged_decode_attention_plain(
            q[:, g:g + 1], k_pool, v_pool, pages, pos[:, g:g + 1],
            num_heads=num_heads, page_size=page_size,
            pool_pages=pool_pages) for g in range(q.shape[1])], dim=1)
    S, G, D = q.shape
    P = pages.shape[1]
    hd = D // num_heads
    if pool_pages is None:
        pool_pages = k_pool.shape[0]
    live = (pages >= 0) & (pages < pool_pages)                 # [S, P]
    safe = torch.where(live, pages, torch.zeros_like(pages))
    k = k_pool[safe].reshape(S, P * page_size, num_heads, hd).float()
    v = v_pool[safe].reshape(S, P * page_size, num_heads, hd).float()
    tpos = torch.arange(P * page_size, device=q.device)
    visible = (live.repeat_interleave(page_size, dim=1)[:, None, :]
               & (tpos[None, None, :] <= pos[:, :, None]))     # [S, G, T]
    qh = q.reshape(S, G, num_heads, hd).float()
    s = torch.einsum("sghd,sthd->shgt", qh, k) / math.sqrt(hd)
    s = torch.where(visible[:, None], s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s > _NEG_INF / 2, p, 0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)                         # [S, H, G]
    out = torch.einsum("shgt,sthd->sghd", p, v)
    out = out / l.permute(0, 2, 1)[..., None]
    return out.reshape(S, G, D).to(q.dtype)


# -- the kernel --------------------------------------------------------------


class SplitPlan(NamedTuple):
    """How the kernel cuts one call: ``heads`` heads a block, each slot's
    positions in ``nsplit`` ranges of ``positions`` (a multiple of
    ``CHUNK``). The grid is ``(H // heads, S, nsplit)``."""
    heads: int
    nsplit: int
    positions: int


@functools.lru_cache(maxsize=None)
def split_plan(S: int, H: int, hd: int, P: int, page_size: int,
               itemsize: int, sm_count: int) -> SplitPlan:
    """The kernel's work split, a function of shapes alone: it never reads
    ``pos`` or ``pages``, which would sync the host in every layer.

    Heads a block: as many as make one position's row segment 256
    contiguous bytes (bf16 hd 64: 2; hd 128 or fp32: 1; 1 for an odd head
    count). Splits: the fewest, a power of two, that give every SM a
    block, but no range under ``MIN_SPLIT`` positions (or one range when
    the table is shorter) and none over ``MAX_SPLIT``. More splits cost
    the combine kernel and a block's start for little: on an H100 the
    serving shape and ``FLAGSHIP_DECODE`` (64 slots, a grid of 256 blocks
    unsplit) ran fastest unsplit (``chip_smoke.py``'s ``paged-splits``).
    The ranges cover ``P * page_size``, the last one ragged; none lies
    wholly past it."""
    heads = 2 if itemsize == 2 and hd == 64 and H % 2 == 0 else 1
    T = P * page_size
    chunks = max(-(-T // CHUNK), 1)
    want = -(-sm_count // max(S * (H // heads), 1))
    want = 1 << (want - 1).bit_length()
    nsplit = max(min(want, T // MIN_SPLIT), -(-T // MAX_SPLIT), 1)
    positions = -(-chunks // nsplit) * CHUNK
    return SplitPlan(heads, max(-(-T // positions), 1), positions)


_sm_counts = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _sm_counts.get(index)
    if n is None:
        n = torch.cuda.get_device_properties(index).multi_processor_count
        _sm_counts[index] = n
    return n


def _check_kernel_inputs(q, k_pool, v_pool, pages, pos, num_heads):
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool)):
        if x.dtype != q.dtype:
            raise ValueError(f"paged_decode_attention: {name} is "
                             f"{x.dtype}, q is {q.dtype}")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("pages", pages), ("pos", pos)):
        if x.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} on "
                             f"{x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"contiguous")
    for name, x in (("pages", pages), ("pos", pos)):
        if x.dtype != torch.int32:
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"int32, got {x.dtype}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"paged_decode_attention kernel takes "
                         f"{KERNEL_DTYPES}, got {q.dtype}")
    hd = q.shape[2] // num_heads
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_decode_attention kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if not 1 <= q.shape[1] <= KERNEL_MAX_G:
        raise ValueError(f"paged_decode_attention kernel takes 1 <= G <= "
                         f"{KERNEL_MAX_G} queries per slot, got "
                         f"{q.shape[1]}")
    # 16-byte cp.async copies and vector loads: every row starts on 16
    # bytes when the bases do (D * itemsize is a multiple of 16 at hd 64
    # and 128)
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if x.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must start "
                             f"on a 16-byte boundary")


def _kernel(q, k_pool, v_pool, pages, pos, num_heads, page_size,
            pool_pages):
    _check_kernel_inputs(q, k_pool, v_pool, pages, pos, num_heads)
    S, G, D = q.shape
    plan = split_plan(S, num_heads, D // num_heads, pages.shape[1],
                      page_size, q.element_size(), _sm_count(q.device))
    return _launch(q, k_pool, v_pool, pages, pos, num_heads, page_size,
                   pool_pages, plan)


def _launch(q, k_pool, v_pool, pages, pos, num_heads, page_size,
            pool_pages, plan: SplitPlan):
    """The kernel call under ``plan`` (checked inputs)."""
    S, G, D = q.shape
    out = torch.empty_like(q)
    if S == 0:
        return out
    hd = D // num_heads
    ws = None
    if plan.nsplit > 1:
        ws = torch.empty((S, plan.nsplit, G, num_heads, hd + 2),
                         dtype=torch.float32, device=q.device)
    fn = _cuda.function("paged_attention", "pt_paged_decode", _ARGTYPES)
    code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
              pages.data_ptr(), pos.data_ptr(), out.data_ptr(),
              None if ws is None else ws.data_ptr(), S, G, num_heads, hd,
              pages.shape[1], page_size, pool_pages, plan.heads,
              plan.nsplit, plan.positions, float(math.sqrt(hd)),
              int(q.dtype == torch.bfloat16),
              torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check("paged_attention", code, "paged_decode_attention")
    graphs_lib.count_launch(__name__, "launches")
    if plan.nsplit > 1:
        graphs_lib.count_launch(__name__, "launches_combine")
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, pages: torch.Tensor,
                           pos: torch.Tensor, *, num_heads: int,
                           page_size: int,
                           pool_pages: Optional[int] = None
                           ) -> torch.Tensor:
    """Paged self-attention for one decode step (module docstring)."""
    S, G, D = q.shape
    pool, ps, Dp = k_pool.shape
    if Dp != D or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do "
            f"not match q feature dim {D}")
    if ps != page_size:
        raise ValueError(
            f"page_size={page_size} != pool page dim {ps}")
    if D % num_heads:
        raise ValueError(f"model dim {D} not divisible by "
                         f"num_heads {num_heads}")
    if tuple(pos.shape) != (S, G):
        raise ValueError(f"pos shape {tuple(pos.shape)} != (S, G)="
                         f"({S}, {G})")
    if pages.dim() != 2 or pages.shape[0] != S:
        raise ValueError(f"pages shape {tuple(pages.shape)} is not "
                         f"(S={S}, P)")
    if pool_pages is None:
        pool_pages = pool
    if not 0 < pool_pages <= pool:
        raise ValueError(f"pool_pages={pool_pages} outside (0, {pool}]")
    _record_call(S, G, D, num_heads, page_size, pages.shape[1], pool_pages,
                 q.element_size(),
                 "kernel" if _cuda.kernel_route(q) else "einsum")
    if q.is_cuda:
        return _kernel(q, k_pool, v_pool, pages, pos, num_heads,
                       page_size, pool_pages)
    with _cuda.stand_in():
        return paged_decode_attention_plain(q, k_pool, v_pool, pages, pos,
                                            num_heads=num_heads,
                                            page_size=page_size,
                                            pool_pages=pool_pages)


# -- trace records for the cost model -------------------------------------------
# (mesh id, signature) -> (weak reference to the mesh or None, record)
_TRACE_RECORDS: "collections.OrderedDict" = collections.OrderedDict()
_TRACE_RECORDS_MAX = 64


def _record_call(S, G, D, num_heads, page_size, P, pool_pages, itemsize,
                 impl) -> None:
    mesh = collectives.current_mesh()
    info = {"S": int(S), "G": int(G), "D": int(D),
            "num_heads": int(num_heads), "page_size": int(page_size),
            "P": int(P), "pool_pages": int(pool_pages),
            "itemsize": int(itemsize), "impl": str(impl)}
    key = (id(mesh) if mesh is not None else None,
           tuple(sorted(info.items())))
    _TRACE_RECORDS[key] = (weakref.ref(mesh) if mesh is not None else None,
                           info)
    while len(_TRACE_RECORDS) > _TRACE_RECORDS_MAX:
        _TRACE_RECORDS.popitem(last=False)


def trace_records(mesh=None):
    """The recorded call signatures for ``mesh`` (None: calls outside a
    step's mesh, as serving makes them). Each dict carries S/G/D/
    num_heads/page_size/P/pool_pages/itemsize and ``impl``, the route
    that served the call ('kernel' | 'einsum')."""
    out = []
    for ref, info in _TRACE_RECORDS.values():
        m = ref() if ref is not None else None
        if (mesh is None and ref is None) or (m is mesh and m is not None):
            out.append(dict(info))
    return out


def reset_trace_records() -> None:
    _TRACE_RECORDS.clear()


# -- analytic HBM accounting -------------------------------------------------


def kernel_hbm_bytes(S, G, D, page_size, live_pages, itemsize,
                     num_layers: int = 1):
    """Analytic per-decode-step device-memory bytes of the kernel path:
    ``live_pages`` is the TOTAL live page entries across all S page
    tables. Each live entry streams one K and one V ``[page_size, D]``
    block; q and out are read and written once. Not a measurement."""
    stream = 2 * int(live_pages) * page_size * D * itemsize   # K + V
    qout = 2 * S * G * D * itemsize
    return {"stream_bytes": num_layers * stream,
            "qout_bytes": num_layers * qout,
            "total_bytes": num_layers * (stream + qout)}


__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "paged_gather", "sentinel_write_coords", "kernel_hbm_bytes",
           "split_plan", "SplitPlan", "FLAGSHIP_DECODE", "trace_records",
           "reset_trace_records"]
