"""The LSTM scan of LM1B: three CUDA kernels and their plain versions.

Counterpart of ``parallax_tpu/ops/pallas_lstm.py``. The gate matrix
w = [w_x; w_h] ([E+P, 4H], gate order i|f|g|o) splits by row:

- ``x @ w_x`` for all timesteps is hoisted out of the recurrence into
  one batched matmul (``_hoisted_xw``), stored at the compute dtype;
- ``h @ w_h`` is the recurrence, which runs in a hand-written kernel:
  B1 (the primal forward), B2 (the forward under differentiation, which
  also saves the post-activation gates and the c trajectory) and B3
  (the time-reversed backward, which streams ``d_xw`` and the fp32
  ``dh_total`` out). The kernels are ``parallax_tpu_torch/csrc/lstm.cu``,
  ``csrc/lstm_sm90.cu`` (bf16) and ``csrc/lstm_f32_sm90.cu`` (the fp32
  forward); their headers say how they are laid out and what bounds
  them.

Every weight gradient leaves the recurrence as one batched product with
fp32 accumulation (``_bwd_epilogue``), the mirror of the hoist; these
and the hoist are plain large products and stay ``torch.matmul``, as
the JAX package left them to XLA.

Numerics (the Pallas kernels', kept by the kernels and the plain
versions alike): the (c, h) carries and the (dc, dh) cotangent carries
are fp32; each recurrent product rounds its activation operand to the
weight dtype and accumulates in fp32; xw, the residuals and d_xw are
stored at the compute dtype.

Routing (``fwd_route`` for B1 and B2, ``bwd_route`` for B3, pure
functions of dtype, shape and the card's SM count, decided before the
launch): bf16 on the shapes the persistent kernels take goes to
``csrc/lstm_sm90.cu`` (one cooperative launch per pass, the weights
resident in shared memory, the products on wgmma); the fp32 forward on
the shapes its persistent kernel takes to ``csrc/lstm_f32_sm90.cu`` (the
same structure, its products split-operand TF32 mma.sync, x = tf32 hi +
tf32 lo, three TF32 products each: one TF32 product would break the 1e-4
contract); fp32 B3 and every other shape go to the first kernels,
``csrc/lstm.cu``. At an H100's 132 SMs the LM1B step (T20 B128 H2048
P512), ``examples/lm1b_eval``'s T20 B16 and the drift sentinels' pair
(T6 B8 H32 P16, ``obs/numwatch.py``) take the persistent forwards in both
dtypes. Nothing falls back: a build or launch failure raises.

``lstm_scan(impl="kernel")`` runs B2 and B3 through an
``autograd.Function`` when a gradient is wanted and B1 when it is not
(grad mode off, or no input requires grad): the ``custom_vjp`` primal /
fwd split of the JAX package. ``impl="scan"`` is the plain reference
scan under autograd (the JAX package's ``"xla"``). ``bwd_impl``:
``"kernel"`` (B3), ``"scan"`` (the plain residual backward, same
algorithm in torch ops), ``"recompute"`` (no residuals: B1 forward, the
backward re-runs the reference scan widened to fp32 under autograd), or
``"auto"`` = ``"kernel"`` on the card and ``"scan"`` on the CPU. The
env var ``PARALLAX_LSTM_BWD`` overrides the argument. The Pallas
version's VMEM fit logic is TPU-only and has no counterpart.

Executor: for CUDA tensors each kernel wrapper launches its kernel or
raises; for CPU tensors it runs the plain version, which is also what
``chip_smoke.py`` holds the kernels against on the card. Each wrapper
counts its launches in a module-level integer (``launches_fwd`` for B1,
``launches_fwd_res`` for B2, ``launches_bwd`` for B3); reset by
assignment.

Cost-model records (``parallax_tpu/ops/pallas_lstm.py:616-664``): every
``lstm_scan(impl="kernel")`` call records its static signature
(``trace_records``, by mesh; ``reset_trace_records`` clears them), the
batch over the ranks it is split over, so ``tune.costmodel.
inputs_from_engine`` prices the kernels' traffic with
``kernel_hbm_bytes``; the plain route records nothing, as the JAX
package's ``impl="xla"`` does not. A record is kept once per (mesh,
signature): two LSTM layers of one shape on one mesh are one record.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import weakref
from typing import NamedTuple

import torch

from parallax_tpu_torch.compile import graphs as graphs_lib
from parallax_tpu_torch.ops import _cuda, collectives

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
BWD_IMPLS = ("auto", "kernel", "scan", "recompute")
# pt_lstm_fwd(xw, w_h, w_proj, hs, gates, cseq, c, hfull, ws, ks, T, B, H,
#             P, is_bf16, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
# pt_lstm_bwd(g, gates, cseq, w_h, w_proj, dxw, dhtot, dc, ws, ks, T, B, H,
#             P, is_bf16, stream)
_BWD_ARGTYPES = _FWD_ARGTYPES
# pt_lstm_fwd_sm90(xw, w_h, w_proj, hs, gates, cseq, hfull, counter, T,
#                  B, H, P, groups, stages, stream)
_SM90_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
# pt_lstm_bwd_sm90(g, gates, cseq, w_h, w_proj, dxw, dhtot, dh_bf, ws,
#                  counter, T, B, H, P, groups, stages, stream)
_SM90_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
# pt_lstm_fwd_tf32x3(xw, w_h, w_proj, hs, gates, cseq, hfull, counter, T,
#                    B, H, P, stream)
_F32_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
# the kernels split a contraction of length K into this many slices, of
# at least 256 each, for at most 32
_SPLIT_MIN, _SPLIT_MAX = 256, 32
# the persistent kernel: at most 227 KB of shared memory a block (sm_90),
# one 64-row tile per warpgroup, 16 hidden units per group, its ring
# stages tried from the deepest
SM90_SMEM = 232448
SM90_MAX_B = 128
SM90_GROUPS = (1, 2)
SM90_STAGES = (4, 3, 2)
# the backward tries the fewest blocks first: each block writes a whole
# fp32 [B, P] partial of dh and the owners read them all back, so the
# partials' L2 traffic grows with the block count (at the LM1B shape on an
# H100, 64 blocks of 32 units took 0.47 ms a call against 0.62 for 128 of
# 16); a deeper ring than 2 stages was no faster
SM90_BWD_GROUPS = (2, 1)
SM90_BWD_STAGES = 2
# the persistent fp32 forward's shared memory beside its w_h slice, in
# bytes (csrc/lstm_f32_sm90.cu's 2 * kStage + kRed floats): two ring stages
# of 128 rows of 72 floats and two 64 x 12 chunks of w_proj each, and the
# projection's half sums (2 KB)
F32_FIXED_SMEM = 4 * (2 * (128 * 72 + 2 * 64 * 12) + 512)

# kernel launches since the last reset (assign 0 to reset)
launches_fwd = 0        # B1
launches_fwd_res = 0    # B2
launches_bwd = 0        # B3


def _split_w(w: torch.Tensor, w_proj: torch.Tensor):
    """w [E+P, 4H] -> (w_x [E, 4H], w_h [P, 4H]); E = rows - P."""
    P = w_proj.shape[1]
    return w[:-P], w[-P:]


def _dot(a: torch.Tensor, b: torch.Tensor, md: torch.dtype) -> torch.Tensor:
    """``a @ b`` with both operands rounded to ``md`` and an fp32
    result. Products of bf16 values are exact in fp32, so the fp32
    product of the rounded operands is the fp32-accumulated bf16
    product, with no bf16 rounding of the result."""
    return torch.matmul(a.to(md).float(), b.to(md).float())


def _hoisted_xw(x_seq, w_x, b, matmul_dtype=None, store_dtype=None):
    """The input-projection half of the gate pre-activation for all
    timesteps as one product: [T, B, E] -> [T, B, 4H] at ``store_dtype``
    (default: x_seq's), from ``matmul_dtype`` operands (default: w_x's)
    with the bias added before the one rounding. In fp32 this is the JAX
    function exactly; in bf16 ``addmm`` adds the bias to the fp32
    accumulator on the card."""
    md = matmul_dtype or w_x.dtype
    sd = store_dtype or x_seq.dtype
    T, B, E = x_seq.shape
    xw = torch.addmm(b.to(md), x_seq.reshape(T * B, E).to(md), w_x.to(md))
    return xw.reshape(T, B, -1).to(sd)


# -- plain versions ----------------------------------------------------------


def _recurrence_plain(xw, w_h, w_proj, md, od, residuals):
    T, B, _ = xw.shape
    H, P = w_proj.shape
    c = torch.zeros((B, H), dtype=torch.float32, device=xw.device)
    h = torch.zeros((B, P), dtype=torch.float32, device=xw.device)
    hs, gl, cl = [], [], []
    for t in range(T):
        gates = xw[t].float() + _dot(h, w_h, md)
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f = torch.sigmoid(i), torch.sigmoid(f + 1.0)
        g, o = torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = _dot(o * torch.tanh(c), w_proj, md)
        hs.append(h.to(od))
        if residuals:
            gl.append(torch.cat([i, f, g, o], dim=-1).to(xw.dtype))
            cl.append(c.to(xw.dtype))
    out = torch.stack(hs) if hs else xw.new_zeros((0, B, P), dtype=od)
    if not residuals:
        return out
    return out, torch.stack(gl), torch.stack(cl)


def lstm_recurrence_plain(xw, w_h, w_proj, residuals: bool = False):
    """The plain version of B1 (``residuals=False``: hs [T, B, P]) and B2
    (``residuals=True``: (hs, gates [T, B, 4H], c [T, B, H]))."""
    return _recurrence_plain(xw, w_h, w_proj, w_h.dtype, xw.dtype,
                             residuals)


def lstm_bwd_recurrence_plain(g, gates, cseq, w_h, w_proj):
    """The plain version of B3: (d_xw [T, B, 4H] compute dtype,
    dh_total [T, B, P] fp32) from the cotangent g [T, B, P] and the
    saved residuals, time-reversed with fp32 (dc, dh) carries."""
    T, B, P = g.shape
    H = w_proj.shape[0]
    md = w_h.dtype
    f32 = torch.float32
    dc = torch.zeros((B, H), dtype=f32, device=g.device)
    dh = torch.zeros((B, P), dtype=f32, device=g.device)
    dxw = torch.empty((T, B, 4 * H), dtype=gates.dtype, device=g.device)
    dhtot = torch.empty((T, B, P), dtype=f32, device=g.device)
    for s in reversed(range(T)):
        i, f, ga, o = gates[s].float().chunk(4, dim=-1)
        c_t = cseq[s].float()
        c_prev = cseq[s - 1].float() if s > 0 else torch.zeros_like(c_t)
        dh_tot = g[s].float() + dh
        dhtot[s] = dh_tot
        d_hfull = _dot(dh_tot, w_proj.t(), md)
        tc = torch.tanh(c_t)
        d_o = d_hfull * tc
        dc_tot = dc + d_hfull * o * (1.0 - tc * tc)
        d_i, d_f, d_g = dc_tot * ga, dc_tot * c_prev, dc_tot * i
        dc = dc_tot * f
        d_gates = torch.cat([d_i * i * (1.0 - i), d_f * f * (1.0 - f),
                             d_g * (1.0 - ga * ga), d_o * o * (1.0 - o)],
                            dim=-1)
        dxw[s] = d_gates.to(gates.dtype)
        dh = _dot(d_gates, w_h.t(), md)
    return dxw, dhtot


def lstm_scan_reference(x_seq, w, b, w_proj, *, out_dtype=None,
                        matmul_dtype=None, store_dtype=None):
    """The plain scan with the kernels' numerics: the x-projection
    hoisted, fp32 (c, h) carries whatever the input dtype. The dtype
    hooks pin the rounding points to the original dtypes when the
    inputs arrive widened to fp32 (the recompute backward)."""
    md = matmul_dtype or w.dtype
    od = out_dtype or x_seq.dtype
    w_x, w_h = _split_w(w, w_proj)
    xw = _hoisted_xw(x_seq, w_x, b, matmul_dtype=md,
                     store_dtype=store_dtype)
    return _recurrence_plain(xw, w_h, w_proj, md, od, residuals=False)


# -- the kernels --------------------------------------------------------------


class FwdRoute(NamedTuple):
    """Which kernel runs a B1/B2 (or, from ``bwd_route``, a B3) call:
    ``source`` is ``"lstm_sm90"`` (the persistent bf16 kernel, ``groups``
    x 16 hidden units a block, ``stages`` ring stages),
    ``"lstm_f32_sm90"`` (the persistent fp32 forward, whose design is
    fixed: 16 units a block, 2 stages; groups = stages = 0) or ``"lstm"``
    (the first kernel; groups = stages = 0)."""
    source: str
    groups: int = 0
    stages: int = 0


def sm90_smem_bytes(groups: int, H: int, P: int, stages: int) -> int:
    """Dynamic shared memory of the persistent kernel (its ``Smem``): the
    w_h slice, the w_proj slice, two rings of 8 KB boxes, the projection's
    half sums, the ring barriers and 1 KB for alignment."""
    kc, kh = -(-P // 64), -(-H // 64)
    return 1024 + groups * kc * 8192 + kh * 1024 + 2 * stages * 8192 \
        + 2048 + 2 * stages * 8


def f32_smem_bytes(P: int) -> int:
    """Dynamic shared memory of the persistent fp32 forward: the w_h
    slice (64 gate columns of P rounded up to 32, plus 8, floats), the
    two ring stages and the projection's half sums."""
    return 4 * 64 * (-(-P // 32) * 32 + 8) + F32_FIXED_SMEM


def fwd_route(dtype: torch.dtype, T: int, B: int, H: int, P: int,
              sm_count: int) -> FwdRoute:
    """The kernel for a B1/B2 call, from dtype, shape and the card's SM
    count alone. The persistent kernel takes bf16 with B <= 128, P a
    multiple of 8 (16-byte TMA strides), H a multiple of 16 G for some G
    in (1, 2) whose H / 16G blocks all fit on the card (one a SM; the
    grid barriers need them all resident), P / 8 projection column tiles
    dividing the blocks, and shared memory that fits; it takes the
    smallest such G and the deepest ring that fits. The persistent fp32
    forward takes fp32 with B <= 128, P a multiple of 8, H a multiple of
    16 whose H / 16 blocks all fit on the card, and a w_h slice that fits
    (P up to 544): ``("lstm_f32_sm90", 0, 0)``. Everything else runs the
    first kernel."""
    first = FwdRoute("lstm")
    if not (1 <= B <= SM90_MAX_B) or T < 1 or P < 8 or P % 8:
        return first
    if dtype == torch.float32:
        if H < 16 or H % 16 or H // 16 > sm_count \
                or f32_smem_bytes(P) > SM90_SMEM:
            return first
        return FwdRoute("lstm_f32_sm90")
    if dtype != torch.bfloat16:
        return first
    for groups in SM90_GROUPS:
        if H % (16 * groups):
            continue
        blocks = H // (16 * groups)
        if blocks > sm_count or blocks % (P // 8):
            continue
        for stages in SM90_STAGES:
            if sm90_smem_bytes(groups, H, P, stages) <= SM90_SMEM:
                return FwdRoute("lstm_sm90", groups, stages)
    return first


def sm90_bwd_smem_bytes(groups: int, P: int, stages: int) -> int:
    """Dynamic shared memory of the persistent backward (its ``BwdSmem``):
    the w_h slice, the block's 16-row w_proj chunks, two rings of 8 KB
    boxes, the ring barriers and 1 KB for alignment."""
    kc = -(-P // 64)
    return 1024 + groups * kc * (8192 + 2048) + 2 * stages * 8192 \
        + 2 * stages * 8


def bwd_route(dtype: torch.dtype, T: int, B: int, H: int, P: int,
              sm_count: int) -> FwdRoute:
    """The kernel for a B3 call, from dtype, shape and the card's SM count
    alone. The persistent backward takes bf16 with B <= 128, P a multiple
    of 8, H a multiple of 16 G for some G in (2, 1) whose H / 16G blocks
    all fit on the card, and shared memory that fits; it takes the
    largest such G (the fewest blocks, so the fewest partials of dh) and
    a 2-stage ring. Everything else, fp32 always, runs the first
    kernel."""
    first = FwdRoute("lstm")
    if dtype != torch.bfloat16 or not (1 <= B <= SM90_MAX_B) \
            or T < 1 or P < 8 or P % 8:
        return first
    for groups in SM90_BWD_GROUPS:
        if H % (16 * groups) or H // (16 * groups) > sm_count:
            continue
        if sm90_bwd_smem_bytes(groups, P, SM90_BWD_STAGES) <= SM90_SMEM:
            return FwdRoute("lstm_sm90", groups, SM90_BWD_STAGES)
    return first


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_fwd_route(xw: torch.Tensor, w_proj: torch.Tensor) -> FwdRoute:
    """``fwd_route`` for CUDA tensors of a B1/B2 call on their card."""
    T, B, _ = xw.shape
    H, P = w_proj.shape
    return fwd_route(xw.dtype, T, B, H, P, _sm_count(xw.device.index or 0))


def device_bwd_route(g: torch.Tensor, w_proj: torch.Tensor) -> FwdRoute:
    """``bwd_route`` for CUDA tensors of a B3 call (g [T, B, P] and the
    weights' dtype) on their card."""
    T, B, P = g.shape
    H = w_proj.shape[0]
    return bwd_route(w_proj.dtype, T, B, H, P,
                     _sm_count(g.device.index or 0))


def _ksplit(K: int) -> int:
    """How many slices the kernels split a contraction of length K into
    (the [B, P] products have too few output tiles to fill the card)."""
    return max(1, min(_SPLIT_MAX, -(-K // _SPLIT_MIN)))


def _check(name, xw_like, tensors):
    for what, x in tensors:
        if not x.is_cuda or x.device != xw_like.device:
            raise ValueError(f"{name}: {what} on {x.device}, expected "
                             f"{xw_like.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def _kernel_fwd(xw, w_h, w_proj, residuals):
    name = "lstm_fwd_res" if residuals else "lstm_fwd"
    dt = xw.dtype
    if dt not in KERNEL_DTYPES:
        raise ValueError(f"{name} kernel takes {KERNEL_DTYPES}, got {dt}")
    if w_h.dtype != dt or w_proj.dtype != dt:
        raise ValueError(f"{name} kernel takes one dtype for xw, w_h and "
                         f"w_proj, got {dt}, {w_h.dtype}, {w_proj.dtype}")
    T, B, H4 = xw.shape
    H, P = w_proj.shape
    if H4 != 4 * H or tuple(w_h.shape) != (P, 4 * H):
        raise ValueError(f"{name}: xw {tuple(xw.shape)}, w_h "
                         f"{tuple(w_h.shape)}, w_proj {tuple(w_proj.shape)}"
                         f" do not fit [T, B, 4H], [P, 4H], [H, P]")
    _check(name, xw, (("xw", xw), ("w_h", w_h), ("w_proj", w_proj)))
    hs = torch.empty((T, B, P), dtype=dt, device=xw.device)
    gates = cseq = None
    if residuals:
        gates = torch.empty((T, B, 4 * H), dtype=dt, device=xw.device)
        cseq = torch.empty((T, B, H), dtype=dt, device=xw.device)
    if T * B * H * P == 0:
        return (hs, gates, cseq) if residuals else hs
    route = device_fwd_route(xw, w_proj)
    if route.source == "lstm_sm90":
        _sm90_fwd(name, route, xw, w_h, w_proj, hs, gates, cseq)
    elif route.source == "lstm_f32_sm90":
        _f32_fwd(name, xw, w_h, w_proj, hs, gates, cseq)
    else:
        _first_fwd(name, xw, w_h, w_proj, hs, gates, cseq)
    if residuals:
        graphs_lib.count_launch(__name__, "launches_fwd_res")
        return hs, gates, cseq
    graphs_lib.count_launch(__name__, "launches_fwd")
    return hs


def _check_aligned(name, tensors):
    """The persistent kernels load with 16-byte vectors and TMA: every
    base must start on a 16-byte boundary."""
    for what, x in tensors:
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must start on a 16-byte "
                             f"boundary for the bf16 kernel")


def _sm90_fwd(name, route, xw, w_h, w_proj, hs, gates, cseq):
    T, B, _ = xw.shape
    H, P = w_proj.shape
    _check_aligned(name, (("xw", xw), ("w_h", w_h), ("w_proj", w_proj)))
    hfull = torch.empty((2, B, H), dtype=xw.dtype, device=xw.device)
    counter = torch.zeros((1,), dtype=torch.int32, device=xw.device)
    fn = _cuda.function("lstm_sm90", "pt_lstm_fwd_sm90", _SM90_ARGTYPES)
    code = fn(xw.data_ptr(), w_h.data_ptr(), w_proj.data_ptr(),
              hs.data_ptr(), None if gates is None else gates.data_ptr(),
              None if cseq is None else cseq.data_ptr(), hfull.data_ptr(),
              counter.data_ptr(), T, B, H, P, route.groups, route.stages,
              torch.cuda.current_stream(xw.device).cuda_stream)
    _cuda.check("lstm_sm90", code, name)


def _f32_fwd(name, xw, w_h, w_proj, hs, gates, cseq):
    T, B, _ = xw.shape
    H, P = w_proj.shape
    # 16-byte loads, where the first kernel it replaces took any base: a
    # view off 16 bytes is copied, not refused
    xw, w_h, w_proj = (_cuda.aligned(x) for x in (xw, w_h, w_proj))
    hfull = torch.empty((B, H), dtype=torch.float32, device=xw.device)
    counter = torch.zeros((1,), dtype=torch.int32, device=xw.device)
    fn = _cuda.function("lstm_f32_sm90", "pt_lstm_fwd_tf32x3",
                        _F32_ARGTYPES)
    code = fn(xw.data_ptr(), w_h.data_ptr(), w_proj.data_ptr(),
              hs.data_ptr(), None if gates is None else gates.data_ptr(),
              None if cseq is None else cseq.data_ptr(), hfull.data_ptr(),
              counter.data_ptr(), T, B, H, P,
              torch.cuda.current_stream(xw.device).cuda_stream)
    _cuda.check("lstm_f32_sm90", code, name)


def _first_fwd(name, xw, w_h, w_proj, hs, gates, cseq):
    T, B, _ = xw.shape
    H, P = w_proj.shape
    dt = xw.dtype
    c = torch.empty((B, H), dtype=torch.float32, device=xw.device)
    hfull = torch.empty((B, H), dtype=dt, device=xw.device)
    ks = _ksplit(H)
    ws = torch.empty((ks, B, P), dtype=torch.float32, device=xw.device)
    fn = _cuda.function("lstm", "pt_lstm_fwd", _FWD_ARGTYPES)
    code = fn(xw.data_ptr(), w_h.data_ptr(), w_proj.data_ptr(),
              hs.data_ptr(), None if gates is None else gates.data_ptr(),
              None if cseq is None else cseq.data_ptr(), c.data_ptr(),
              hfull.data_ptr(), ws.data_ptr(), ks, T, B, H, P,
              int(dt == torch.bfloat16),
              torch.cuda.current_stream(xw.device).cuda_stream)
    _cuda.check("lstm", code, name)


def _kernel_bwd(g, gates, cseq, w_h, w_proj):
    dt = gates.dtype
    if dt not in KERNEL_DTYPES or g.dtype != torch.float32:
        raise ValueError(f"lstm_bwd kernel takes fp32 g and residuals in "
                         f"{KERNEL_DTYPES}, got {g.dtype} and {dt}")
    if cseq.dtype != dt or w_h.dtype != dt or w_proj.dtype != dt:
        raise ValueError(f"lstm_bwd kernel takes one dtype for gates, c, "
                         f"w_h and w_proj, got {dt}, {cseq.dtype}, "
                         f"{w_h.dtype}, {w_proj.dtype}")
    T, B, P = g.shape
    H = w_proj.shape[0]
    if (tuple(gates.shape) != (T, B, 4 * H)
            or tuple(cseq.shape) != (T, B, H)
            or tuple(w_h.shape) != (P, 4 * H)
            or tuple(w_proj.shape) != (H, P)):
        raise ValueError(f"lstm_bwd: g {tuple(g.shape)}, gates "
                         f"{tuple(gates.shape)}, c {tuple(cseq.shape)}, w_h "
                         f"{tuple(w_h.shape)}, w_proj {tuple(w_proj.shape)} "
                         f"do not fit one (T, B, H, P)")
    _check("lstm_bwd", g, (("g", g), ("gates", gates), ("c", cseq),
                           ("w_h", w_h), ("w_proj", w_proj)))
    dxw = torch.empty((T, B, 4 * H), dtype=dt, device=g.device)
    dhtot = torch.empty((T, B, P), dtype=torch.float32, device=g.device)
    if T * B * H * P == 0:
        return dxw.zero_(), dhtot.zero_()
    route = device_bwd_route(g, w_proj)
    if route.source == "lstm_sm90":
        _sm90_bwd(route, g, gates, cseq, w_h, w_proj, dxw, dhtot)
    else:
        _first_bwd(g, gates, cseq, w_h, w_proj, dxw, dhtot)
    graphs_lib.count_launch(__name__, "launches_bwd")
    return dxw, dhtot


def _sm90_bwd(route, g, gates, cseq, w_h, w_proj, dxw, dhtot):
    T, B, P = g.shape
    H = w_proj.shape[0]
    _check_aligned("lstm_bwd", (("g", g), ("gates", gates), ("c", cseq),
                                ("w_h", w_h), ("w_proj", w_proj)))
    dev = g.device
    dh_bf = torch.empty((2, B, P), dtype=w_proj.dtype, device=dev)
    ws = torch.empty((H // (16 * route.groups), B, P), dtype=torch.float32,
                     device=dev)
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    fn = _cuda.function("lstm_sm90", "pt_lstm_bwd_sm90", _SM90_BWD_ARGTYPES)
    code = fn(g.data_ptr(), gates.data_ptr(), cseq.data_ptr(),
              w_h.data_ptr(), w_proj.data_ptr(), dxw.data_ptr(),
              dhtot.data_ptr(), dh_bf.data_ptr(), ws.data_ptr(),
              counter.data_ptr(), T, B, H, P, route.groups, route.stages,
              torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check("lstm_sm90", code, "lstm_bwd")


def _first_bwd(g, gates, cseq, w_h, w_proj, dxw, dhtot):
    T, B, P = g.shape
    H = w_proj.shape[0]
    dt = gates.dtype
    dc = torch.empty((B, H), dtype=torch.float32, device=g.device)
    ks = _ksplit(4 * H)
    ws = torch.empty((ks, B, P), dtype=torch.float32, device=g.device)
    fn = _cuda.function("lstm", "pt_lstm_bwd", _BWD_ARGTYPES)
    code = fn(g.data_ptr(), gates.data_ptr(), cseq.data_ptr(),
              w_h.data_ptr(), w_proj.data_ptr(), dxw.data_ptr(),
              dhtot.data_ptr(), dc.data_ptr(), ws.data_ptr(), ks, T, B, H,
              P, int(dt == torch.bfloat16),
              torch.cuda.current_stream(g.device).cuda_stream)
    _cuda.check("lstm", code, "lstm_bwd")


def lstm_recurrence(xw, w_h, w_proj, residuals: bool = False):
    """B1 (``residuals=False``) or B2 over the hoisted xw [T, B, 4H]:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if xw.is_cuda:
        return _kernel_fwd(xw, w_h, w_proj, residuals)
    with _cuda.stand_in():
        return lstm_recurrence_plain(xw, w_h, w_proj, residuals)


def lstm_bwd_recurrence(g, gates, cseq, w_h, w_proj):
    """B3: the kernel for CUDA tensors, the plain version for CPU
    tensors. ``g`` is the fp32 cotangent of hs."""
    if g.is_cuda:
        return _kernel_bwd(g, gates, cseq, w_h, w_proj)
    with _cuda.stand_in():
        return lstm_bwd_recurrence_plain(g, gates, cseq, w_h, w_proj)


# -- the gradient ---------------------------------------------------------------


def _bwd_epilogue(x_seq, w, b, w_proj, gates, cseq, hs, dxw, dhtot):
    """The hoisted half of the residual backward: one product per
    weight gradient, fp32 accumulation, each cotangent rounded to its
    input's dtype once, at the end."""
    T, B, E = x_seq.shape
    H, P = w_proj.shape
    w_x, _ = _split_w(w, w_proj)
    wd = w.dtype
    dxw_m = dxw.to(wd).reshape(T * B, 4 * H)
    dx = torch.matmul(dxw_m, w_x.t()).to(x_seq.dtype).reshape(T, B, E)
    dw_x = torch.matmul(x_seq.to(wd).reshape(T * B, E).t(), dxw_m)
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]], dim=0)
    dw_h = torch.matmul(h_prev.to(wd).reshape(T * B, P).t(), dxw_m)
    db = dxw.float().sum(dim=(0, 1))
    # h_full = o * tanh(c), recomputed from the residuals and rounded to
    # the projection dtype as the forward rounded it
    o = gates[..., 3 * H:].float()
    h_full = (o * torch.tanh(cseq.float())).to(w_proj.dtype).float()
    dw_proj = torch.matmul(h_full.reshape(T * B, H).t(),
                           dhtot.reshape(T * B, P))
    dw = torch.cat([dw_x, dw_h], dim=0).to(w.dtype)
    return dx, dw, db.to(b.dtype), dw_proj.to(w_proj.dtype)


def _bwd_recompute(x_seq, w, b, w_proj, g):
    """Re-run the reference scan on fp32-widened inputs with the
    rounding points pinned to the original dtypes, and differentiate it:
    every weight gradient accumulates in fp32, and g enters unrounded."""
    f32 = torch.float32
    with torch.enable_grad():
        wide = [t.detach().to(f32).requires_grad_()
                for t in (x_seq, w, b, w_proj)]
        out = lstm_scan_reference(*wide, out_dtype=f32,
                                  matmul_dtype=w.dtype,
                                  store_dtype=x_seq.dtype)
        grads = torch.autograd.grad(out, wide, g.to(f32))
    return tuple(d.to(t.dtype) for d, t in zip(grads, (x_seq, w, b, w_proj)))


class _LSTMScanKernel(torch.autograd.Function):
    """B2 in ``forward`` (B1 under ``bwd_impl="recompute"``, which saves
    no residuals), B3 or its plain version in ``backward``."""

    @staticmethod
    def forward(ctx, x_seq, w, b, w_proj, bwd_impl):
        w_x, w_h = _split_w(w, w_proj)
        xw = _hoisted_xw(x_seq, w_x, b)
        ctx.bwd_impl = bwd_impl
        if bwd_impl == "recompute":
            hs = lstm_recurrence(xw, w_h, w_proj)
            ctx.save_for_backward(x_seq, w, b, w_proj)
            return hs
        hs, gates, cseq = lstm_recurrence(xw, w_h, w_proj, residuals=True)
        ctx.save_for_backward(x_seq, w, b, w_proj, gates, cseq, hs)
        return hs

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd_impl == "recompute":
            x_seq, w, b, w_proj = ctx.saved_tensors
            return (*_bwd_recompute(x_seq, w, b, w_proj, g), None)
        x_seq, w, b, w_proj, gates, cseq, hs = ctx.saved_tensors
        _, w_h = _split_w(w, w_proj)
        g32 = g.to(torch.float32).contiguous()
        if ctx.bwd_impl == "kernel":
            dxw, dhtot = lstm_bwd_recurrence(g32, gates, cseq, w_h, w_proj)
        else:
            dxw, dhtot = lstm_bwd_recurrence_plain(g32, gates, cseq, w_h,
                                                   w_proj)
        return (*_bwd_epilogue(x_seq, w, b, w_proj, gates, cseq, hs, dxw,
                               dhtot), None)


def resolve_bwd_impl(bwd_impl: str, device: torch.device) -> str:
    """``PARALLAX_LSTM_BWD`` over the argument; ``auto`` is ``kernel`` on
    the card and ``scan`` on the CPU (a meta tensor as the device its
    pass stands for, ``_cuda.meta_for``)."""
    bwd_impl = os.environ.get("PARALLAX_LSTM_BWD") or bwd_impl
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"unknown lstm bwd_impl {bwd_impl!r}; expected "
                         f"one of {BWD_IMPLS}")
    if bwd_impl == "auto":
        cuda = _cuda.routed_device(device).type == "cuda"
        return "kernel" if cuda else "scan"
    return bwd_impl


def lstm_scan(x_seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              w_proj: torch.Tensor, *, impl: str = "scan",
              bwd_impl: str = "auto") -> torch.Tensor:
    """Fused-gate LSTM scan with projection, x_seq [T, B, E] ->
    hs [T, B, P]; w [E+P, 4H] (i|f|g|o), b [4H], w_proj [H, P].
    ``impl="kernel"``: the hoisted projection plus the CUDA recurrence
    (B1/B2/B3 on the card); ``"scan"``: the plain reference scan."""
    if impl not in ("scan", "kernel"):
        raise ValueError(f"unknown lstm impl {impl!r}; expected 'scan' or "
                         f"'kernel'")
    if impl == "scan":
        return lstm_scan_reference(x_seq, w, b, w_proj)
    bwd_impl = resolve_bwd_impl(bwd_impl, x_seq.device)
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x_seq, w, b, w_proj))
    _record_call(x_seq, w, w_proj, bwd_impl)
    with torch.profiler.record_function("lstm.py"):
        if not wants_grad:
            w_x, w_h = _split_w(w, w_proj)
            return lstm_recurrence(_hoisted_xw(x_seq, w_x, b), w_h,
                                   w_proj)
        return _LSTMScanKernel.apply(x_seq, w, b, w_proj, bwd_impl)


# -- trace records for the cost model -------------------------------------------
# (mesh id, signature) -> (weak reference to the mesh or None, record)
_TRACE_RECORDS: "collections.OrderedDict" = collections.OrderedDict()
_TRACE_RECORDS_MAX = 64


def _record_call(x_seq, w, w_proj, bwd_impl) -> None:
    """Record one kernel-route call's signature under the current mesh
    (``collectives.current_mesh``; None outside a step), with the batch
    over the ranks it is split over."""
    T, B, E = x_seq.shape
    H, P = w_proj.shape
    mesh = collectives.current_mesh()
    group = collectives.batch_group(mesh) if mesh is not None else None
    n_shards = group.size if group is not None else 1
    info = {"T": int(T), "B": int(B) * n_shards, "E": int(E), "H": int(H),
            "P": int(P), "x_itemsize": int(x_seq.element_size()),
            "w_itemsize": int(w.element_size()),
            "n_shards": int(n_shards), "bwd": str(bwd_impl)}
    key = (id(mesh) if mesh is not None else None,
           tuple(sorted(info.items())))
    _TRACE_RECORDS[key] = (weakref.ref(mesh) if mesh is not None else None,
                           info)
    while len(_TRACE_RECORDS) > _TRACE_RECORDS_MAX:
        _TRACE_RECORDS.popitem(last=False)


def trace_records(mesh=None):
    """The recorded kernel-route call signatures for ``mesh`` (None: the
    calls made outside a step's mesh). Each is a dict of T/B/E/H/P, the
    x and w itemsizes, n_shards and ``bwd``, the backward that serves
    the call ('kernel' | 'scan' | 'recompute')."""
    out = []
    for ref, info in _TRACE_RECORDS.values():
        m = ref() if ref is not None else None
        if (mesh is None and ref is None) or (m is mesh and m is not None):
            out.append(dict(info))
    return out


def reset_trace_records() -> None:
    _TRACE_RECORDS.clear()


def kernel_hbm_bytes(T, B, E, H, P, x_itemsize, w_itemsize, *,
                     bwd="kernel", g_itemsize=4):
    """Per-step-batch device-memory bytes of the recurrence kernels under
    training (a copy of the JAX package's byte model): the forward's
    xw read and out write, plus the residual writes when a residual
    backward consumes them, plus — with ``bwd='kernel'`` — the backward's
    streams. ``resident_bytes_per_device`` is the weights' one read per
    call. The hoisted and epilogue products are not counted."""
    wbytes = (P * 4 * H + H * P) * w_itemsize          # w_h + w_proj
    stream = T * B * (4 * H + P) * x_itemsize
    resident = wbytes
    if bwd in ("kernel", "scan"):
        stream += T * B * (4 * H + H) * x_itemsize     # gates + c traj
    if bwd == "kernel":
        stream += T * B * (P * g_itemsize              # g read
                           + 4 * H * x_itemsize        # gates read
                           + 2 * H * x_itemsize        # c + c_prev
                           + 4 * H * x_itemsize        # d_xw write
                           + P * 4)                    # dh_total write
        resident += wbytes
    return {"stream_bytes": int(stream),
            "resident_bytes_per_device": int(resident)}


def pass_flops(T, B, H, P) -> int:
    """Operations of one pass of the recurrence (forward or backward):
    the projection of every step and the gates product of every step but
    one (the forward's at t = 0, where h_0 = 0; the backward's at t = 0,
    whose dh no earlier step reads)."""
    return 2 * B * ((T - 1) * P * 4 * H + T * H * P)


__all__ = ["lstm_scan", "lstm_scan_reference", "lstm_recurrence",
           "fwd_route", "bwd_route", "FwdRoute", "f32_smem_bytes",
           "lstm_recurrence_plain", "lstm_bwd_recurrence",
           "lstm_bwd_recurrence_plain", "kernel_hbm_bytes", "pass_flops",
           "trace_records", "reset_trace_records"]
