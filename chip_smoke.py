#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (PATH or /usr/local/cuda/bin) and
``nvidia-smi``, and imports nothing of JAX or of the JAX package. It
exits non-zero, without printing a result, on any failure, on a
machine without CUDA, and when the ``parallax_tpu_torch`` package is not
beside it. Phases:

1. Build every CUDA kernel from ``parallax_tpu_torch/csrc/`` (one nvcc
   per source, started together) and print the card's name and power
   limit.
2. Kernel check: each kernel's wrapper against its plain PyTorch version
   on the card, at the serving path's shapes and at the cases below, in
   fp32 (TF32 off; atol 2e-5) and bf16 (atol 2e-2 x the plain output's
   peak magnitude); each timed with CUDA events (warmup, then the
   median of 20 runs; the paged kernel and its plain version after an
   L2 flush, as a decode step finds the pool) beside the plain version,
   the one library call
   that computes the same function where there is one
   (``scaled_dot_product_attention`` for the flash forward), and the
   bound from the H100 SXM data sheet.
3. Serve: NMT at its published widths (``NMTConfig()``: vocab 32000,
   model 512, 8 heads, MLP 2048, 6+6 layers, bf16, flash encoder
   attention) with random weights from a fixed seed, behind
   ``ServeSession(program=NMTDecodeProgram(..., attn_impl="kernel"))``
   with 64 slots; 256 requests. Every launch counter is zeroed just
   before and read just after; each must equal the scheduler's own
   count of prefills / decode steps times the 6 layers (plus the
   warmup's one of each). Then 64 of the requests again under the
   profiler, for the device's busy share and the kernels that take
   the time.
4. Agreement: 32 of the same requests served in fp32 (TF32 off) and
   compared, request by request, with the standalone ``greedy_decode``
   of the plain path (dense cache, plain attention, no kernel).
5. LSTM kernels (B1 forward, B2 forward with residuals, B3 backward)
   against their plain versions at the training shape (T 20, B 128,
   H 2048, P 512) and one ragged shape, in bf16 (atol 2e-2 of the plain
   peak) and fp32 with TF32 off (atol 1e-4 of max(1, plain peak)); each
   timed beside the plain version, cuDNN's ``torch.nn.LSTM`` with the
   same projection (which also runs the input projection the kernels
   leave to the hoisted matmul) and the bound.
6. Train: LM1B at its published widths (``LM1BConfig()``: vocab 793470
   padded to 793472 for 8 partitions, emb 512, hidden 2048, proj 512,
   8192 sampled candidates, keep_prob 0.9, bf16 compute, fp32 tables)
   through ``parallel_run(..., Config(run_option="HYBRID",
   sparse_grad_mode="slices"))`` with ``lstm_impl="kernel"``, random
   weights from seed 0: 5 warmup and 30 timed steps over 4 cycled
   batches of 128 x 20, words/sec and step ms, then one held-out
   no-grad loss. The LSTM counters are zeroed before and read after:
   B2 and B3 once per step, B1 none until the held-out loss, then once.
   Losses finite and falling; the padded vocab rows untouched. Then 5
   steps under the profiler.
7. Train agreement: 3 steps in fp32 (TF32 off, keep_prob 1) from the
   same weights and generator with ``lstm_impl="kernel"`` and
   ``"scan"``; per-step losses within 1e-4 relative.
8. NMT training: ``NMTConfig(use_pallas_attention=True, max_len=64,
   warmup_steps=10)`` at its published widths (vocab 32000, model 512,
   8 heads, MLP 2048, 6+6 layers, bf16) through ``parallel_run(...,
   Config(run_option="HYBRID"))``, random weights from seed 0: 5 warmup
   and 30 timed steps over 4 cycled batches of 64 x 64 x 64 tokens
   (``make_batch``, each source row padded after a length drawn in
   [16, 64]), target words/sec and step ms. The flash counters are
   zeroed before and read after: the forward, dq and dk/dv kernels 18
   times a step each (6 encoder self, 6 decoder causal self, 6 cross
   attentions), the paged kernel none. Losses finite and falling; the
   classifier finds ``emb`` alone sparse. Then 5 steps under the
   profiler.
9. NMT train agreement: 3 steps in fp32 (TF32 off) from the same weights
   through the flash kernels and through the plain attention with
   autograd; per-step losses within 1e-4 relative.

Phase 2 also holds the flash backward (B5 dq, B6 dk/dv) against its
plain versions at the three training attentions, at T 512 (causal and
not), hd 128, a ragged Tq 100 / Tk 37, a batch that sees no key (exact
zero gradients) and an lse cotangent, in fp32 (atol 2e-5 of max(1,
peak)) and bf16; each timed beside the plain version, the bound and
``scaled_dot_product_attention``'s backward (its forward plus backward
less its forward).

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, error, times and bound. The whole
record is also written to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0
# H100 SXM data sheet (dense): device memory 3.35 TB/s; 989 TF/s bf16 on
# the tensor cores; 67 TF/s fp32 outside them
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
FP32_ATOL = 2e-5
BF16_REL = 2e-2
REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing -----------------------------------------------------------------


def time_ms(torch, fn, reps: int = REPS, per_round: int = 10,
            warmup: int = 3, flush=None) -> float:
    """Median over ``reps`` rounds of the device milliseconds per call
    of ``fn``, measured between two CUDA events.

    Without ``flush`` each round is ``per_round`` back-to-back calls: the
    inputs stay in the L2 cache, and a call too small to cover its own
    launch measures the launch rate, which is what a caller pays for it.
    With ``flush`` (a buffer well past the 50 MB L2 cache) each round
    first overwrites the buffer and then times one call. The call then
    finds its inputs cold in device memory, as it does on the serving path.
    The overwrite keeps the device busy while the host issues the call,
    so no launch gap is timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    calls = per_round if flush is None else 1
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(torch, fn, kernel_name: str, calls: int = 10):
    """Mean device time of the CUDA kernel named ``kernel_name`` per
    call of ``fn``, from the profiler's CUDA activity (None when the
    profiler records no such kernel)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel_name in evt.key:
            total_us += getattr(evt, "device_time_total",
                                getattr(evt, "cuda_time_total", 0.0))
            count += evt.count
    return total_us / count / 1e3 if count else None


def bound(bytes_moved: int, ops: int, dtype_name: str):
    """(bound_ms, bound_by): the larger of the bytes over the memory
    rate and the operations over the peak rate for the dtype."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, dtype):
    """(max_abs_err, tolerance) of a kernel result against its plain
    version: atol 2e-5 in fp32, 2e-2 of the plain peak in bf16."""
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        return err, FP32_ATOL
    return err, BF16_REL * max(want.float().abs().max().item(), 1e-6)


# -- phase 1 ----------------------------------------------------------------


def phase_build(torch):
    from parallax_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    seconds = _cuda.build()
    log(f"[build] {json.dumps(seconds)} (wall "
        f"{time.perf_counter() - t0:.2f}s)")
    for name in _cuda.KERNEL_SOURCES:
        report = _cuda.library_path(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[ptxas {name}] {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")
    return card


# -- phase 2: the flash-attention forward ------------------------------------


def flash_cases():
    # (label, B, T, H, hd, causal, mask): "serve" is the encoder's
    # shape on the serving path (one padded 64-token source); "train_enc"
    # and "train_dec" are the NMT training step's (64 x 64 tokens: the
    # encoder and cross attentions with the source pad mask, the decoder
    # causal self-attention)
    return [("serve", 1, 64, 8, 64, False, "tail"),
            ("masked_row", 2, 64, 8, 64, False, "row"),
            ("t512", 8, 512, 8, 64, False, None),
            ("t512_causal", 8, 512, 8, 64, True, None),
            ("train_enc", 64, 64, 8, 64, False, "pad"),
            ("train_dec", 64, 64, 8, 64, True, None)]


def make_mask(torch, kind, B, Tk):
    """kv_mask [B, Tk] int32: "tail" pads batch 0 after 40 tokens, "row"
    also masks every key of batch 1; "pad" gives each row a length drawn
    in [16, Tk] (numpy seed 0), "zero" also masks every key of batch 1."""
    if kind is None:
        return None
    if kind in ("tail", "row"):
        mask = torch.ones((B, Tk), dtype=torch.int32, device=DEVICE)
        mask[0, 40:] = 0              # a padded source of 40 tokens
    else:
        lengths = np.random.default_rng(SEED).integers(min(16, Tk), Tk + 1,
                                                       B)
        mask = (torch.arange(Tk, device=DEVICE)[None, :] < torch.as_tensor(
            lengths, device=DEVICE)[:, None]).to(torch.int32)
    if kind in ("row", "zero"):
        mask[1] = 0                   # every query of batch 1 sees nothing
    return mask


def attended_pairs(torch, B, Tq, Tk, causal, mask):
    """The (batch, query, key) pairs the inputs let attend: the work a
    kernel that skips nothing it needs must do."""
    ok = torch.ones((B, Tq, Tk), dtype=torch.bool, device=DEVICE)
    if causal:
        ok &= torch.ones((Tq, Tk), dtype=torch.bool, device=DEVICE).tril()
    if mask is not None:
        ok &= (mask > 0)[:, None, :]
    return int(ok.sum().item())


def run_flash_case(torch, case, dtype):
    import torch.nn.functional as F

    from parallax_tpu_torch.ops import flash_attention as fa
    label, B, T, H, hd, causal, mask_kind = case
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    q, k, v = (torch.randn((B, T, H, hd), generator=g, device=DEVICE,
                           dtype=dtype) for _ in range(3))
    mask = make_mask(torch, mask_kind, B, T)
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal, kv_mask=mask)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            kv_mask=mask)
    torch.cuda.synchronize()
    err, tol = compare(torch, out, ref, dtype)
    live = torch.ones((B,), dtype=torch.bool, device=DEVICE)
    if mask is not None:
        live = mask.sum(dim=1) > 0
    lse_err = (lse[live] - ref_lse[live]).abs().max().item()
    lse_tol = FP32_ATOL if dtype == torch.float32 else \
        1e-2 * max(ref_lse[live].abs().max().item(), 1.0)
    ok = err <= tol and lse_err <= lse_tol
    if not live.all():
        dead = ~live
        ok = ok and bool((out[dead] == 0).all()) \
            and bool((lse[dead] < -1e29).all())
    scale = 1.0 / math.sqrt(hd)
    kernel_ms = time_ms(torch, lambda: fa.flash_attention_lse(
        q, k, v, causal=causal, kv_mask=mask))
    kernel_device_ms = device_ms(torch, lambda: fa.flash_attention_lse(
        q, k, v, causal=causal, kv_mask=mask), "flash_fwd_kernel")
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal=causal, kv_mask=mask))
    attn_mask = None if mask is None else \
        (mask > 0)[:, None, None, :].expand(B, H, T, T)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=attn_mask, is_causal=causal, scale=scale))
    itemsize = q.element_size()
    bytes_moved = (4 * B * T * H * hd * itemsize + B * H * T * 4
                   + (0 if mask is None else B * T * 4))
    pairs = attended_pairs(torch, B, T, T, causal, mask)
    bound_ms, bound_by = bound(bytes_moved, 4 * H * hd * pairs,
                               str(dtype).split(".")[-1])
    return {"kernel": "flash_attention_fwd", "case": label,
            "dtype": str(dtype).split(".")[-1],
            "shape": {"B": B, "T": T, "H": H, "hd": hd, "causal": causal,
                      "mask": mask_kind},
            "ok": ok, "max_abs_err": err, "tol": tol,
            "lse_max_abs_err": lse_err, "ms": kernel_ms,
            "device_ms": kernel_device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# -- phase 2: the paged-decode attention --------------------------------------


def paged_cases():
    from parallax_tpu_torch.ops.paged_attention import FLAGSHIP_DECODE as F
    # (label, S, G, D, heads, page_size, P, pool_pages, occupancy);
    # "serve" is the decode step of the serving path below
    out = [("serve", 64, 1, 512, 8, 16, 8, 512, None)]
    for G in (1, 3):
        for occ in (1.0, 0.25):
            out.append((f"flagship_g{G}_occ{int(occ * 100)}", F["S"], G,
                        F["D"], F["num_heads"], F["page_size"], F["P"],
                        F["pool_pages"], occ))
    return out


def _paged_tables(case, rng):
    """Page table and positions: ``occupancy`` of each slot's table
    live (the flagship cases, slot 0 holding no page at all), or, for
    the serving shape, each slot owning the pages of a random cap with
    its frontier somewhere inside them."""
    label, S, G, D, H, ps, P, pool_pages, occ = case
    pages = np.full((S, P), pool_pages, np.int32)
    pos = np.zeros((S, G), np.int32)
    perm = rng.permutation(pool_pages)
    nxt = 0
    for s in range(S):
        if occ is None:
            cap = int(rng.integers(32, P * ps + 1))
            n = -(-cap // ps)
            last = int(rng.integers(G - 1, cap))
        else:
            n = 0 if s == 0 else int(P * occ)
            last = max(n * ps - 1, G - 1)
        pages[s, :n] = perm[nxt:nxt + n]
        nxt += n
        pos[s] = last - (G - 1) + np.arange(G)
    return pages, pos


def run_paged_case(torch, case, dtype, flush):
    from parallax_tpu_torch.ops import paged_attention as pa
    label, S, G, D, H, ps, P, pool_pages, occ = case
    rng = np.random.default_rng(SEED)
    pages_np, pos_np = _paged_tables(case, rng)
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    q = torch.randn((S, G, D), generator=g, device=DEVICE, dtype=dtype)
    # the port's pool layout: one spare page past pool_pages
    kp = torch.randn((pool_pages + 1, ps, D), generator=g, device=DEVICE,
                     dtype=dtype)
    vp = torch.randn((pool_pages + 1, ps, D), generator=g, device=DEVICE,
                     dtype=dtype)
    pages = torch.from_numpy(pages_np).to(DEVICE)
    pos = torch.from_numpy(pos_np).to(DEVICE)
    kw = dict(num_heads=H, page_size=ps, pool_pages=pool_pages)
    out = pa.paged_decode_attention(q, kp, vp, pages, pos, **kw)
    ref = pa.paged_decode_attention_plain(q, kp, vp, pages, pos, **kw)
    torch.cuda.synchronize()
    err, tol = compare(torch, out, ref, dtype)
    ok = err <= tol and bool(torch.isfinite(out).all())
    if occ is not None:
        ok = ok and bool((out[0] == 0).all())   # the slot with no page
    # a decode step reaches each layer's pool after the other layers'
    # pools and weights went through the cache, so both versions are
    # timed cold
    kernel_ms = time_ms(torch, lambda: pa.paged_decode_attention(
        q, kp, vp, pages, pos, **kw), flush=flush)
    warm_ms = time_ms(torch, lambda: pa.paged_decode_attention(
        q, kp, vp, pages, pos, **kw))
    kernel_device_ms = device_ms(torch, lambda: pa.paged_decode_attention(
        q, kp, vp, pages, pos, **kw), "paged_decode_kernel")
    plain_ms = time_ms(torch, lambda: pa.paged_decode_attention_plain(
        q, kp, vp, pages, pos, **kw), flush=flush)
    # what this run's data needs: every live position some query of its
    # slot sees (the kernel reads nothing else), q and out once
    live = pages_np < pool_pages
    visible_pages = 0
    visible_positions = 0
    for s in range(S):
        frontier = int(pos_np[s].max())
        visible_pages += int(live[s, :frontier // ps + 1].sum())
        for g_ in range(G):
            tpos = np.arange(P * ps)
            visible_positions += int(
                (np.repeat(live[s], ps) & (tpos <= pos_np[s, g_])).sum())
    itemsize = q.element_size()
    nbytes = pa.kernel_hbm_bytes(S, G, D, ps, visible_pages,
                                 itemsize)["total_bytes"] \
        + pages_np.nbytes + pos_np.nbytes
    bound_ms, bound_by = bound(nbytes, 4 * D * visible_positions,
                               str(dtype).split(".")[-1])
    return {"kernel": "paged_decode_attention", "case": label,
            "dtype": str(dtype).split(".")[-1],
            "shape": {"S": S, "G": G, "D": D, "heads": H, "page_size": ps,
                      "P": P, "pool_pages": pool_pages,
                      "occupancy": occ, "live_pages": visible_pages},
            "ok": ok, "max_abs_err": err, "tol": tol, "ms": kernel_ms,
            "warm_ms": warm_ms, "device_ms": kernel_device_ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_kernels(torch):
    # overwritten before each cold timing: 512 MiB, ten times the L2
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=DEVICE)
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in flash_cases():
            results.append(run_flash_case(torch, case, dtype))
        for case in paged_cases():
            results.append(run_paged_case(torch, case, dtype, flush))
    del flush
    for r in results:
        warm = f" cold, {r['warm_ms']:.4f} ms warm" if "warm_ms" in r \
            else ""
        log(f"[kernel] {r['kernel']} {r['case']} {r['dtype']}: "
            f"{'ok' if r['ok'] else 'FAILED'} err {r['max_abs_err']:.3g} "
            f"(tol {r['tol']:.3g}) kernel {r['ms']:.4f} ms{warm} (device "
            f"{r['device_ms']} ms) plain "
            f"{r['plain_ms']:.4f} ms library {r['library_ms']} ms bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return results


# -- phase 2: the flash-attention backward -----------------------------------


def flash_bwd_cases():
    # (label, B, Tq, Tk, H, hd, causal, mask, lse cotangent): "train_*" are
    # the NMT training step's three attentions at full width
    return [("train_enc", 64, 64, 64, 8, 64, False, "pad", False),
            ("train_dec", 64, 64, 64, 8, 64, True, None, False),
            ("train_cross", 64, 64, 64, 8, 64, False, "pad", False),
            ("t512", 8, 512, 512, 8, 64, False, None, False),
            ("t512_causal", 8, 512, 512, 8, 64, True, None, False),
            ("hd128", 4, 256, 256, 4, 128, True, "pad", False),
            ("ragged", 2, 100, 37, 8, 64, False, "pad", False),
            ("zero_mask", 4, 64, 64, 8, 64, False, "zero", False),
            ("lse_cotangent", 8, 128, 128, 8, 64, True, None, True)]


def grad_compare(torch, got, want, dtype):
    """(max_abs_err, tolerance) of a gradient against its plain version:
    atol 2e-5 of max(1, peak) in fp32 (a gradient sums over the whole
    sequence), 2e-2 of the plain peak in bf16."""
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    if dtype == torch.float32:
        return err, FP32_ATOL * max(1.0, peak)
    return err, BF16_REL * max(peak, 1e-6)


def sdpa_backward_ms(torch, q, k, v, dout, mask, causal, scale):
    """``scaled_dot_product_attention``'s forward plus backward, less its
    forward, with the same mask: the library yardstick of the flash
    backward (it computes dq, dk and dv together). Timed here only."""
    import torch.nn.functional as F
    B, Tq, H, _ = q.shape
    Tk = k.shape[1]
    attn_mask, is_causal = None, causal
    if mask is not None:
        attn_mask = (mask > 0)[:, None, None, :].expand(B, H, Tq, Tk)
        if causal:
            attn_mask = attn_mask & torch.ones(
                (Tq, Tk), dtype=torch.bool, device=DEVICE).tril()
            is_causal = False
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gt = dout.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=attn_mask, is_causal=is_causal,
            scale=scale)

    fwd_ms = time_ms(torch, fwd, reps=10, per_round=5)
    fb_ms = time_ms(torch, lambda: torch.autograd.grad(fwd(), (qt, kt, vt),
                                                       gt),
                    reps=10, per_round=5)
    return max(fb_ms - fwd_ms, 0.0)


def run_flash_bwd_case(torch, case, dtype):
    from parallax_tpu_torch.ops import flash_attention as fa
    label, B, Tq, Tk, H, hd, causal, mask_kind, with_dlse = case
    g = torch.Generator(device=DEVICE).manual_seed(SEED)

    def r(shape):
        return torch.randn(shape, generator=g, device=DEVICE, dtype=dtype)
    q, k, v = r((B, Tq, H, hd)), r((B, Tk, H, hd)), r((B, Tk, H, hd))
    dout = r((B, Tq, H, hd))
    dlse = torch.randn((B, H, Tq), generator=g, device=DEVICE) \
        if with_dlse else None
    mask = make_mask(torch, mask_kind, B, Tk)
    scale = 1.0 / math.sqrt(hd)
    # both versions take the same out and lse (the plain forward's)
    out, lse = fa.flash_attention_plain(q, k, v, causal, scale, mask)
    delta = fa.flash_delta(out, dout, dlse)
    args = (q, k, v, mask, dout, lse, delta, causal, scale)
    got = {"flash_attention_dq": (fa.flash_dq(*args),),
           "flash_attention_dkv": fa.flash_dkv(*args)}
    want = {"flash_attention_dq": (fa.flash_dq_plain(*args),),
            "flash_attention_dkv": fa.flash_dkv_plain(*args)}
    torch.cuda.synchronize()
    library_ms = sdpa_backward_ms(torch, q, k, v, dout, mask, causal, scale)
    pairs = attended_pairs(torch, B, Tq, Tk, causal, mask)
    itemsize = q.element_size()
    in_bytes = ((2 * B * Tq + 2 * B * Tk) * H * hd * itemsize
                + 2 * B * H * Tq * 4
                + (0 if mask is None else B * Tk * 4))
    calls = {
        "flash_attention_dq": (lambda: fa.flash_dq(*args),
                               lambda: fa.flash_dq_plain(*args),
                               "flash_dq_kernel", 3,
                               B * Tq * H * hd * itemsize),
        "flash_attention_dkv": (lambda: fa.flash_dkv(*args),
                                lambda: fa.flash_dkv_plain(*args),
                                "flash_dkv_kernel", 4,
                                2 * B * Tk * H * hd * itemsize),
    }
    results = []
    for name, (kernel, plain, kname, products, out_bytes) in calls.items():
        errs = [grad_compare(torch, a, e, dtype)
                for a, e in zip(got[name], want[name])]
        ok = all(err <= tol for err, tol in errs) and all(
            bool(torch.isfinite(a.float()).all()) for a in got[name])
        if mask_kind == "zero":
            # batch 1 sees no key: its gradients are exact zeros
            ok = ok and all(bool((a[1] == 0).all()) for a in got[name])
        bound_ms, bound_by = bound(in_bytes + out_bytes,
                                   products * 2 * H * hd * pairs,
                                   str(dtype).split(".")[-1])
        results.append({
            "kernel": name, "case": label, "dtype": str(dtype).split(".")[-1],
            "shape": {"B": B, "Tq": Tq, "Tk": Tk, "H": H, "hd": hd,
                      "causal": causal, "mask": mask_kind,
                      "lse_cotangent": with_dlse, "pairs": pairs},
            "ok": ok, "max_abs_err": max(e for e, _ in errs),
            "tol": min(t for _, t in errs),
            "ms": time_ms(torch, kernel),
            "device_ms": device_ms(torch, kernel, kname),
            "plain_ms": time_ms(torch, plain, reps=5, per_round=2),
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention backward (dq, dk, dv)",
            "bound_ms": bound_ms, "bound_by": bound_by})
    return results


def phase_flash_bwd_kernels(torch):
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in flash_bwd_cases():
            results.extend(run_flash_bwd_case(torch, case, dtype))
    for r in results:
        log(f"[kernel] {r['kernel']} {r['case']} {r['dtype']}: "
            f"{'ok' if r['ok'] else 'FAILED'} err {r['max_abs_err']:.3g} "
            f"(tol {r['tol']:.3g}) kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']} ms) plain {r['plain_ms']:.4f} ms SDPA bwd "
            f"{r['library_ms']:.4f} ms bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")
    return results


# -- phase 3: serve ---------------------------------------------------------


def make_requests(n: int, rng, vocab: int, max_src_len: int = 64,
                  max_len: int = 128):
    """Sources of length uniform in [16, max_src_len], tokens uniform
    in [3, vocab), token caps uniform in [32, max_len]."""
    return [(rng.integers(3, vocab, (int(rng.integers(16, max_src_len + 1)),))
             .astype(np.int32), int(rng.integers(32, max_len + 1)))
            for _ in range(n)]


# the serving configuration: 64 slots over a 512-page pool of 16-token
# pages, sources padded to 64 tokens, at most 128 tokens per request
SERVE = dict(max_src_len=64, max_len=128, page_size=16, pool_pages=512,
             max_batch=64, max_queue=512)


def serve(torch, cfg, params, requests):
    import parallax_tpu_torch as pt
    prog = pt.NMTDecodeProgram(
        cfg, max_src_len=SERVE["max_src_len"], max_len=SERVE["max_len"],
        page_size=SERVE["page_size"], pool_pages=SERVE["pool_pages"],
        attn_impl="kernel", device=DEVICE)
    sess = pt.ServeSession(
        program=prog, params=params, device=DEVICE,
        config=pt.Config(serve_config=pt.ServeConfig(
            max_batch=SERVE["max_batch"], max_queue=SERVE["max_queue"])))
    t0 = time.perf_counter()
    try:
        reqs = [sess.submit({"src": src}, max_new_tokens=cap)
                for src, cap in requests]
        outs = []
        for r in reqs:
            outs.append(r.result(timeout=900))
        wall = time.perf_counter() - t0
    finally:
        sess.close()
    return outs, wall, sess.stats()


def check_outputs(requests, outs, vocab):
    for (src, cap), out in zip(requests, outs):
        if out.ndim != 1 or not 1 <= len(out) <= cap:
            raise AssertionError(f"bad output length {out.shape} for cap "
                                 f"{cap}")
        if out.min() < 0 or out.max() >= vocab:
            raise AssertionError(f"token out of range [0, {vocab})")
        if len(out) < cap and out[-1] != 2:
            raise AssertionError("a request stopped early without EOS")


def phase_serve(torch, cfg, requests):
    from parallax_tpu_torch.models import nmt
    from parallax_tpu_torch.ops import flash_attention as fa
    from parallax_tpu_torch.ops import paged_attention as pa
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = nmt.init_params(cfg, g, device=DEVICE)
    torch.cuda.synchronize()
    fa.launches = 0
    pa.launches = 0
    outs, wall, stats = serve(torch, cfg, params, requests)
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": fa.launches,
                "paged_decode_attention": pa.launches}
    check_outputs(requests, outs, cfg.vocab_size)
    L = cfg.num_layers
    want = {"flash_attention_fwd": (stats["serve.prefills"] + 1) * L,
            "paged_decode_attention":
                (stats["serve.decode_steps"] + 1) * L}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != scheduler "
                             f"counts {want}")
    if stats["serve.kv_pages_in_use"] != 0:
        raise AssertionError(f"{stats['serve.kv_pages_in_use']} KV pages "
                             f"leaked after close")
    if stats["serve.completed"] != len(requests):
        raise AssertionError(f"{stats['serve.completed']} of "
                             f"{len(requests)} requests completed")
    tokens = int(sum(len(o) for o in outs))
    summary = {"requests": len(requests), "tokens": tokens,
               "wall_s": wall, "tokens_per_sec": tokens / wall,
               "ttft_ms_p50": stats["serve.ttft_ms"]["p50"],
               "ttft_ms_p95": stats["serve.ttft_ms"]["p95"],
               "step_ms_p50": stats["serve.step_ms"]["p50"],
               "step_ms_p95": stats["serve.step_ms"]["p95"],
               "decode_steps": stats["serve.decode_steps"],
               "prefills": stats["serve.prefills"],
               "kv_refill_deferred": stats["serve.kv_refill_deferred"],
               "launches": launches}
    log(f"[serve] {json.dumps(summary)}")
    return params, summary


def phase_profile(torch, cfg, params, requests):
    """Where a serve run's time goes: the same serving stack under the
    profiler's CUDA activity (kernels, copies and fills, from CUPTI),
    with the device's busy time summed over the window's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(torch, cfg, params, requests)
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total",
                     getattr(evt, "cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, evt.count, evt.key))
    busy_s = sum(us for us, _, _ in rows) / 1e6
    rows.sort(reverse=True)
    summary = {"requests": len(requests), "window_s": window,
               "device_busy_s": busy_s,
               "device_idle_share": 1.0 - busy_s / window,
               "top": [{"name": key[:90], "calls": n, "ms": us / 1e3,
                        "share_of_busy": us / 1e6 / busy_s}
                       for us, n, key in rows[:10]]}
    log(f"[profile] {json.dumps(summary)}")
    return summary


# -- phase 4: fp32 agreement --------------------------------------------------


def top2_gap(torch, params, cfg, src, position):
    """The plain path's top-2 logit gap and the two tokens at decode
    ``position`` of one request (its own greedy prefix fed back)."""
    from parallax_tpu_torch.models import nmt
    src_t = torch.as_tensor(src[None], device=DEVICE).long()
    enc, valid = nmt._encode(cfg, params, src_t)
    ck, cv = nmt._cross_kv(cfg, params, enc)
    kc, vc = nmt._init_self_cache(cfg, 1, position + 1, DEVICE)
    tok = torch.full((1,), nmt.BOS_ID, device=DEVICE, dtype=torch.long)
    for t in range(position + 1):
        logits, kc, vc = nmt._decode_step_cached_multi(
            cfg, params, tok, torch.full((1,), t, dtype=torch.int32,
                                         device=DEVICE),
            kc, vc, ck, cv, valid)
        tok = logits.argmax(dim=-1)
    top = logits[0].topk(2)
    return (top.values[0] - top.values[1]).item(), top.indices.tolist()


def phase_agreement(torch, params, cfg_bf16, requests):
    from parallax_tpu_torch.models import nmt
    cfg = dataclasses.replace(cfg_bf16, compute_dtype=torch.float32)
    ref_cfg = dataclasses.replace(cfg, use_pallas_attention=False)
    outs, _, stats = serve(torch, cfg, params, requests)
    check_outputs(requests, outs, cfg.vocab_size)
    mismatches = []
    for i, ((src, cap), out) in enumerate(zip(requests, outs)):
        ref = nmt.greedy_decode(params, ref_cfg, src[None],
                                max_len=cap)[0].cpu().numpy()
        eos = np.flatnonzero(ref == nmt.EOS_ID)
        if eos.size:
            ref = ref[:eos[0] + 1]
        if len(ref) == len(out) and np.array_equal(ref, out):
            continue
        n = min(len(ref), len(out))
        first = int(np.flatnonzero(ref[:n] != out[:n])[0]) if \
            not np.array_equal(ref[:n], out[:n]) else n
        gap, top2 = top2_gap(torch, params, ref_cfg, src, first)
        mismatches.append({"request": i, "position": first,
                           "top2_gap": gap, "top2_tokens": top2})
        lo = max(first - 3, 0)
        log(f"[agree] request {i}: first difference at position {first}, "
            f"plain top-2 logit gap {gap:.3g} between tokens {top2}; "
            f"tokens {lo}..{first}: served {out[lo:first + 1].tolist()}, "
            f"plain {ref[lo:first + 1].tolist()}")
        if not gap <= 1e-3:               # NaN fails too
            raise AssertionError(
                f"request {i} differs at position {first} where the plain "
                f"path's top-2 gap is {gap:.3g} > 1e-3")
    summary = {"requests": len(requests), "identical":
               len(requests) - len(mismatches), "near_ties": mismatches,
               "kv_pages_in_use": stats["serve.kv_pages_in_use"]}
    if stats["serve.kv_pages_in_use"] != 0:
        raise AssertionError("KV pages leaked in the agreement phase")
    log(f"[agree] {json.dumps(summary)}")
    return summary


# -- phase 5: the LSTM kernels ------------------------------------------------

LSTM_FP32_TOL = 1e-4
# kernel names of each LSTM op, for its device time in the profiler
LSTM_KERNELS = {"lstm_fwd": ("lstm_gates_kernel", "lstm_proj_"),
                "lstm_fwd_res": ("lstm_gates_kernel", "lstm_proj_"),
                "lstm_bwd": ("lstm_bwd_", "Memcpy")}


def device_ms_per_call(torch, fn, names, calls: int = 5):
    """Device milliseconds per call of ``fn`` summed over every CUDA
    activity whose name holds one of ``names`` (None when the profiler
    records none)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if any(n in evt.key for n in names):
            total_us += getattr(evt, "device_time_total",
                                getattr(evt, "cuda_time_total", 0.0))
    return total_us / calls / 1e3 if total_us else None


def lstm_cases():
    # (label, T, B, E, H, P): "train" is the LM1B flagship per-card shape
    # (bench.py:420); "ragged" puts B, H and P off every tile
    return [("train", 20, 128, 512, 2048, 512),
            ("ragged", 7, 100, 200, 1000, 300)]


def lstm_close(torch, got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    tol = LSTM_FP32_TOL * max(1.0, peak) if dtype == torch.float32 \
        else BF16_REL * max(peak, 1e-6)
    return err, tol


def cudnn_lstm(torch, x, w, b, w_proj):
    """``torch.nn.LSTM`` (cuDNN) with the same weights: the same gate
    order i|f|g|o, the forget +1 folded into ``bias_hh``. It runs the
    input projection too, which the kernels leave to the hoisted
    matmul."""
    E, H4 = w.shape[0] - w_proj.shape[1], w.shape[1]
    H, P = w_proj.shape
    mod = torch.nn.LSTM(E, H, proj_size=P).to(device=DEVICE, dtype=x.dtype)
    with torch.no_grad():
        mod.weight_ih_l0.copy_(w[:E].t())
        mod.weight_hh_l0.copy_(w[E:].t())
        mod.bias_ih_l0.copy_(b)
        forget = torch.zeros(H4, dtype=x.dtype, device=DEVICE)
        forget[H:2 * H] = 1.0
        mod.bias_hh_l0.copy_(forget)
        mod.weight_hr_l0.copy_(w_proj.t())
    mod.flatten_parameters()    # one weight buffer, as cuDNN wants it
    return mod


def run_lstm_case(torch, case, dtype):
    from parallax_tpu_torch.ops import lstm
    label, T, B, E, H, P = case
    g = torch.Generator(device=DEVICE).manual_seed(SEED)

    def r(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=g, device=DEVICE)
                * scale).to(dt)
    x = r((T, B, E), 1.0)
    w = r((E + P, 4 * H), 1.0 / math.sqrt(E + P))
    b = r((4 * H,), 0.1)
    w_proj = r((H, P), 1.0 / math.sqrt(H))
    gout = r((T, B, P), 1.0, torch.float32)
    w_x, w_h = lstm._split_w(w, w_proj)
    xw = lstm._hoisted_xw(x, w_x, b)
    ref = lstm.lstm_recurrence_plain(xw, w_h, w_proj, residuals=True)
    outs = {
        "lstm_fwd": (lambda: lstm.lstm_recurrence(xw, w_h, w_proj),
                     lambda: lstm.lstm_recurrence_plain(xw, w_h, w_proj)),
        "lstm_fwd_res": (
            lambda: lstm.lstm_recurrence(xw, w_h, w_proj, residuals=True),
            lambda: lstm.lstm_recurrence_plain(xw, w_h, w_proj,
                                               residuals=True)),
        "lstm_bwd": (
            lambda: lstm.lstm_bwd_recurrence(gout, ref[1], ref[2], w_h,
                                             w_proj),
            lambda: lstm.lstm_bwd_recurrence_plain(gout, ref[1], ref[2],
                                                   w_h, w_proj)),
    }
    # cuDNN: the forward with autograd on (B1's and B2's yardstick) and
    # the forward plus backward, less the forward (B3's)
    mod = cudnn_lstm(torch, x, w, b, w_proj)
    xg = x.clone().requires_grad_()
    lib_fwd = time_ms(torch, lambda: mod(xg), reps=5, per_round=3)
    lib_fb = time_ms(torch, lambda: torch.autograd.backward(
        mod(xg)[0], gout.to(dtype)), reps=5, per_round=3)
    library = {"lstm_fwd": lib_fwd, "lstm_fwd_res": lib_fwd,
               "lstm_bwd": max(lib_fb - lib_fwd, 0.0)}
    del mod, xg
    xs, ws = x.element_size(), w.element_size()
    flops = lstm.pass_flops(T, B, H, P)
    kb = {k: lstm.kernel_hbm_bytes(T, B, E, H, P, xs, ws, bwd=k)
          for k in ("recompute", "scan", "kernel")}
    wbytes = kb["recompute"]["resident_bytes_per_device"]
    nbytes = {"lstm_fwd": kb["recompute"]["stream_bytes"] + wbytes,
              "lstm_fwd_res": kb["scan"]["stream_bytes"] + wbytes,
              "lstm_bwd": kb["kernel"]["stream_bytes"]
              - kb["scan"]["stream_bytes"] + wbytes}
    results = []
    for name, (kernel, plain) in outs.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = [lstm_close(torch, a, e, dtype) for a, e in zip(got, want)]
        ok = all(err <= tol for err, tol in errs) and all(
            bool(torch.isfinite(a.float()).all()) for a in got)
        err = max(e for e, _ in errs)
        tol = min(t for _, t in errs)
        bound_ms, bound_by = bound(nbytes[name], flops,
                                   str(dtype).split(".")[-1])
        results.append({
            "kernel": name, "case": label,
            "dtype": str(dtype).split(".")[-1],
            "shape": {"T": T, "B": B, "E": E, "H": H, "P": P},
            "ok": ok, "max_abs_err": err, "tol": tol,
            "errs": [e for e, _ in errs],
            "ms": time_ms(torch, kernel, reps=10, per_round=3),
            "device_ms": device_ms_per_call(torch, kernel,
                                            LSTM_KERNELS[name]),
            "plain_ms": time_ms(torch, plain, reps=3, per_round=1,
                                warmup=1),
            "library_ms": library[name], "library": "torch.nn.LSTM (cuDNN)",
            "bound_ms": bound_ms, "bound_by": bound_by})
    return results


def phase_lstm_kernels(torch):
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for case in lstm_cases():
            results.extend(run_lstm_case(torch, case, dtype))
    for r in results:
        log(f"[kernel] {r['kernel']} {r['case']} {r['dtype']}: "
            f"{'ok' if r['ok'] else 'FAILED'} err {r['max_abs_err']:.3g} "
            f"(tol {r['tol']:.3g}) kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']} ms) plain {r['plain_ms']:.4f} ms cuDNN "
            f"{r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    return results


# -- phase 6: LM1B training ---------------------------------------------------

TRAIN = dict(batch=128, num_steps=20, warmup=5, steps=30, profile_steps=5,
             num_partitions=8)
LSTM_COUNTERS = ("launches_fwd", "launches_fwd_res", "launches_bwd")


def lm1b_session(torch, lstm_impl="kernel", **cfg_kw):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import lm1b
    cfg = lm1b.LM1BConfig(num_partitions=TRAIN["num_partitions"],
                          sparse_grad_mode="slices", lstm_impl=lstm_impl,
                          **cfg_kw)
    sess, *_ = pt.parallel_run(
        lm1b.build_model(cfg),
        parallax_config=pt.Config(run_option="HYBRID",
                                  sparse_grad_mode="slices"),
        seed=SEED, device=DEVICE)
    return cfg, sess


def lm1b_batches(cfg):
    from parallax_tpu_torch.models import lm1b
    rng = np.random.default_rng(SEED)
    return [lm1b.make_batch(rng, TRAIN["batch"], TRAIN["num_steps"],
                            cfg.vocab_size) for _ in range(4)]


def padded_rows(sess, cfg):
    p = sess.state.params
    return {k: p[k][cfg.vocab_size:].clone()
            for k in ("emb", "softmax_w", "softmax_b")}


def phase_train(torch):
    from parallax_tpu_torch.ops import lstm
    torch.cuda.reset_peak_memory_stats()
    cfg, sess = lm1b_session(torch)
    batches = lm1b_batches(cfg)
    t_build = time.perf_counter()
    sess.prepare(batches[0])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    pad_before = padded_rows(sess, cfg)
    words_per_batch = [float(b["w"].sum()) for b in batches]
    torch.cuda.synchronize()
    for name in LSTM_COUNTERS:
        setattr(lstm, name, 0)
    losses = []
    for i in range(TRAIN["warmup"]):
        losses.append(sess.run("loss", feed_dict=batches[i % 4]))
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    t0 = time.perf_counter()
    words = 0.0
    feed = (batches[i % 4] for i in range(TRAIN["steps"]))
    for i, loss in enumerate(sess.run_iter(feed, fetches="loss")):
        losses.append(loss)
        words += words_per_batch[i % 4]
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    float(losses[-1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    in_train = {n: getattr(lstm, n) for n in LSTM_COUNTERS}
    held = float(sess.evaluate(batches[1]))
    torch.cuda.synchronize()
    launches = {"lstm_fwd": lstm.launches_fwd,
                "lstm_fwd_res": lstm.launches_fwd_res,
                "lstm_bwd": lstm.launches_bwd}
    steps_run = TRAIN["warmup"] + TRAIN["steps"]
    want = {"lstm_fwd": 1, "lstm_fwd_res": steps_run,
            "lstm_bwd": steps_run}
    if launches != want or in_train["launches_fwd"] != 0:
        raise AssertionError(f"LSTM launch counts {launches} (B1 during "
                             f"training {in_train['launches_fwd']}) != "
                             f"{want} with B1 0 during training")
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses + [held]):
        raise AssertionError(f"non-finite loss: {losses} held {held}")
    if not statistics.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"loss did not fall: first {losses[0]}, last "
                             f"five {losses[-5:]}")
    for k, v in padded_rows(sess, cfg).items():
        if not torch.equal(v, pad_before[k]):
            raise AssertionError(f"padded vocab rows of {k} changed")
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    summary = {
        "config": {"vocab": cfg.vocab_size, "padded_vocab": cfg.padded_vocab,
                   "emb": cfg.emb_dim, "hidden": cfg.hidden_dim,
                   "proj": cfg.proj_dim, "num_samples": cfg.num_samples,
                   "keep_prob": cfg.keep_prob, "compute": "bfloat16",
                   "batch": TRAIN["batch"], "num_steps": TRAIN["num_steps"]},
        "lm1b_words_per_sec_per_chip": words / wall,
        "timed_steps": TRAIN["steps"], "wall_s": wall,
        "step_ms_p50": statistics.median(step_ms),
        "step_ms_p95": step_ms[min(len(step_ms) - 1,
                                   int(math.ceil(0.95 * len(step_ms))) - 1)],
        "first_loss": losses[0], "last5_mean_loss":
            statistics.mean(losses[-5:]), "held_out_loss": held,
        "losses": losses, "engine_build_s": build_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}
    log(f"[train] {json.dumps({k: v for k, v in summary.items() if k != 'losses'})}")
    profile = profile_train(torch, sess, batches)
    sess.close()
    return summary, profile


def profile_train(torch, sess, batches, label="train-profile"):
    """Where a training step's time goes: ``profile_steps`` steps under
    the profiler's CUDA activity, the device's busy time over the
    window's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        last = None
        for i in range(TRAIN["profile_steps"]):
            last = sess.run("loss", feed_dict=batches[i % 4])
        float(last)
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total",
                     getattr(evt, "cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, evt.count, evt.key))
    busy_s = sum(us for us, _, _ in rows) / 1e6
    rows.sort(reverse=True)
    summary = {"steps": TRAIN["profile_steps"], "window_s": window,
               "device_busy_s": busy_s,
               "device_idle_share": 1.0 - busy_s / window,
               "device_launches_per_step": sum(n for _, n, _ in rows)
               / TRAIN["profile_steps"],
               "top": [{"name": key[:90], "calls": n, "ms": us / 1e3,
                        "share_of_busy": us / 1e6 / busy_s}
                       for us, n, key in rows[:12]]}
    log(f"[{label}] {json.dumps(summary)}")
    return summary


# -- phase 7: kernel vs plain scan, fp32 --------------------------------------


def phase_train_agreement(torch):
    losses = {}
    for impl in ("kernel", "scan"):
        cfg, sess = lm1b_session(torch, lstm_impl=impl,
                                 compute_dtype=torch.float32, keep_prob=1.0)
        batches = lm1b_batches(cfg)
        losses[impl] = [float(sess.run("loss", feed_dict=batches[i]))
                        for i in range(3)]
        sess.close()
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["kernel"],
                                               losses["scan"])]
    summary = {"losses": losses, "max_rel_diff": max(rel), "tol": 1e-4}
    log(f"[train-agree] {json.dumps(summary)}")
    if not max(rel) <= 1e-4:
        raise AssertionError(f"kernel and scan losses differ by {max(rel)} "
                             f"relative > 1e-4")
    return summary


# -- phase 8: NMT Transformer training -----------------------------------------

# the defaults of examples/nmt_driver.py:24-26: 64 rows of 64 source and
# 64 target tokens
NMT_TRAIN = dict(batch=64, src_len=64, tgt_len=64, warmup=5, steps=30)
FLASH_COUNTERS = ("launches", "launches_dq", "launches_dkv")


def nmt_train_session(torch, use_pallas_attention=True, **cfg_kw):
    """NMTConfig() at its published widths, with the max_len that
    examples/nmt_driver.py sets and a 10-step warmup (the published 4000
    keeps the learning rate below 1e-5 for the whole run)."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import nmt
    cfg = nmt.NMTConfig(use_pallas_attention=use_pallas_attention,
                        num_partitions=1, max_len=NMT_TRAIN["src_len"],
                        warmup_steps=10, **cfg_kw)
    sess, *_ = pt.parallel_run(
        nmt.build_model(cfg), parallax_config=pt.Config(run_option="HYBRID"),
        seed=SEED, device=DEVICE)
    return cfg, sess


def nmt_batches(cfg):
    """4 ``make_batch`` batches (numpy seed 0), each source row padded
    after a length drawn in [16, 64]."""
    from parallax_tpu_torch.models import nmt
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(4):
        b = nmt.make_batch(rng, NMT_TRAIN["batch"], NMT_TRAIN["src_len"],
                           NMT_TRAIN["tgt_len"], cfg.vocab_size)
        lengths = rng.integers(16, NMT_TRAIN["src_len"] + 1,
                               NMT_TRAIN["batch"])
        for i, n in enumerate(lengths):
            b["src"][i, n:] = nmt.PAD_ID
        out.append(b)
    return out


def phase_nmt_train(torch):
    from parallax_tpu_torch.ops import flash_attention as fa
    from parallax_tpu_torch.ops import paged_attention as pa
    torch.cuda.reset_peak_memory_stats()
    cfg, sess = nmt_train_session(torch)
    batches = nmt_batches(cfg)
    t_build = time.perf_counter()
    sess.prepare(batches[0])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    sparse = sorted(p for p, v in sess.engine.plan.var_specs.items()
                    if v.is_sparse)
    if sparse != ["emb"]:
        raise AssertionError(f"classifier found {sparse} sparse, expected "
                             f"['emb']")
    torch.cuda.synchronize()
    for name in FLASH_COUNTERS:
        setattr(fa, name, 0)
    pa.launches = 0
    losses, words = [], []
    for i in range(NMT_TRAIN["warmup"]):
        losses.append(sess.run("loss", feed_dict=batches[i % 4]))
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    t0 = time.perf_counter()
    feed = (batches[i % 4] for i in range(NMT_TRAIN["steps"]))
    for loss, w in sess.run_iter(feed, fetches=["loss", "words"]):
        losses.append(loss)
        words.append(w)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.launches,
                "flash_attention_dq": fa.launches_dq,
                "flash_attention_dkv": fa.launches_dkv,
                "paged_decode_attention": pa.launches}
    steps_run = NMT_TRAIN["warmup"] + NMT_TRAIN["steps"]
    per_step = 3 * cfg.num_layers     # enc self, dec self, cross
    want = {"flash_attention_fwd": per_step * steps_run,
            "flash_attention_dq": per_step * steps_run,
            "flash_attention_dkv": per_step * steps_run,
            "paged_decode_attention": 0}
    if launches != want:
        raise AssertionError(f"NMT training launch counts {launches} != "
                             f"{want}")
    losses = [float(x) for x in losses]
    total_words = sum(float(w) for w in words)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite NMT loss: {losses}")
    if not statistics.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"NMT loss did not fall: first {losses[0]}, "
                             f"last five {losses[-5:]}")
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    summary = {
        "config": {"vocab": cfg.vocab_size, "model": cfg.model_dim,
                   "heads": cfg.num_heads, "mlp": cfg.mlp_dim,
                   "layers": cfg.num_layers, "max_len": cfg.max_len,
                   "warmup_steps": cfg.warmup_steps, "compute": "bfloat16",
                   "batch": NMT_TRAIN["batch"],
                   "src_len": NMT_TRAIN["src_len"],
                   "tgt_len": NMT_TRAIN["tgt_len"]},
        "nmt_target_words_per_sec": total_words / wall,
        "timed_steps": NMT_TRAIN["steps"], "words": total_words,
        "wall_s": wall, "step_ms_p50": statistics.median(step_ms),
        "step_ms_p95": step_ms[min(len(step_ms) - 1,
                                   int(math.ceil(0.95 * len(step_ms))) - 1)],
        "first_loss": losses[0],
        "last5_mean_loss": statistics.mean(losses[-5:]), "losses": losses,
        "engine_build_s": build_s, "sparse": sparse,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}
    log(f"[nmt-train] {json.dumps({k: v for k, v in summary.items() if k != 'losses'})}")
    profile = profile_train(torch, sess, batches, label="nmt-train-profile")
    sess.close()
    torch.cuda.empty_cache()
    return summary, profile


def phase_nmt_train_agreement(torch):
    """3 steps in fp32 (TF32 off) from the same weights through the
    flash kernels and through the plain attention with autograd."""
    losses = {}
    for name, pallas in (("kernel", True), ("plain", False)):
        cfg, sess = nmt_train_session(torch, use_pallas_attention=pallas,
                                      compute_dtype=torch.float32)
        batches = nmt_batches(cfg)
        losses[name] = [float(sess.run("loss", feed_dict=batches[i]))
                        for i in range(3)]
        sess.close()
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["kernel"],
                                               losses["plain"])]
    summary = {"losses": losses, "max_rel_diff": max(rel), "tol": 1e-4}
    log(f"[nmt-train-agree] {json.dumps(summary)}")
    if not max(rel) <= 1e-4:
        raise AssertionError(f"NMT kernel and plain losses differ by "
                             f"{max(rel)} relative > 1e-4")
    return summary


# -- the run ----------------------------------------------------------------


def kernel_line(results, launches):
    """One entry per kernel, at its main path's shape in bf16 (the shape
    and type the main path launched it at): the serving shape for B4
    and B7, the LM1B training shape for B1-B3, the NMT training step's
    encoder self-attention (B 64, T 64, H 8, hd 64, pad mask) for B5 and
    B6. B4's launches are the serving and the NMT training paths'."""
    lstm_src = "parallax_tpu_torch/csrc/lstm.cu"
    bwd_src = "parallax_tpu_torch/csrc/flash_attention_bwd.cu"
    meta = {
        "flash_attention_fwd": (
            "parallax_tpu_torch/csrc/flash_attention.cu",
            "parallax_tpu/ops/pallas_attention.py:141", "serve"),
        "flash_attention_dq": (
            bwd_src, "parallax_tpu/ops/pallas_attention.py:298",
            "train_enc"),
        "flash_attention_dkv": (
            bwd_src, "parallax_tpu/ops/pallas_attention.py:326",
            "train_enc"),
        "paged_decode_attention": (
            "parallax_tpu_torch/csrc/paged_attention.cu",
            "parallax_tpu/ops/pallas_paged_attention.py:278", "serve"),
        "lstm_fwd": (lstm_src, "parallax_tpu/ops/pallas_lstm.py:290",
                     "train"),
        "lstm_fwd_res": (lstm_src, "parallax_tpu/ops/pallas_lstm.py:299",
                         "train"),
        "lstm_bwd": (lstm_src, "parallax_tpu/ops/pallas_lstm.py:477",
                     "train"),
    }
    out = []
    for name, (source, replaces, case) in meta.items():
        r = next(r for r in results if r["kernel"] == name
                 and r["case"] == case and r["dtype"] == "bfloat16")
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    return {"kernels": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "parallax_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no parallax_tpu_torch package beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # every fp32 comparison below runs in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_build(torch)
    results = phase_kernels(torch) + phase_flash_bwd_kernels(torch)
    failed = [f"{r['kernel']}/{r['case']}/{r['dtype']}" for r in results
              if not r["ok"]]
    if failed:
        raise AssertionError(f"kernels disagree with their plain "
                             f"versions: {failed}")
    from parallax_tpu_torch.models import nmt
    cfg = nmt.NMTConfig(use_pallas_attention=True, num_partitions=1)
    requests = make_requests(256, np.random.default_rng(SEED),
                             cfg.vocab_size)
    params, serve_summary = phase_serve(torch, cfg, requests)
    profile_summary = phase_profile(torch, cfg, params, requests[:64])
    agree = phase_agreement(torch, params, cfg, requests[:32])
    del params
    lstm_results = phase_lstm_kernels(torch)
    failed = [f"{r['kernel']}/{r['case']}/{r['dtype']}" for r in lstm_results
              if not r["ok"]]
    if failed:
        raise AssertionError(f"LSTM kernels disagree with their plain "
                             f"versions: {failed}")
    train, train_profile = phase_train(torch)
    train_agree = phase_train_agreement(torch)
    nmt_train, nmt_profile = phase_nmt_train(torch)
    nmt_agree = phase_nmt_train_agreement(torch)
    launches = {**serve_summary["launches"], **train["launches"]}
    for name, n in nmt_train["launches"].items():
        launches[name] = launches.get(name, 0) + n
    line = kernel_line(results + lstm_results, launches)
    record = {"card": card, "kernels": line["kernels"],
              "cases": results + lstm_results,
              "serve": serve_summary, "profile": profile_summary,
              "agreement": agree, "train": train,
              "train_profile": train_profile, "train_agreement": train_agree,
              "nmt_train": nmt_train, "nmt_train_profile": nmt_profile,
              "nmt_train_agreement": nmt_agree,
              "wall_s": time.perf_counter() - t_start}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"[done] {record['wall_s']:.1f}s")
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
