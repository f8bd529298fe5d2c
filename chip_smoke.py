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
   (``scaled_dot_product_attention`` for the flash forward), the
   bound from the H100 SXM data sheet and, for the flash kernels, the
   achieved TF/s (operations over device time). bf16 flash forward, dq
   and dk/dv run the sm90 kernels (TMA + wgmma), fp32 the first kernels;
   the T 2048 cases (B 2, H 8, hd 64, causal and not) and BERT-large's
   attention (``bert``: B 32, T 512, H 16, hd 64, a padding mask whose
   lengths are drawn in [384, 512]) run in bf16 only.
   The paged kernel (split-KV, ``paged_decode_kernel_sm90`` and, where
   its ``split_plan`` splits the positions, ``paged_combine_kernel``)
   runs at the serving shape and ``FLAGSHIP_DECODE`` (G 1 and 3,
   occupancy 100 and 25 %); each case prints its plan.
3. Serve: NMT at its published widths (``NMTConfig()``: vocab 32000,
   model 512, 8 heads, MLP 2048, 6+6 layers, bf16, flash encoder
   attention) with random weights from a fixed seed, behind
   ``ServeSession(program=NMTDecodeProgram(..., attn_impl="kernel"))``
   with 64 slots; 256 requests. The scheduler's warmup captures the
   prefill and the decode step as CUDA graphs, which the loop replays.
   Every launch counter is zeroed just before and read just after; each
   must equal the scheduler's own count of prefills / decode steps times
   the 6 layers (plus the warmup's eager call of each; the paged combine
   kernel as often as the paged kernel when its plan splits; a replay
   adds what its graph launched at capture). Then 64 of the requests again
   under the profiler, for the device's busy share, the busy and paged
   kernel time a decode step and the kernels that take the time; the
   profile must show ``flash_fwd_kernel_sm90`` and
   ``paged_decode_kernel_sm90`` and no first flash or paged kernel.
4. Agreement: 32 of the same requests served in fp32 (TF32 off) and
   compared, request by request, with the standalone ``greedy_decode``
   of the plain path (dense cache, plain attention, no kernel).
5. LSTM kernels (B1 forward, B2 forward with residuals, B3 backward)
   against their plain versions at the training shape (T 20, B 128,
   H 2048, P 512) and one ragged shape, in bf16 (atol 2e-2 of the plain
   peak) and fp32 with TF32 off (atol 1e-4 of max(1, plain peak)); each
   timed beside the plain version, cuDNN's ``torch.nn.LSTM`` with the
   same projection (which also runs the input projection the kernels
   leave to the hoisted matmul; for B3 its forward plus backward less
   its forward), the bound and the achieved TF/s. Each runs the kernel
   ``ops/lstm.py``'s ``fwd_route`` or ``bwd_route`` picks, printed with
   each case: the persistent kernels (``csrc/lstm_sm90.cu``) in bf16 at
   the training shape, which must take them, the first kernels in fp32
   and at the ragged shape. Then 10 back-to-back bf16 B2 calls and 10 B3
   calls at the training shape must each give bit-identical results, and
   B2's and B3's device time over T 1-40 (three allocations each) gives
   each one's time a step (``lstm-sweep``, ``lstm-bwd-sweep``), and B3 on
   the persistent kernel with 16 and with 32 units a block, in turns,
   shows what its route's choice rests on (``lstm-bwd-groups``).
6. Train: LM1B at its published widths (``LM1BConfig()``: vocab 793470
   padded to 793472 for 8 partitions, emb 512, hidden 2048, proj 512,
   8192 sampled candidates, keep_prob 0.9, bf16 compute, fp32 tables)
   through ``parallel_run(..., Config(run_option="HYBRID",
   sparse_grad_mode="slices"))`` with ``lstm_impl="kernel"``, random
   weights from seed 0: the step's CUDA graph captured ahead of step 0
   (``sess.warmup``: capture seconds, the memory it took), then 5 warmup
   and 30 timed steps over 4 cycled batches of 128 x 20, words/sec and
   step ms, then one held-out no-grad loss. The LSTM counters are zeroed before and read after:
   B2 and B3 once per step, B1 none until the held-out loss, then once.
   Losses finite and falling; the padded vocab rows untouched. Then 5
   steps under the profiler (launches and busy ms a step), which must
   show ``lstm_fwd_kernel_sm90`` and ``lstm_bwd_kernel_sm90`` and no
   first LSTM kernel.
6b. ``dist-train``: the same LM1B (config, seed, batches, warmup and
   timed steps) through ``parallel_run`` as rank 0 of a one-rank NCCL
   process group (the launcher's environment set in this process; a
   failed ``init_process_group`` or collective fails the phase), the
   step captured with its NCCL all-reduce of the dense gradients
   inside. At one rank the all-reduce is the identity, so every loss
   must equal the train phase's bit for bit. B2 and B3 once a step.
   Words/s and step p50/p95, then 5 profiled steps: host launches,
   busy ms and NCCL's device ms a step and its share of busy, beside
   the card's name and power limit.
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
   profiler, which must show ``flash_fwd_kernel_sm90``,
   ``flash_dq_kernel_sm90`` and ``flash_dkv_kernel_sm90`` and no first
   forward, dq or dk/dv kernel.
9. NMT train agreement: 3 steps in fp32 (TF32 off) from the same weights
   through the flash kernels and through the plain attention with
   autograd; per-step losses within 1e-4 relative.
10. ResNet-50 training (``resnet-train``): ``cnn.build_model(
    "resnet50_v1.5")`` at its published widths (224 px, 1000 classes,
    bf16 compute, fp32 parameters and BatchNorm statistics) through
    ``parallel_run(..., Config(run_option="AR"))``, random weights from
    seed 0, batch 256 (``examples/cnn_benchmark_driver.py``'s default): 5
    warmup and 30 timed steps over 4 cycled synthetic batches,
    images/sec, step ms, peak memory and the model FLOPs (counted on meta
    tensors) as a share of 989 TF/s. Losses finite at every step, every
    ``model_state`` leaf changed by the first step, no parameter
    non-finite. No TPU kernel lies on this path: convolutions and
    BatchNorm are cuDNN/ATen calls.
11. ``resnet-profile``: 5 steps under the profiler: launches a step, the
    idle share, busy time by group (cuDNN convolutions by direction,
    BatchNorm, the optimizer, the images' copy, the rest). It fails on
    any NCHW/NHWC layout-transpose kernel.
12. ``resnet-agree``: one step of the 4-stage ``[1, 1, 1, 1]`` ResNet at
    full width (batch 4, 224 px) on the card against the CPU, in fp32
    (TF32 off) and in float64: loss, every gradient and the new
    statistics, at ``RESNET_AGREE``'s tolerances.

12b. ``bert-train``: BERT-large pretraining (MLM + NSP) at its
    published widths (``BertConfig(use_pallas_attention=True)``: vocab
    30522, hidden 1024, 16 heads, MLP 4096, 24 layers, bf16 compute, fp32
    parameters) through ``parallel_run(..., Config(run_option=
    "HYBRID"))``, random weights from seed 0, batches of 32 x 512 from
    ``make_batch`` with 80 masked positions a row, each row padded (id 0)
    after a length drawn in [384, 512] and its masked positions there
    weighted 0: ``sess.warmup`` captures the step, then 10 timed steps:
    sequences/s, step ms p50 and p95, peak memory, the model FLOPs
    (counted from the shapes) as a share of 989 TF/s; B4, B5 and B6 must
    launch 24 times a step each and every loss must be finite. Then 3
    steps under the profiler: busy ms a step, the idle share, busy by
    group (the flash kernels, the fp32 head products, the bf16 GEMMs,
    the optimizer, reductions, elementwise passes) and the top kernels.
12c. ``bert-agree``: 3 steps of the same BERT-large (batch 8 x 512)
    from one init, eagerly, through the flash kernels and through the
    plain attention core: losses within 2e-3 relative
    (``tests/test_bert.py:55``'s tolerance).

12d. ``lc-train``: the long-context causal LM at its published widths
    (``LongContextConfig()``: vocab 32000, D 512, 8 heads of 64, MLP
    2048, 6 layers, ``parallelism="ring"``, bf16) through
    ``parallel_run(..., Config(run_option="HYBRID"))`` on one card, where
    the ring has one block: one causal flash tile a layer, merged through
    its lse. Batches of 8 x 8192 from ``make_batch``; ``sess.warmup``
    captures the step, then 10 timed steps: tokens/s, step ms p50 and
    p95, peak memory, the model FLOPs (causal attention counted as half)
    as a share of 989 TF/s; B4, B5 and B6 must launch 6 times a step
    each, every loss must be finite and ``tokens`` 8 x 8191. Then 3 steps
    under the profiler, busy by ``LC_GROUPS``.
12e. ``lc-agree``: 3 eager steps of the same model at 2 x 2048 from one
    init, the ring's flash blocks against the plain causal core: losses
    within 2e-3 relative.
12f. ``lc-serve``: the same model, random weights from seed 0, behind
    ``ServeSession(program=CausalLMDecodeProgram(..., max_src_len=512,
    max_len=256, page_size=16, pool_pages=3072, attn_impl="kernel"))``
    with 64 slots: 256 requests with prompts of 64-512 ids, each prompt's
    K/V inserted through its slot's page row. The warmup captures the
    prefill and the decode step. B7 must launch 6 times a decode step
    (plus the warmup's call), B4 never; no page may stay in use after
    close. Then 64 requests under the profiler (``lc-serve-profile``):
    busy and B7 ms a decode step and the idle share.
12g. ``lc-serve-agree``: 32 of the requests served in fp32 (TF32 off)
    through B7 against ``standalone_greedy`` of the dense program (plain
    attention), request by request, with ``agreement``'s top-2-gap rule.

12h. ``moe-train``: the switch-MoE LM at its published widths
    (``MoeLMConfig(use_pallas_attention=True)``: vocab 32000, D 512, 8
    heads of 64, 16 experts of 1024, top-1, 6 layers, bf16) through
    ``parallel_run(..., Config(run_option="HYBRID"))`` on one card, where
    the shard axis is 1 and the MoE runs every expert on every token (the
    JAX package's dense fallback). Batches of 16 x 1024 (the model's
    ``max_len``) from ``make_batch``; ``sess.warmup`` captures the step,
    then 10 timed steps: tokens/s, step ms p50 and p95, peak memory, the
    routed (top-1) and executed FLOPs as shares of 989 TF/s; B4, B5 and
    B6 must launch 6 times a step each, every loss be finite and the last
    below the first, ``moe_dropped`` 0. Then 3 steps under the profiler,
    busy by ``MOE_GROUPS``.
12i. ``moe-agree``: 3 eager steps at 4 x 1024 from one init, the flash
    kernels against the plain causal core: losses within 2e-3 relative.
12j. ``moe-serve`` and ``moe-serve-profile``: the MoE LM, random weights
    from seed 0, behind ``MoeLMDecodeProgram`` with ``lc-serve``'s
    program settings, slots and 256 prompts; B7 6 times a decode step,
    no page left in use; then 64 requests under the profiler.
12k. ``moe-serve-agree``: 32 of the requests in fp32 through B7 against
    ``standalone_greedy`` of the dense plain program, under the top-2-gap
    rule.
12l. ``nmt-beam``: NMT ``beam_decode`` at ``examples/nmt_eval.py``'s
    widths and defaults (vocab 32000, D 512, 8 heads, MLP 2048, 6 + 6
    layers, max_len 128, beam 4, length penalty 1.0, batch 16 of 64
    ids), the cached path in bf16 with the flash encoder (B4 6 times a
    call): sentences/s and ms a decode step; the fp32 beams with the
    kernel encoder against the plain encoder's (a differing row passes
    only where the plain path scores both within 1e-3); ``corpus_bleu``
    of the beams against the greedy decode.

The kernel phase adds the ``lc_train`` cases (bf16 B4, and B5/B6 with an
lse cotangent, at B 8, T 8192, 8 heads of 64, causal; held to the plain
versions on 4 of the 8 rows, whose [T, T] scores fit, and timed on all
8), ``lc_serve`` (bf16 and fp32 B7 at S 64, 48 pages of 16, last
positions drawn in [63, 766]; moe-serve's shape too), ``moe_train``
(bf16 B4, and B5/B6, at B 16, T 1024, 8 heads of 64, causal) and
``nmt_beam`` (B4 in fp32 and bf16 at nmt-beam's encoder: B 16, T 64, 8
heads of 64, a mask with every key valid).

13. ``graph-agree``: LM1B (dropout on) and NMT training, 5 steps
    eagerly (``compile.disable_capture()``) and 5 as graph replays from
    fresh sessions of one seed on the same batches: losses and the final
    state compared leaf by leaf (bitwise, else within 1e-6 of the leaf's
    peak).

The timed training phases (6, 8, 10) capture their step ahead of step 0
and then, in the same session, run ``graph-pair``: 15 steps eagerly, 15
as replays, 15 replays, 15 eager, each with its words, tokens or images
a second and step ms p50 and p95, then 5 steps of each mode under the
profiler (the card's busy ms and idle share, kernels and the host's
launch calls a step). ``serve-graph-pair`` does the same for serving:
the 256 requests eagerly twice and on graphs once more beside the serve
phase's run, every run's tokens identical, then 64 requests of each
mode under the profiler, per decode step.

Every phase's seconds are printed (``[phase-seconds]``).

Phase 2 also holds the flash backward (B5 dq, B6 dk/dv) against its
plain versions at the three training attentions, at T 512 (causal and
not), hd 128, a ragged Tq 100 / Tk 37, a batch that sees no key (exact
zero gradients), an lse cotangent and, in bf16 only, T 2048 and
BERT-large's attention, in fp32
(atol 2e-5 of max(1, peak)) and bf16; each timed beside the plain
version, the bound, its achieved TF/s and
``scaled_dot_product_attention``'s backward (its forward plus backward
less its forward). Then ``paged-splits``: bf16 B7 at the serving shape
and two flagship cases under every split of the positions from 1 to 32
ranges (the split ones through the combine kernel), each held to the
plain version and timed cold in turns.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, and its error, times and bound at
the main-path case where it fares worst against its library call,
beside every main-path case's (``main_path``). The whole
record is also written to ``build/chip_smoke.json``.

``python3 chip_smoke.py --pair DIR`` is an A/B on one card instead: the
LSTM kernel phase and LM1B training of the checkout in DIR and of this
one, in the order DIR, this, this, DIR, twice (``run_pair``).
``python3 chip_smoke.py --pair DIR serve`` does the same with the paged
kernel cases, the serve phase and a profiled serve run.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
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


# profiler windows tried before a kernel counts as missed, and the fills
# that pad each window's ends
PROFILE_WINDOWS = 4
PROFILE_PAD = 16


def profile_events(torch, fn, calls: int, want=()):
    """The profiler's CUDA activity over ``calls`` calls of ``fn``, as
    ``key_averages()`` rows with device time. The CUDA activity tracing
    now and then delivers a window without some or all of its kernels
    (on an H100 with torch 2.11: a window with no row at all, and one
    with other rows but none of a correct fp32 flash dq that launched).
    So a window with no device row, or with no row whose name holds one
    of ``want``, is profiled again, up to ``PROFILE_WINDOWS`` windows; a
    kernel that does not launch is missed in every one of them, and the
    last window is returned as it is. The window starts and ends with
    PROFILE_PAD one-element fills, so that a record lost at a window's edge
    is not one of ``fn``'s."""
    from torch.profiler import ProfilerActivity, profile
    rows = []
    pad = torch.empty(1, device=DEVICE)
    for window in range(PROFILE_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                pad.fill_(0.0)
            for _ in range(calls):
                fn()
            for _ in range(PROFILE_PAD):
                pad.fill_(0.0)
            torch.cuda.synchronize()
        rows = [evt for evt in prof.key_averages()
                if getattr(evt, "device_time_total",
                           getattr(evt, "cuda_time_total", 0.0)) > 0]
        if rows and (not want
                     or any(n in evt.key for evt in rows for n in want)):
            return rows
        log(f"[profile] window {window + 1} of {PROFILE_WINDOWS}: "
            f"{'no device activity' if not rows else f'no {list(want)}'}"
            f" recorded")
    return rows


def device_ms(torch, fn, kernel_name: str, calls: int = 10):
    """Mean device time of the CUDA kernel named ``kernel_name`` per
    call of ``fn``, from the profiler's CUDA activity (None when the
    profiler records no such kernel)."""
    total_us, count = 0.0, 0
    for evt in profile_events(torch, fn, calls, want=(kernel_name,)):
        if kernel_name in evt.key:
            total_us += getattr(evt, "device_time_total",
                                getattr(evt, "cuda_time_total", 0.0))
            count += evt.count
    return total_us / count / 1e3 if count else None


def paged_kernels_seen(rows):
    """{kernel name: launches} of the paged kernels in a profile's rows
    ``(us, count, name)``; raises unless ``paged_decode_kernel_sm90``
    launched and no first paged kernel (``paged_decode_kernel``) did."""
    seen = {}
    for _, n, key in rows:
        m = re.search(r"paged_\w+kernel\w*", key)
        if m:
            seen[m.group(0)] = seen.get(m.group(0), 0) + n
    if "paged_decode_kernel_sm90" not in seen or "paged_decode_kernel" \
            in seen:
        raise AssertionError(f"profile paged kernels {seen}: want "
                             f"paged_decode_kernel_sm90 and no first "
                             f"kernel")
    return seen


def flash_kernels_seen(rows, want):
    """{kernel name: launches} of the flash kernels in a profile's rows
    ``(us, count, name)``; raises unless every name in ``want`` launched
    and no first (fp32-FMA) flash kernel did, which on a bf16 path would
    mean a fallback."""
    seen = {}
    for _, n, key in rows:
        m = re.search(r"flash_\w+kernel\w*", key)
        if m:
            seen[m.group(0)] = seen.get(m.group(0), 0) + n
    missing = [w for w in want if w not in seen]
    stale = [k for k in seen if k in ("flash_fwd_kernel", "flash_dq_kernel",
                                      "flash_dkv_kernel")]
    if missing or stale:
        raise AssertionError(f"profile flash kernels {seen}: missing "
                             f"{missing}, first kernels {stale}")
    return seen


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
    # causal self-attention); "nmt_beam" is nmt-beam's encoder (16
    # sources of 64 ids, none of them pad: the mask passed is all valid)
    return [("serve", 1, 64, 8, 64, False, "tail"),
            ("masked_row", 2, 64, 8, 64, False, "row"),
            ("t512", 8, 512, 8, 64, False, None),
            ("t512_causal", 8, 512, 8, 64, True, None),
            ("train_enc", 64, 64, 8, 64, False, "pad"),
            ("train_dec", 64, 64, 8, 64, True, None),
            ("t2048", 2, 2048, 8, 64, False, None),
            ("t2048_causal", 2, 2048, 8, 64, True, None),
            ("bert", 32, 512, 16, 64, False, "bert"),
            ("lc_train", 8, 8192, 8, 64, True, None),
            ("moe_train", 16, 1024, 8, 64, True, None),
            ("nmt_beam", 16, 64, 8, 64, False, "full")]


# cases whose plain version runs on the first rows only: its fp32 [T, T]
# scores of all 8 rows at T 8192 would take 17 GB each (the kernel runs
# and is timed on every row; rows are independent)
PLAIN_ROWS = {"lc_train": 4}

# bf16 only: the long sequences where the sm90 kernels' ring reaches its
# steady state (fp32 stays on the first kernels, measured at T 512), and
# BERT-large's attention as bert-train runs it (B 32, T 512, 16 heads of
# 64, the WordPiece padding mask), and the long-context LM's as lc-train
# runs it (B 8, T 8192, 8 heads of 64, causal; the backward with the lse
# cotangent of the ring's merge), and the MoE LM's as moe-train runs it (B
# 16, T 1024, 8 heads of 64, causal)
BF16_ONLY = ("t2048", "t2048_causal", "bert", "lc_train", "moe_train")


def flash_kernel_name(kernel, dtype_name):
    """The CUDA kernel a flash wrapper launches for the dtype: the sm90
    (TMA + wgmma) kernels in bf16, the first kernels in fp32."""
    return f"{kernel}_sm90" if dtype_name == "bfloat16" else kernel


def tflops(r):
    """Achieved TF/s of a kernel case: its operations over its device time
    (the call's time when the profiler saw no kernel)."""
    t = r["device_ms"] if r["device_ms"] else r["ms"]
    return r["ops"] / (t * 1e-3) / 1e12


def make_mask(torch, kind, B, Tk):
    """kv_mask [B, Tk] int32: "tail" pads batch 0 after 40 tokens, "row"
    also masks every key of batch 1; "pad" gives each row a length drawn
    in [16, Tk] (numpy seed 0), "bert" one in [384, Tk] as bert-train's
    batches, "zero" also masks every key of batch 1, "full" masks
    nothing."""
    if kind is None:
        return None
    if kind == "full":
        return torch.ones((B, Tk), dtype=torch.int32, device=DEVICE)
    if kind in ("tail", "row"):
        mask = torch.ones((B, Tk), dtype=torch.int32, device=DEVICE)
        mask[0, 40:] = 0              # a padded source of 40 tokens
    else:
        low = BERT_TRAIN["min_len"] if kind == "bert" else min(16, Tk)
        lengths = np.random.default_rng(SEED).integers(low, Tk + 1, B)
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
    rows = PLAIN_ROWS.get(label, B)
    sub = [x[:rows] for x in (q, k, v)]
    sub_mask = None if mask is None else mask[:rows]
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal, kv_mask=mask)
    ref, ref_lse = fa.flash_attention_plain(*sub, causal=causal,
                                            kv_mask=sub_mask)
    torch.cuda.synchronize()
    out, lse = out[:rows], lse[:rows]
    err, tol = compare(torch, out, ref, dtype)
    live = torch.ones((rows,), dtype=torch.bool, device=DEVICE)
    if mask is not None:
        live = sub_mask.sum(dim=1) > 0
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
    dtype_name = str(dtype).split(".")[-1]
    kernel_device_ms = device_ms(torch, lambda: fa.flash_attention_lse(
        q, k, v, causal=causal, kv_mask=mask),
        flash_kernel_name("flash_fwd_kernel", dtype_name))
    del out, lse, ref, ref_lse
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
        *sub, causal=causal, kv_mask=sub_mask),
        **({} if rows == B else dict(reps=5, per_round=2)))
    attn_mask = None if mask is None else \
        (mask > 0)[:, None, None, :].expand(B, H, T, T)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=attn_mask, is_causal=causal, scale=scale))
    itemsize = q.element_size()
    bytes_moved = (4 * B * T * H * hd * itemsize + B * H * T * 4
                   + (0 if mask is None else B * T * 4))
    pairs = attended_pairs(torch, B, T, T, causal, mask)
    ops = 4 * H * hd * pairs
    bound_ms, bound_by = bound(bytes_moved, ops, dtype_name)
    return {"kernel": "flash_attention_fwd", "case": label,
            "dtype": dtype_name,
            "shape": {"B": B, "T": T, "H": H, "hd": hd, "causal": causal,
                      "mask": mask_kind},
            "ok": ok, "max_abs_err": err, "tol": tol, "plain_rows": rows,
            "lse_max_abs_err": lse_err, "ms": kernel_ms,
            "device_ms": kernel_device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops}


# -- phase 2: the paged-decode attention --------------------------------------


def paged_cases():
    from parallax_tpu_torch.ops.paged_attention import FLAGSHIP_DECODE as F
    # (label, S, G, D, heads, page_size, P, pool_pages, occupancy);
    # "serve" is the decode step of the serving path below
    # "lc_serve" is lc-serve's decode step: 48 pages of 16 a slot over a
    # 3072-page pool, each slot's last position drawn in [63, 766] (the
    # longest prompt's last position to its last decode step's) with the
    # pages that reach it
    out = [("serve", 64, 1, 512, 8, 16, 8, 512, None),
           ("lc_serve", 64, 1, 512, 8, 16, 48, 3072, "lc")]
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
        if occ == "lc":
            last = int(rng.integers(LC_SERVE["max_src_len"] - 1,
                                    LC_SERVE["max_src_len"]
                                    + LC_SERVE["max_len"] - 1))
            n = last // ps + 1
        elif occ is None:
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
    plan = pa.split_plan(S, H, D // H, P, ps, q.element_size(),
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    log(f"[kernel] paged_decode_attention {label} "
        f"{str(dtype).split('.')[-1]}: split_plan {plan._asdict()}")
    out = pa.paged_decode_attention(q, kp, vp, pages, pos, **kw)
    ref = pa.paged_decode_attention_plain(q, kp, vp, pages, pos, **kw)
    torch.cuda.synchronize()
    err, tol = compare(torch, out, ref, dtype)
    ok = err <= tol and bool(torch.isfinite(out).all())
    if isinstance(occ, float):
        ok = ok and bool((out[0] == 0).all())   # the slot with no page
    # a decode step reaches each layer's pool after the other layers'
    # pools and weights went through the cache, so both versions are
    # timed cold
    kernel_ms = time_ms(torch, lambda: pa.paged_decode_attention(
        q, kp, vp, pages, pos, **kw), flush=flush)
    warm_ms = time_ms(torch, lambda: pa.paged_decode_attention(
        q, kp, vp, pages, pos, **kw))
    # a call launches the decode kernel once, and the combine kernel once
    # more when the plan splits each slot's positions
    kernel_device_ms = device_ms_per_call(
        torch, lambda: pa.paged_decode_attention(q, kp, vp, pages, pos,
                                                 **kw),
        {"paged_decode_kernel_sm90": 1,
         "paged_combine_kernel": int(plan.nsplit > 1)})
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
            "plan": plan._asdict(), "bytes": nbytes,
            "ok": ok and kernel_device_ms is not None,
            "max_abs_err": err, "tol": tol, "ms": kernel_ms,
            "warm_ms": warm_ms, "device_ms": kernel_device_ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def paged_split_sweep(torch):
    """bf16 B7 at the serving shape and the flagship cases under each
    split of the positions (1 to 32 ranges, none under 64 positions; the
    split ones launch the combine kernel), each checked against the plain
    version and timed cold (CUDA events, an L2 flush before each call) in
    turns: what ``split_plan``'s choice of the fewest splits that give
    every SM a block rests on."""
    from parallax_tpu_torch.ops import paged_attention as pa
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=DEVICE)
    out = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case in paged_cases():
        label, S, G, D, H, ps, P, pool_pages, occ = case
        pages_np, pos_np = _paged_tables(case, np.random.default_rng(SEED))
        g = torch.Generator(device=DEVICE).manual_seed(SEED)
        q, kp, vp = (torch.randn(shape, generator=g, device=DEVICE,
                                 dtype=torch.bfloat16)
                     for shape in ((S, G, D), (pool_pages + 1, ps, D),
                                   (pool_pages + 1, ps, D)))
        pages = torch.from_numpy(pages_np).to(DEVICE)
        pos = torch.from_numpy(pos_np).to(DEVICE)
        args = (q, kp, vp, pages, pos, H, ps, pool_pages)
        ref = pa.paged_decode_attention_plain(
            q, kp, vp, pages, pos, num_heads=H, page_size=ps,
            pool_pages=pool_pages)
        planned = pa.split_plan(S, H, D // H, P, ps, 2, sms)
        T = P * ps
        plans = []
        for nsplit in (1, 2, 4, 8, 16, 32):
            positions = -(-T // nsplit // pa.CHUNK) * pa.CHUNK
            if nsplit == 1 or positions >= pa.MIN_SPLIT:
                plans.append(pa.SplitPlan(planned.heads,
                                          -(-T // positions), positions))
        times = {p.nsplit: [] for p in plans}
        for p in plans:
            err, tol = compare(torch, pa._launch(*args, p), ref,
                               torch.bfloat16)
            if not err <= tol:
                raise AssertionError(f"B7 {label} under {p}: err {err} > "
                                     f"{tol}")
        for p in plans + plans[::-1]:
            times[p.nsplit].append(time_ms(
                torch, lambda: pa._launch(*args, p), reps=10, flush=flush))
        row = {"case": label, "planned_nsplit": planned.nsplit,
               "positions": {p.nsplit: p.positions for p in plans},
               "ms": times}
        log(f"[paged-splits] {json.dumps(row)}")
        out.append(row)
    return out


def phase_kernels(torch):
    # overwritten before each cold timing: 512 MiB, ten times the L2
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=DEVICE)
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in flash_cases():
            if dtype == torch.float32 and case[0] in BF16_ONLY:
                continue
            results.append(run_flash_case(torch, case, dtype))
        for case in paged_cases():
            results.append(run_paged_case(torch, case, dtype, flush))
    del flush
    for r in results:
        warm = f" cold, {r['warm_ms']:.4f} ms warm" if "warm_ms" in r \
            else ""
        rate = ""
        if "ops" in r:
            # the profiler must see the kernel the dtype routes to
            r["ok"] = r["ok"] and r["device_ms"] is not None
            r["tflops"] = tflops(r)
            rate = f", {r['tflops']:.1f} TF/s"
        log(f"[kernel] {r['kernel']} {r['case']} {r['dtype']}: "
            f"{'ok' if r['ok'] else 'FAILED'} err {r['max_abs_err']:.3g} "
            f"(tol {r['tol']:.3g}) kernel {r['ms']:.4f} ms{warm} (device "
            f"{r['device_ms']} ms{rate}) plain "
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
            ("lse_cotangent", 8, 128, 128, 8, 64, True, None, True),
            ("t2048", 2, 2048, 2048, 8, 64, False, None, False),
            ("t2048_causal", 2, 2048, 2048, 8, 64, True, None, False),
            ("bert", 32, 512, 512, 16, 64, False, "bert", False),
            ("lc_train", 8, 8192, 8192, 8, 64, True, None, True),
            ("moe_train", 16, 1024, 1024, 8, 64, True, None, False)]


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
    rows = PLAIN_ROWS.get(label, B)
    # both versions take the same out and lse: the plain forward's, or the
    # kernel forward's where the plain version runs on the first rows only
    out, lse = (fa.flash_attention_plain if rows == B else fa.flash_forward)(
        q, k, v, causal, scale, mask)
    delta = fa.flash_delta(out, dout, dlse)
    del out
    args = (q, k, v, mask, dout, lse, delta, causal, scale)
    plain_args = args if rows == B else tuple(
        None if a is None else (a[:rows].contiguous()
                                if isinstance(a, torch.Tensor) else a)
        for a in args)
    got = {"flash_attention_dq": (fa.flash_dq(*args)[:rows],),
           "flash_attention_dkv": tuple(g[:rows]
                                        for g in fa.flash_dkv(*args))}
    want = {"flash_attention_dq": (fa.flash_dq_plain(*plain_args),),
            "flash_attention_dkv": fa.flash_dkv_plain(*plain_args)}
    torch.cuda.synchronize()
    library_ms = sdpa_backward_ms(torch, q, k, v, dout, mask, causal, scale)
    pairs = attended_pairs(torch, B, Tq, Tk, causal, mask)
    itemsize = q.element_size()
    in_bytes = ((2 * B * Tq + 2 * B * Tk) * H * hd * itemsize
                + 2 * B * H * Tq * 4
                + (0 if mask is None else B * Tk * 4))
    calls = {
        "flash_attention_dq": (lambda: fa.flash_dq(*args),
                               lambda: fa.flash_dq_plain(*plain_args),
                               "flash_dq_kernel", 3,
                               B * Tq * H * hd * itemsize),
        "flash_attention_dkv": (lambda: fa.flash_dkv(*args),
                                lambda: fa.flash_dkv_plain(*plain_args),
                                "flash_dkv_kernel", 4,
                                2 * B * Tk * H * hd * itemsize),
    }
    results = []
    dtype_name = str(dtype).split(".")[-1]
    for name, (kernel, plain, kname, products, out_bytes) in calls.items():
        errs = [grad_compare(torch, a, e, dtype)
                for a, e in zip(got[name], want[name])]
        finite = all(bool(torch.isfinite(a.float()).all())
                     for a in got[name])
        ok = all(err <= tol for err, tol in errs) and finite
        if mask_kind == "zero":
            # batch 1 sees no key: its gradients are exact zeros
            ok = ok and all(bool((a[1] == 0).all()) for a in got[name])
        ops = products * 2 * H * hd * pairs
        bound_ms, bound_by = bound(in_bytes + out_bytes, ops, dtype_name)
        results.append({
            "kernel": name, "case": label, "dtype": dtype_name,
            "plain_rows": rows,
            "shape": {"B": B, "Tq": Tq, "Tk": Tk, "H": H, "hd": hd,
                      "causal": causal, "mask": mask_kind,
                      "lse_cotangent": with_dlse, "pairs": pairs},
            "ok": ok, "finite": finite,
            "errs": [e for e, _ in errs], "tols": [t for _, t in errs],
            "max_abs_err": max(e for e, _ in errs),
            "tol": min(t for _, t in errs),
            "ms": time_ms(torch, kernel),
            "device_ms": device_ms(torch, kernel,
                                   flash_kernel_name(kname, dtype_name)),
            "plain_ms": time_ms(torch, plain, reps=5, per_round=2),
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention backward (dq, dk, dv)",
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops})
    return results


def phase_flash_bwd_kernels(torch):
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in flash_bwd_cases():
            if dtype == torch.float32 and case[0] in BF16_ONLY:
                continue
            results.extend(run_flash_bwd_case(torch, case, dtype))
    for r in results:
        # the profiler must see the kernel the dtype routes to
        r["ok"] = r["ok"] and r["device_ms"] is not None
        r["tflops"] = tflops(r)
        log(f"[kernel] {r['kernel']} {r['case']} {r['dtype']}: "
            f"{'ok' if r['ok'] else 'FAILED'} err {r['max_abs_err']:.3g} "
            f"(tol {r['tol']:.3g}) kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']} ms, {r['tflops']:.1f} TF/s) plain "
            f"{r['plain_ms']:.4f} ms SDPA bwd "
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
    return outs, wall, sess.stats(), prog


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
    pa.launches_combine = 0
    outs, wall, stats, prog = serve(torch, cfg, params, requests)
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": fa.launches,
                "paged_decode_attention": pa.launches}
    combine = pa.launches_combine
    check_outputs(requests, outs, cfg.vocab_size)
    L = cfg.num_layers
    want = {"flash_attention_fwd": (stats["serve.prefills"] + 1) * L,
            "paged_decode_attention":
                (stats["serve.decode_steps"] + 1) * L}
    # the decode step's shape: every slot, the whole page table
    plan = pa.split_plan(SERVE["max_batch"], cfg.num_heads,
                         cfg.model_dim // cfg.num_heads,
                         -(-SERVE["max_len"] // SERVE["page_size"]),
                         SERVE["page_size"], 2,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    want_combine = want["paged_decode_attention"] * int(plan.nsplit > 1)
    if launches != want or combine != want_combine:
        raise AssertionError(f"launch counts {launches}, combine "
                             f"{combine} != scheduler counts {want}, "
                             f"combine {want_combine} ({plan})")
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
               "launches": launches, "paged_combine_launches": combine,
               "paged_plan": plan._asdict(),
               "capture_s": stats["serve.compile_seconds"]["max"],
               "graphs": prog._graphs is not None,
               "pool_bytes": pool_bytes(torch, [prog._graphs[2].graph,
                                                prog._graphs[3].graph])}
    if not summary["graphs"]:
        raise AssertionError("the serving program captured no graphs")
    log(f"[serve] {json.dumps(summary)}")
    return params, summary, outs


def phase_profile(torch, cfg, params, requests):
    """Where a serve run's time goes: the same serving stack under the
    profiler's CUDA activity (kernels, copies and fills, from CUPTI),
    with the device's busy time summed over the window's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, stats, _ = serve(torch, cfg, params, requests)
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total",
                     getattr(evt, "cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, evt.count, evt.key))
    busy_s = sum(us for us, _, _ in rows) / 1e6
    paged_s = sum(us for us, _, key in rows if "paged_" in key) / 1e6
    rows.sort(reverse=True)
    steps = stats["serve.decode_steps"]
    summary = {"requests": len(requests), "window_s": window,
               "device_busy_s": busy_s,
               "device_idle_share": 1.0 - busy_s / window,
               "decode_steps": steps,
               "busy_ms_per_decode_step": busy_s * 1e3 / steps,
               "paged_ms_per_decode_step": paged_s * 1e3 / steps,
               "paged_share_of_busy": paged_s / busy_s,
               "flash_kernels": flash_kernels_seen(
                   rows, ["flash_fwd_kernel_sm90"]),
               "paged_kernels": paged_kernels_seen(rows),
               "top": [{"name": key[:90], "calls": n, "ms": us / 1e3,
                        "share_of_busy": us / 1e6 / busy_s}
                       for us, n, key in rows[:10]]}
    log(f"[profile] {json.dumps(summary)}")
    return summary


def phase_serve_pair(torch, cfg, params, requests, graph_outs,
                     graph_summary):
    """Serving eagerly (``compile.disable_capture()``) against graph
    replays: the 256 requests in the order graph (the serve phase's run),
    eager, eager, graph; every run's tokens identical to the serve
    phase's. Then ``PAIR["serve_profile_requests"]`` requests of each
    mode under the profiler, normalised by decode steps."""
    runs = {"eager": [], "graph": [{
        "tokens_per_sec": graph_summary["tokens_per_sec"],
        "step_ms_p50": graph_summary["step_ms_p50"],
        "step_ms_p95": graph_summary["step_ms_p95"]}]}
    differ = []
    for mode in ("eager", "eager", "graph"):
        with mode_ctx(mode):
            outs, wall, stats, prog = serve(torch, cfg, params, requests)
        if (prog._graphs is not None) != (mode == "graph"):
            raise AssertionError(f"serving {mode}: graphs "
                                 f"{prog._graphs is not None}")
        differ += [i for i, (a, b) in enumerate(zip(outs, graph_outs))
                   if not np.array_equal(a, b)]
        runs[mode].append({
            "tokens_per_sec": sum(len(o) for o in outs) / wall,
            "step_ms_p50": stats["serve.step_ms"]["p50"],
            "step_ms_p95": stats["serve.step_ms"]["p95"]})
    out = {"identical_tokens": not differ, "differing_requests":
           sorted(set(differ))}
    n = PAIR["serve_profile_requests"]
    for mode in ("eager", "graph"):
        got = {}

        def run():
            got["stats"] = serve(torch, cfg, params, requests[:n])[2]

        with mode_ctx(mode):
            prof = host_profile(torch, run, 1)
        steps = got["stats"]["serve.decode_steps"]
        out[mode] = {
            **{k: [r[k] for r in runs[mode]] for k in runs[mode][0]},
            "profile_decode_steps": steps,
            "device_busy_ms_per_decode_step":
                prof["device_busy_ms_per_step"] / steps,
            "device_idle_share": prof["device_idle_share"],
            "device_kernels_per_decode_step":
                prof["device_kernels_per_step"] / steps,
            "host_launches_per_decode_step":
                prof["host_launches_per_step"] / steps,
            "host_launch_calls": prof["host_launch_calls"]}
    out["graph"]["capture_s"] = graph_summary["capture_s"]
    out["graph"]["pool_bytes"] = graph_summary["pool_bytes"]
    log(f"[graph-pair:serve] {json.dumps(out)}")
    if differ:
        raise AssertionError(f"serving tokens differ between graphs and "
                             f"eager in requests {sorted(set(differ))}")
    return out


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
    outs, _, stats, _ = serve(torch, cfg, params, requests)
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
LSTM_REPEATS = 10


def lstm_kernel_records(name, route, T):
    """{CUDA activity name: records one call leaves} of an LSTM op on its
    route, as ops/lstm.py's fwd_route and bwd_route pick it: the
    persistent kernels (csrc/lstm_sm90.cu) launch once a call; the first
    ones (csrc/lstm.cu) three times a step, B3 once fewer and a memcpy of
    dh_tot's last step."""
    if route == "lstm_sm90":
        return {"lstm_bwd_kernel_sm90" if name == "lstm_bwd"
                else "lstm_fwd_kernel_sm90": 1}
    if name == "lstm_bwd":
        return {"Memcpy DtoD": 1, "lstm_bwd_cell_kernel": T,
                "lstm_bwd_dh_kernel": T - 1,
                "lstm_bwd_dh_reduce_kernel": T - 1}
    return {"lstm_gates_kernel": T, "lstm_proj_kernel": T,
            "lstm_proj_reduce_kernel": T}


def device_ms_per_call(torch, fn, records, calls: int = 5):
    """Device milliseconds per call of ``fn``: for each CUDA activity name
    in ``records`` ({name: records one call leaves}), the mean time of the
    records the profiler kept times the records a call leaves. The
    profiler can lose records, inside a window as well as at its edges, so
    a total over the calls made would read low. None when a name that a
    call must leave has no record."""
    rows = profile_events(torch, fn, calls,
                          want=tuple(n for n, k in records.items() if k))
    total_us = 0.0
    for name, per_call in records.items():
        if not per_call:
            continue
        us, count = 0.0, 0
        for evt in rows:
            # a CUDA runtime call (cudaMemcpyAsync) is not the activity
            if name in evt.key and not evt.key.startswith("cuda"):
                us += getattr(evt, "device_time_total",
                              getattr(evt, "cuda_time_total", 0.0))
                count += evt.count
        if not count:
            return None
        total_us += us / count * per_call
    return total_us / 1e3


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
    # each input read once, each output written once: the JAX byte model
    # counts B3's c trajectory twice (as c and as c_prev)
    nbytes = {"lstm_fwd": kb["recompute"]["stream_bytes"] + wbytes,
              "lstm_fwd_res": kb["scan"]["stream_bytes"] + wbytes,
              "lstm_bwd": kb["kernel"]["stream_bytes"]
              - kb["scan"]["stream_bytes"] - T * B * H * xs + wbytes}
    routes = {"lstm_fwd": lstm.device_fwd_route(xw, w_proj),
              "lstm_bwd": lstm.device_bwd_route(gout, w_proj)}
    results = []
    for name, (kernel, plain) in outs.items():
        route = routes["lstm_bwd" if name == "lstm_bwd" else "lstm_fwd"]
        kroute = route.source
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
        dev = device_ms_per_call(torch, kernel,
                                 lstm_kernel_records(name, kroute, T))
        results.append({
            "kernel": name, "case": label,
            "dtype": str(dtype).split(".")[-1],
            "shape": {"T": T, "B": B, "E": E, "H": H, "P": P},
            "route": kroute, "source": f"parallax_tpu_torch/csrc/"
                                       f"{kroute}.cu",
            "groups": route.groups if kroute == "lstm_sm90" else None,
            "stages": route.stages if kroute == "lstm_sm90" else None,
            "ok": ok, "max_abs_err": err, "tol": tol,
            "errs": [e for e, _ in errs],
            "ms": time_ms(torch, kernel, reps=10, per_round=3),
            "device_ms": dev, "ops": flops,
            "tflops": flops / (dev * 1e-3) / 1e12 if dev else None,
            "plain_ms": time_ms(torch, plain, reps=3, per_round=1,
                                warmup=1),
            "library_ms": library[name], "library": "torch.nn.LSTM (cuDNN)",
            "bound_ms": bound_ms, "bound_by": bound_by})
    return results


def lstm_sm90_inputs(torch, T, seed):
    """bf16 inputs of B2 and B3 at the training shape over T steps: xw,
    w_h, w_proj, the fp32 cotangent g, and B2's residuals of xw."""
    from parallax_tpu_torch.ops import lstm
    _, _, B, _, H, P = lstm_cases()[0]
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def r(shape, scale, dt=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=DEVICE)
                * scale).to(dt)
    xw = r((T, B, 4 * H), 1.0)
    w_h = r((P, 4 * H), 1.0 / math.sqrt(P))
    w_proj = r((H, P), 1.0 / math.sqrt(H))
    gout = r((T, B, P), 1.0, torch.float32)
    _, gates, cseq = lstm.lstm_recurrence(xw, w_h, w_proj, residuals=True)
    return xw, w_h, w_proj, gout, gates, cseq


def lstm_repeatability(torch):
    """LSTM_REPEATS back-to-back bf16 B2 calls and as many B3 calls at the
    LM1B training shape: hs, gates and c, and d_xw and dh_total, must be
    bit-identical (the persistent kernels' grid barriers and cross-block
    reads must not depend on timing)."""
    from parallax_tpu_torch.ops import lstm
    T = lstm_cases()[0][1]
    xw, w_h, w_proj, gout, gates, cseq = lstm_sm90_inputs(torch, T,
                                                          SEED + 1)
    calls = {
        "lstm_fwd_res": lambda: lstm.lstm_recurrence(xw, w_h, w_proj,
                                                     residuals=True),
        "lstm_bwd": lambda: lstm.lstm_bwd_recurrence(gout, gates, cseq,
                                                     w_h, w_proj)}
    summary = {"calls": LSTM_REPEATS,
               "route": {"lstm_fwd_res":
                         lstm.device_fwd_route(xw, w_proj).source,
                         "lstm_bwd":
                         lstm.device_bwd_route(gout, w_proj).source}}
    for name, call in calls.items():
        runs = [call() for _ in range(LSTM_REPEATS)]
        torch.cuda.synchronize()
        summary[name] = all(torch.equal(a, b) for run in runs[1:]
                            for a, b in zip(run, runs[0]))
    log(f"[lstm-repeat] {json.dumps(summary)}")
    differ = [name for name in calls if not summary[name]]
    if differ:
        raise AssertionError(f"bf16 {differ} calls at the training shape "
                             f"differ from one another")
    return summary


LSTM_SWEEP_T = (1, 10, 20, 40)


def lstm_step_sweep(torch, name="lstm_fwd_res"):
    """Device ms of a bf16 B2 (``lstm_fwd_res``) or B3 (``lstm_bwd``) call
    at the training shape (B 128, H 2048, P 512) over T in LSTM_SWEEP_T,
    each T in 3 fresh allocations (the inputs land at other addresses each
    time): the slope over T is the persistent kernel's time a step, the
    intercept its fixed cost (the weight copy into shared memory, the
    launch)."""
    from parallax_tpu_torch.ops import lstm
    _, _, B, _, H, P = lstm_cases()[0]
    kernels = lstm_kernel_records(name, "lstm_sm90", 1)
    rows = []
    for T in LSTM_SWEEP_T:
        times = []
        for alloc in range(3):
            pad = torch.empty((1 << 20) * (alloc + 1), device=DEVICE)
            xw, w_h, w_proj, gout, gates, cseq = lstm_sm90_inputs(
                torch, T, SEED + alloc)
            if name == "lstm_bwd":
                call = lambda: lstm.lstm_bwd_recurrence(  # noqa: E731
                    gout, gates, cseq, w_h, w_proj)
            else:
                call = lambda: lstm.lstm_recurrence(  # noqa: E731
                    xw, w_h, w_proj, residuals=True)
            times.append(device_ms_per_call(torch, call, kernels,
                                            calls=10))
            del pad
        rows.append({"T": T, "device_ms": times})
    per_step = [(b - a) / (LSTM_SWEEP_T[-1] - LSTM_SWEEP_T[0])
                for a, b in zip(rows[0]["device_ms"], rows[-1]["device_ms"])]
    summary = {"kernel": name, "shape": {"B": B, "H": H, "P": P},
               "rows": rows, "ms_per_step": per_step}
    label = "lstm-bwd-sweep" if name == "lstm_bwd" else "lstm-sweep"
    log(f"[{label}] {json.dumps(summary)}")
    return summary


def lstm_bwd_groups(torch):
    """bf16 B3 at the training shape on the persistent backward with 16 and
    with 32 hidden units a block (G 1: 128 blocks, G 2: 64; each with
    bwd_route's ring), timed with CUDA events in turns (G 1, 2, 2, 1):
    what bwd_route's preference for the fewest blocks rests on. Each must
    agree with the plain version."""
    from parallax_tpu_torch.ops import lstm
    T = lstm_cases()[0][1]
    xw, w_h, w_proj, gout, gates, cseq = lstm_sm90_inputs(torch, T,
                                                          SEED + 2)
    ref = lstm.lstm_bwd_recurrence_plain(gout, gates, cseq, w_h, w_proj)

    def call(groups):
        dxw, dhtot = torch.empty_like(gates), torch.empty_like(gout)
        lstm._sm90_bwd(lstm.FwdRoute("lstm_sm90", groups,
                                     lstm.SM90_BWD_STAGES),
                       gout, gates, cseq, w_h, w_proj, dxw, dhtot)
        return dxw, dhtot
    summary = {"T": T, "stages": lstm.SM90_BWD_STAGES,
               "route_groups": lstm.device_bwd_route(gout, w_proj).groups}
    for groups in (1, 2):
        got = call(groups)
        torch.cuda.synchronize()
        errs = [lstm_close(torch, a, e, torch.bfloat16)
                for a, e in zip(got, ref)]
        if not all(err <= tol for err, tol in errs):
            raise AssertionError(f"B3 with G {groups} disagrees with the "
                                 f"plain version: {errs}")
        summary[f"G{groups}_ms"] = []
    for groups in (1, 2, 2, 1):
        summary[f"G{groups}_ms"].append(
            time_ms(torch, lambda: call(groups), reps=5, per_round=10))
    log(f"[lstm-bwd-groups] {json.dumps(summary)}")
    return summary


def phase_lstm_kernels(torch):
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for case in lstm_cases():
            results.extend(run_lstm_case(torch, case, dtype))
    for r in results:
        tf = f"{r['tflops']:.1f}" if r["tflops"] else "n/a"
        log(f"[kernel] {r['kernel']} {r['case']} {r['dtype']} "
            f"[{r['route']}]: "
            f"{'ok' if r['ok'] else 'FAILED'} err {r['max_abs_err']:.3g} "
            f"(tol {r['tol']:.3g}) kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']} ms, {tf} TF/s) plain {r['plain_ms']:.4f} ms "
            f"cuDNN {r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
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
    capture = capture_train(torch, sess, TRAIN["batch"])
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
        "launches": launches, "capture": capture}
    log(f"[train] {json.dumps({k: v for k, v in summary.items() if k != 'losses'})}")
    profile = profile_train(torch, sess, batches,
                            lstm=["lstm_fwd_kernel_sm90",
                                  "lstm_bwd_kernel_sm90"])
    summary["graph_pair"] = graph_pair(
        torch, sess, batches, lambda b: float(b["w"].sum()), "lm1b")
    summary["graph_pair"]["graph"].update(capture)
    sess.close()
    return summary, profile


def lstm_kernels_seen(rows, want):
    """{kernel name: launches} of the LSTM kernels in a profile's rows;
    raises unless every name in ``want`` launched and, when ``want`` holds
    a persistent kernel, no first kernel of that pass did (on the bf16
    LM1B path that would mean the route fell back)."""
    seen = {}
    for _, n, key in rows:
        m = re.search(r"lstm_\w+kernel\w*", key)
        if m:
            seen[m.group(0)] = seen.get(m.group(0), 0) + n
    missing = [w for w in want if not any(k.startswith(w) for k in seen)]
    first = {"lstm_fwd_kernel_sm90": ("lstm_gates_", "lstm_proj_"),
             "lstm_bwd_kernel_sm90": ("lstm_bwd_cell_kernel",
                                      "lstm_bwd_dh_")}
    stale = [k for w, names in first.items() if w in want
             for k in seen if k.startswith(names)]
    if missing or stale:
        raise AssertionError(f"profile LSTM kernels {seen}: missing "
                             f"{missing}, first kernels {stale}")
    return seen


def profile_train(torch, sess, batches, label="train-profile", flash=(),
                  lstm=()):
    """Where a training step's time goes: ``profile_steps`` steps under
    the profiler's CUDA activity, the device's busy time over the
    window's wall time; ``flash`` and ``lstm`` name the kernels the steps
    must launch."""
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
               "flash_kernels": flash_kernels_seen(rows, flash),
               "lstm_kernels": lstm_kernels_seen(rows, lstm),
               "device_busy_s": busy_s,
               "device_busy_ms_per_step": busy_s * 1e3
               / TRAIN["profile_steps"],
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


# -- dist-train: LM1B in a one-rank NCCL process group ------------------------


def nccl_group_env():
    """The environment ``parallel_run`` reads as a launched rank: rank 0 of
    a world of 1 on chip 0, its rendezvous a file under a new directory."""
    import tempfile
    from parallax_tpu_torch.common import consts
    from parallax_tpu_torch.common.lib import (HostInfo,
                                               serialize_resource_info)
    rdv = Path(tempfile.mkdtemp(prefix="parallax_rdv_")) / "store"
    return {consts.PARALLAX_RUN_OPTION: "WORKER", consts.PARALLAX_RANK: "0",
            consts.PARALLAX_WORLD_SIZE: "1", consts.PARALLAX_LOCAL_CHIP: "0",
            consts.PARALLAX_RESOURCE_INFO: serialize_resource_info(
                [HostInfo("localhost", (0,))]),
            consts.PARALLAX_RENDEZVOUS: f"file://{rdv}"}


def phase_dist_train(torch, train_losses, card):
    """The train phase's LM1B (same config, seed and batches) through
    ``parallel_run`` as rank 0 of a one-rank NCCL process group: the step
    captured with its NCCL all-reduce of the dense gradients inside. At
    one rank the all-reduce is the identity, so the losses must equal the
    train phase's bit for bit. Words/s and step p50/p95 over the same 30
    timed steps, then 5 profiled steps: host launches, busy ms and NCCL's
    device ms a step with its share of busy."""
    import os
    from parallax_tpu_torch.ops import lstm
    dist = torch.distributed
    env = nccl_group_env()
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg, sess = lm1b_session(torch)
        if not (dist.is_initialized() and dist.get_backend() == "nccl"
                and dist.get_world_size() == 1):
            raise AssertionError("dist-train: parallel_run did not join a "
                                 "one-rank NCCL process group")
        batches = lm1b_batches(cfg)
        sess.prepare(batches[0])
        capture = capture_train(torch, sess, TRAIN["batch"])
        torch.cuda.synchronize()
        for name in LSTM_COUNTERS:
            setattr(lstm, name, 0)
        losses = [sess.run("loss", feed_dict=batches[i % 4])
                  for i in range(TRAIN["warmup"])]
        timed = timed_steps_losses(torch, sess, batches, TRAIN["steps"])
        losses += timed.pop("losses")
        launches = {"lstm_fwd": lstm.launches_fwd,
                    "lstm_fwd_res": lstm.launches_fwd_res,
                    "lstm_bwd": lstm.launches_bwd}
        steps_run = TRAIN["warmup"] + TRAIN["steps"]
        if launches != {"lstm_fwd": 0, "lstm_fwd_res": steps_run,
                        "lstm_bwd": steps_run}:
            raise AssertionError(f"dist-train LSTM launch counts {launches}"
                                 f" over {steps_run} steps")
        losses = [float(x) for x in losses]
        if losses != train_losses:
            bad = [i for i, (a, b) in enumerate(zip(losses, train_losses))
                   if a != b]
            raise AssertionError(f"dist-train losses differ from the train "
                                 f"phase's at steps {bad[:5]}: "
                                 f"{losses[:3]} vs {train_losses[:3]}")
        prof = nccl_profile(torch, sess, batches)
        summary = {"card": card, "world": dist.get_world_size(),
                   "backend": dist.get_backend(),
                   "losses_bitwise_equal_train": True, **timed, **prof,
                   "capture": capture, "launches": launches}
        log(f"[dist-train] {json.dumps(summary)}")
        sess.close()
        return summary
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def timed_steps_losses(torch, sess, batches, steps):
    """``timed_steps`` keeping every step's loss: words/s and step ms
    (CUDA events between step ends) p50 and p95."""
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    t0 = time.perf_counter()
    words, losses = 0.0, []
    feed = (batches[i % 4] for i in range(steps))
    for i, loss in enumerate(sess.run_iter(feed, fetches="loss")):
        losses.append(loss)
        words += float(batches[i % 4]["w"].sum())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    float(losses[-1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return {"words_per_sec": words / wall,
            "step_ms_p50": statistics.median(step_ms),
            "step_ms_p95": p95(step_ms), "losses": losses}


def nccl_profile(torch, sess, batches):
    """``PAIR["profile_steps"]`` steps under the profiler's CPU and CUDA
    activity: the card's busy ms and idle share, NCCL's kernels' device
    ms a step and share of busy, the host's launch calls a step; the
    steps must launch the persistent LSTM kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps = PAIR["profile_steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        last = None
        for i in range(steps):
            last = sess.run("loss", feed_dict=batches[i % 4])
        float(last)
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    busy_us = nccl_us = 0.0
    api, rows, nccl = {}, [], {}
    for evt in prof.key_averages():
        if evt.key in LAUNCH_APIS:
            api[evt.key] = evt.count
        elif evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0))
            busy_us += us
            rows.append((us, evt.count, evt.key))
            if "nccl" in evt.key.lower():
                nccl_us += us
                nccl[evt.key[:90]] = evt.count
    lstm_kernels_seen(rows, ["lstm_fwd_kernel_sm90", "lstm_bwd_kernel_sm90"])
    return {"profile_steps": steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_idle_share": 1.0 - busy_us / 1e6 / window,
            "nccl_ms_per_step": nccl_us / 1e3 / steps,
            "nccl_share_of_busy": nccl_us / busy_us if busy_us else 0.0,
            "nccl_kernels": nccl,
            "host_launches_per_step": sum(api.values()) / steps,
            "host_launch_calls": api}


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
    from parallax_tpu_torch.models import nmt
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
    capture = capture_train(torch, sess, NMT_TRAIN["batch"])
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
        "launches": launches, "capture": capture}
    log(f"[nmt-train] {json.dumps({k: v for k, v in summary.items() if k != 'losses'})}")
    profile = profile_train(
        torch, sess, batches, label="nmt-train-profile",
        flash=["flash_fwd_kernel_sm90", "flash_dq_kernel_sm90",
               "flash_dkv_kernel_sm90"])
    summary["graph_pair"] = graph_pair(
        torch, sess, batches,
        lambda b: float((b["tgt_out"] > nmt.PAD_ID).sum()), "nmt")
    summary["graph_pair"]["graph"].update(capture)
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


# -- bert-train and bert-agree: BERT-large pretraining ------------------------

# BERT-large at its published widths (BertConfig(): vocab 30522, hidden
# 1024, 16 heads of 64, MLP 4096, 24 layers, max_len 512), batches of
# 32 x 512 with 80 masked positions a row (BERT's max_predictions_per_seq
# at length 512), each row padded after a length drawn in [384, 512]
# (numpy seed 0) and its masked positions in the padding weighted 0; the
# step's graph captured by sess.warmup, then 10 timed steps
BERT_TRAIN = dict(batch=32, seq=512, masked=80, min_len=384, steps=10,
                  profile_steps=3, agree_batch=8, agree_steps=3,
                  agree_tol=2e-3)
# busy-time groups of the BERT step, by kernel name (first match wins):
# cuBLAS names its fp32 kernels sgemm / nvjet_s* / *f32f32_f32f32*
BERT_GROUPS = (
    ("flash B4-B6", r"flash_\w*kernel"),
    ("fp32 GEMMs (MLM and NSP heads)",
     r"(?i)sgemm|nvjet_s|f32f32_f32f32|gemm_f32"),
    ("bf16 GEMMs", r"(?i)gemm|nvjet|xmma|cutlass|cublas"),
    ("optimizer (multi-tensor)", r"(?i)multi_tensor|foreach"),
    ("reductions (LayerNorm statistics, sums)", r"(?i)reduce"),
    ("softmax", r"(?i)softmax"),
    ("elementwise (LayerNorm, GELU, residuals, casts)",
     r"(?i)elementwise|vectorized|unrolled"),
    ("copies and fills", r"(?i)copy|memcpy|memset|fill|cat"),
)


def bert_session(torch, **cfg_kw):
    """BertConfig() through parallel_run HYBRID on the card, seed 0."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import bert
    cfg = bert.BertConfig(num_partitions=1, **cfg_kw)
    sess, *_ = pt.parallel_run(
        bert.build_model(cfg), parallax_config=pt.Config(run_option="HYBRID"),
        seed=SEED, device=DEVICE)
    return cfg, sess


def bert_batches(cfg, batch, n=4):
    """``n`` ``make_batch`` batches, each row padded after a length in
    [min_len, seq], its masked positions in the padding weighted 0."""
    from parallax_tpu_torch.models import bert
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(n):
        b = bert.make_batch(rng, batch, BERT_TRAIN["seq"],
                            BERT_TRAIN["masked"], cfg.vocab_size)
        lengths = rng.integers(BERT_TRAIN["min_len"], BERT_TRAIN["seq"] + 1,
                               batch)
        for i, n_i in enumerate(lengths):
            b["input_ids"][i, n_i:] = 0
        b["mask_weights"] = (b["mask_positions"]
                             < lengths[:, None]).astype(np.float32)
        out.append(b)
    return out


def bert_model_flops(cfg, batch):
    """Model FLOPs of one training step (forward x 3), counted dense from
    the shapes: the blocks' bf16 products (q/k/v, output, MLP, and the
    attention's two T x T products over every position, padding
    included), and the fp32 heads (MLM at the masked positions: dense and
    the [D, V] output; NSP)."""
    D, M, V, L = cfg.hidden_dim, cfg.mlp_dim, cfg.padded_vocab, \
        cfg.num_layers
    T, masked = BERT_TRAIN["seq"], BERT_TRAIN["masked"]
    tokens = batch * T
    block = (2 * tokens * D * 3 * D + 2 * tokens * D * D
             + 2 * 2 * tokens * D * M + 2 * 2 * batch * T * T * D)
    heads = (2 * batch * masked * (D * D + D * V)
             + 2 * batch * (D * D + 2 * D))
    return {"bf16_tflop": 3 * L * block / 1e12,
            "fp32_tflop": 3 * heads / 1e12,
            "mlm_out_fwd_gflop": 2 * batch * masked * D * V / 1e9}


def profile_bert(torch, sess, batches):
    return profile_groups(torch, sess, batches, BERT_TRAIN["profile_steps"],
                          BERT_GROUPS)


def profile_groups(torch, sess, batches, steps, groups_of):
    """``steps`` steps under the profiler's CUDA activity: busy ms a step,
    the idle share, busy by ``groups_of`` ((name, kernel-name pattern),
    first match wins) and the top kernels; the steps must launch the
    three sm90 flash kernels and no first one."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        last = None
        for i in range(steps):
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
    busy_us = sum(us for us, _, _ in rows)
    groups = {name: 0.0 for name, _ in groups_of}
    groups["other"] = 0.0
    for us, _, key in rows:
        name = next((n for n, pat in groups_of if re.search(pat, key)),
                    "other")
        groups[name] += us
    rows.sort(reverse=True)
    return {"steps": steps, "window_s": window,
            "flash_kernels": flash_kernels_seen(
                rows, ["flash_fwd_kernel_sm90", "flash_dq_kernel_sm90",
                       "flash_dkv_kernel_sm90"]),
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_idle_share": 1.0 - busy_us / 1e6 / window,
            "device_launches_per_step": sum(n for _, n, _ in rows) / steps,
            "busy_ms_per_step_by_group": {
                k: v / 1e3 / steps for k, v in groups.items()},
            "busy_share_by_group": {k: v / busy_us if busy_us else 0.0
                                    for k, v in groups.items()},
            "top": [{"name": key[:110], "calls": n, "ms": us / 1e3,
                     "share_of_busy": us / busy_us}
                    for us, n, key in rows[:15]]}


def phase_bert_train(torch, card):
    """BERT-large through parallel_run HYBRID with the flash kernels, bf16
    compute: ``sess.warmup`` captures the step, then ``steps`` timed
    steps (sequences/s, step ms p50 and p95 from CUDA events, peak
    memory, the model FLOPs' share of 989 TF/s); B4, B5 and B6 24 times
    a step each; every loss finite; then ``profile_bert``."""
    from parallax_tpu_torch.ops import flash_attention as fa
    torch.cuda.empty_cache()
    cfg, sess = bert_session(torch, use_pallas_attention=True)
    batches = bert_batches(cfg, BERT_TRAIN["batch"])
    t_build = time.perf_counter()
    sess.prepare(batches[0])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    sparse = sorted(p for p, v in sess.engine.plan.var_specs.items()
                    if v.is_sparse)
    if sparse != ["word_emb"]:
        raise AssertionError(f"classifier found {sparse} sparse, expected "
                             f"['word_emb']")
    capture = capture_train(torch, sess, BERT_TRAIN["batch"])
    for name in FLASH_COUNTERS:
        setattr(fa, name, 0)
    steps = BERT_TRAIN["steps"]
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    t0 = time.perf_counter()
    losses, masked = [], []
    feed = (batches[i % 4] for i in range(steps))
    for loss, m in sess.run_iter(feed, fetches=["loss", "masked_tokens"]):
        losses.append(loss)
        masked.append(m)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.launches,
                "flash_attention_dq": fa.launches_dq,
                "flash_attention_dkv": fa.launches_dkv}
    per_step = {k: v / steps for k, v in launches.items()}
    if set(per_step.values()) != {float(cfg.num_layers)}:
        raise AssertionError(f"BERT flash launches a step {per_step}: want "
                             f"{cfg.num_layers} of each")
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite BERT loss: {losses}")
    want_masked = [float(batches[i % 4]["mask_weights"].sum())
                   for i in range(steps)]
    if [float(m) for m in masked] != want_masked:
        raise AssertionError(f"masked_tokens {masked} != {want_masked}")
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    seq_per_s = steps * BERT_TRAIN["batch"] / wall
    flops = bert_model_flops(cfg, BERT_TRAIN["batch"])
    step_flop = (flops["bf16_tflop"] + flops["fp32_tflop"]) * 1e12
    p50 = statistics.median(step_ms)
    summary = {
        "card": card,
        "config": {"vocab": cfg.vocab_size, "hidden": cfg.hidden_dim,
                   "heads": cfg.num_heads, "mlp": cfg.mlp_dim,
                   "layers": cfg.num_layers, "compute": "bfloat16",
                   "run_option": "HYBRID", **{k: BERT_TRAIN[k] for k in (
                       "batch", "seq", "masked", "min_len")}},
        "sequences_per_sec": seq_per_s, "timed_steps": steps,
        "wall_s": wall, "step_ms_p50": p50, "step_ms_p95": p95(step_ms),
        "losses": losses, "engine_build_s": build_s, "sparse": sparse,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "model_flops": flops,
        "share_of_bf16_peak": seq_per_s / BERT_TRAIN["batch"] * step_flop
        / PEAK_OPS_PER_S["bfloat16"],
        "share_of_bf16_peak_at_p50": step_flop / (p50 * 1e-3)
        / PEAK_OPS_PER_S["bfloat16"],
        "launches": launches, "launches_per_step": per_step,
        "capture": capture}
    summary["profile"] = prof = profile_bert(torch, sess, batches)
    # the timed steps' idle share: the profiled window also holds the
    # profiler's own start
    summary["timed_idle_share"] = 1.0 - prof["device_busy_ms_per_step"] \
        / (wall * 1e3 / steps)
    log(f"[bert-train] {json.dumps(summary)}")
    sess.close()
    torch.cuda.empty_cache()
    return summary


def phase_bert_agree(torch):
    """``agree_steps`` steps of BERT-large (bf16, batch ``agree_batch``)
    from one init, eagerly, through the flash kernels and through the
    plain attention core: per-step losses within 2e-3 relative, the
    tolerance of the JAX package's flash-against-XLA BERT test
    (tests/test_bert.py:55)."""
    losses = {}
    for name, pallas in (("flash", True), ("plain", False)):
        cfg, sess = bert_session(torch, use_pallas_attention=pallas)
        batches = bert_batches(cfg, BERT_TRAIN["agree_batch"])
        with mode_ctx("eager"):
            losses[name] = [float(sess.run("loss", feed_dict=batches[i]))
                            for i in range(BERT_TRAIN["agree_steps"])]
        sess.close()
        del sess
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["flash"],
                                               losses["plain"])]
    summary = {"losses": losses, "max_rel_diff": max(rel),
               "tol": BERT_TRAIN["agree_tol"]}
    log(f"[bert-agree] {json.dumps(summary)}")
    if not (all(math.isfinite(x) for v in losses.values() for x in v)
            and max(rel) <= BERT_TRAIN["agree_tol"]):
        raise AssertionError(f"BERT flash and plain losses differ by "
                             f"{max(rel)} relative > "
                             f"{BERT_TRAIN['agree_tol']}: {losses}")
    return summary


# -- the long-context causal LM: lc-train, lc-agree, lc-serve -----------------

# LongContextConfig() at its published widths (vocab 32000, D 512, 8 heads
# of 64, MLP 2048, 6 layers, max_len 32768, bf16, parallelism 'ring': one
# block on one card) through parallel_run HYBRID, batches of 8 x 8192
# (examples/long_context_driver.py's default batch and sequence), the
# step's graph captured by sess.warmup, then 10 timed steps
LC_TRAIN = dict(batch=8, seq=8192, steps=10, profile_steps=3, agree_batch=2,
                agree_seq=2048, agree_steps=3, agree_tol=2e-3)
LC_GROUPS = (
    ("flash B4-B6", r"flash_\w*kernel"),
    ("fp32 head products ([65536, 512] x [512, 32000])",
     r"(?i)sgemm|nvjet_s|f32f32_f32f32|gemm_f32"),
    ("bf16 GEMMs", r"(?i)gemm|nvjet|xmma|cutlass|cublas"),
    ("Adam and the clip (multi-tensor)", r"(?i)multi_tensor|foreach"),
    ("log-softmax", r"(?i)softmax"),
    ("reductions (LayerNorm statistics, sums)", r"(?i)reduce"),
    ("elementwise (LayerNorm, ReLU, residuals, casts)",
     r"(?i)elementwise|vectorized|unrolled"),
    ("copies, fills and gathers", r"(?i)copy|memcpy|memset|fill|cat|gather|"
                                  r"index"),
)
# lc-serve: LongContextConfig() behind CausalLMDecodeProgram with prompts
# padded to 512, at most 256 new tokens, 48 pages of 16 a slot over a
# 3072-page pool (64 slots x 48), 64 slots; 256 requests with prompt
# lengths drawn in [64, 512] and ids in [1, 32000)
LC_SERVE = dict(max_src_len=512, max_len=256, page_size=16, pool_pages=3072,
                max_batch=64, max_queue=512, requests=256, min_prompt=64,
                profile_requests=64, agree_requests=32)


def lc_session(torch, **cfg_kw):
    """LongContextConfig() through parallel_run HYBRID on the card, seed
    0."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import long_context as lc
    cfg = lc.LongContextConfig(**cfg_kw)
    sess, *_ = pt.parallel_run(
        lc.build_model(cfg), parallax_config=pt.Config(run_option="HYBRID"),
        seed=SEED, device=DEVICE)
    return cfg, sess


def lc_batches(cfg, batch, seq, n=4):
    from parallax_tpu_torch.models import long_context as lc
    rng = np.random.default_rng(SEED)
    return [lc.make_batch(rng, batch, seq, cfg.vocab_size) for _ in range(n)]


def lc_model_flops(cfg, batch, seq):
    """Model FLOPs of one training step (forward x 3) from the shapes: the
    blocks' bf16 products (q/k/v, output, MLP, and the attention's two
    T x T products counted over the causal half), and the fp32 head."""
    D, M, V, L = cfg.model_dim, cfg.mlp_dim, cfg.vocab_size, cfg.num_layers
    tokens = batch * seq
    block = (2 * tokens * D * 3 * D + 2 * tokens * D * D
             + 2 * 2 * tokens * D * M + 2 * 2 * batch * seq * seq * D // 2)
    return {"bf16_tflop": 3 * L * block / 1e12,
            "fp32_tflop": 3 * 2 * tokens * D * V / 1e12}


def phase_lc_train(torch, card):
    """The long-context LM through parallel_run HYBRID on one card, bf16:
    ``sess.warmup`` captures the step, then ``steps`` timed steps (tokens
    a second, step ms p50 and p95 from CUDA events, peak memory, the
    model FLOPs' share of 989 TF/s); the ring's one block must run B4, B5
    and B6 once a layer a step (6 each), every loss finite, ``tokens`` B
    (T - 1); then ``profile_groups`` by ``LC_GROUPS``."""
    from parallax_tpu_torch.ops import flash_attention as fa
    torch.cuda.empty_cache()
    cfg, sess = lc_session(torch)
    B, T, steps = LC_TRAIN["batch"], LC_TRAIN["seq"], LC_TRAIN["steps"]
    batches = lc_batches(cfg, B, T)
    t_build = time.perf_counter()
    sess.prepare(batches[0])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    if sess.engine.batch_layout != "sequence":
        raise AssertionError(f"the ring model's batch layout is "
                             f"{sess.engine.batch_layout}, not sequence")
    capture = capture_train(torch, sess, B)
    for name in FLASH_COUNTERS:
        setattr(fa, name, 0)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    t0 = time.perf_counter()
    losses, tokens = [], []
    feed = (batches[i % 4] for i in range(steps))
    for loss, tok in sess.run_iter(feed, fetches=["loss", "tokens"]):
        losses.append(loss)
        tokens.append(tok)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.launches,
                "flash_attention_dq": fa.launches_dq,
                "flash_attention_dkv": fa.launches_dkv}
    per_step = {k: v / steps for k, v in launches.items()}
    if set(per_step.values()) != {float(cfg.num_layers)}:
        raise AssertionError(f"lc-train flash launches a step {per_step}: "
                             f"want {cfg.num_layers} of each (the ring's "
                             f"one block a layer)")
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite lc-train loss: {losses}")
    if [float(t) for t in tokens] != [float(B * (T - 1))] * steps:
        raise AssertionError(f"tokens {tokens} != {B * (T - 1)}")
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    p50 = statistics.median(step_ms)
    flops = lc_model_flops(cfg, B, T)
    step_flop = (flops["bf16_tflop"] + flops["fp32_tflop"]) * 1e12
    summary = {
        "card": card,
        "config": {"vocab": cfg.vocab_size, "model_dim": cfg.model_dim,
                   "heads": cfg.num_heads, "mlp": cfg.mlp_dim,
                   "layers": cfg.num_layers, "parallelism": cfg.parallelism,
                   "compute": "bfloat16", "run_option": "HYBRID",
                   "batch": B, "seq": T},
        "tokens_per_sec": steps * B * T / wall, "timed_steps": steps,
        "wall_s": wall, "step_ms_p50": p50, "step_ms_p95": p95(step_ms),
        "losses": losses, "engine_build_s": build_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "model_flops": flops,
        "share_of_bf16_peak": steps / wall * step_flop
        / PEAK_OPS_PER_S["bfloat16"],
        "share_of_bf16_peak_at_p50": step_flop / (p50 * 1e-3)
        / PEAK_OPS_PER_S["bfloat16"],
        "launches": launches, "launches_per_step": per_step,
        "capture": capture}
    summary["profile"] = prof = profile_groups(
        torch, sess, batches, LC_TRAIN["profile_steps"], LC_GROUPS)
    summary["timed_idle_share"] = 1.0 - prof["device_busy_ms_per_step"] \
        / (wall * 1e3 / steps)
    log(f"[lc-train] {json.dumps(summary)}")
    sess.close()
    torch.cuda.empty_cache()
    return summary


def phase_lc_agree(torch):
    """``agree_steps`` eager steps of the same model at batch 2 x 2048 from
    one init: the ring with flash blocks (B4-B6, 6 launches a step each)
    against the plain causal core (``parallelism='data'``: the math of the
    ring's one plain block); losses within 2e-3 relative
    (tests/test_long_context.py:34's tolerance)."""
    from parallax_tpu_torch.ops import flash_attention as fa
    losses, launches = {}, {}
    for name, kw in (("ring_flash", {}), ("plain", {"parallelism": "data"})):
        cfg, sess = lc_session(torch, **kw)
        batches = lc_batches(cfg, LC_TRAIN["agree_batch"],
                             LC_TRAIN["agree_seq"], LC_TRAIN["agree_steps"])
        before = fa.launches
        with mode_ctx("eager"):
            losses[name] = [float(sess.run("loss", feed_dict=b))
                            for b in batches]
        launches[name] = fa.launches - before
        sess.close()
        del sess
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["ring_flash"],
                                               losses["plain"])]
    summary = {"losses": losses, "max_rel_diff": max(rel),
               "tol": LC_TRAIN["agree_tol"], "flash_launches": launches}
    log(f"[lc-agree] {json.dumps(summary)}")
    want = {"ring_flash": LC_TRAIN["agree_steps"] * 6, "plain": 0}
    if launches != want:
        raise AssertionError(f"lc-agree B4 launches {launches} != {want}")
    if not (all(math.isfinite(x) for v in losses.values() for x in v)
            and max(rel) <= LC_TRAIN["agree_tol"]):
        raise AssertionError(f"ring (flash) and plain losses differ by "
                             f"{max(rel)} relative > "
                             f"{LC_TRAIN['agree_tol']}: {losses}")
    return summary


def lc_prompts(n, rng, vocab):
    return [rng.integers(1, vocab, (int(rng.integers(
        LC_SERVE["min_prompt"], LC_SERVE["max_src_len"] + 1)),))
        .astype(np.int32) for _ in range(n)]


def lc_serve(torch, cfg, params, prompts, program=None, **prog_kw):
    """``prompts`` through ServeSession(program(...)), the program class
    ``CausalLMDecodeProgram`` by default, each to the program's cap:
    (outputs, wall s, stats, program)."""
    import parallax_tpu_torch as pt
    kw = dict(page_size=LC_SERVE["page_size"],
              pool_pages=LC_SERVE["pool_pages"], attn_impl="kernel")
    kw.update(prog_kw)
    prog = (program or pt.CausalLMDecodeProgram)(
        cfg, max_src_len=LC_SERVE["max_src_len"],
        max_len=LC_SERVE["max_len"], device=DEVICE, **kw)
    sess = pt.ServeSession(
        program=prog, params=params, device=DEVICE,
        config=pt.Config(serve_config=pt.ServeConfig(
            max_batch=LC_SERVE["max_batch"],
            max_queue=LC_SERVE["max_queue"])))
    t0 = time.perf_counter()
    try:
        reqs = [sess.submit({"ids": p}) for p in prompts]
        outs = [r.result(timeout=900) for r in reqs]
        wall = time.perf_counter() - t0
    finally:
        sess.close()
    cap = LC_SERVE["max_len"]
    for out in outs:
        if out.ndim != 1 or not 1 <= len(out) <= cap:
            raise AssertionError(f"bad output length {out.shape}")
        if out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError("token out of range")
        if len(out) < cap and out[-1] != 0:
            raise AssertionError("a request stopped early without EOS")
    return outs, wall, sess.stats(), prog


def phase_lc_serve(torch, cfg, params, prompts, label="lc-serve",
                   program=None):
    """The long-context LM (or, with ``program``, another causal LM)
    served: the scheduler's warmup captures the prefill and the decode
    step; B7 must launch 6 times a decode step (plus the warmup's eager
    call), B4 never (the prefill runs the plain causal attention, as in
    JAX), and no page may stay in use after close."""
    from parallax_tpu_torch.ops import flash_attention as fa
    from parallax_tpu_torch.ops import paged_attention as pa
    torch.cuda.synchronize()
    fa.launches = pa.launches = pa.launches_combine = 0
    outs, wall, stats, prog = lc_serve(torch, cfg, params, prompts,
                                       program=program)
    torch.cuda.synchronize()
    L = cfg.num_layers
    plan = pa.split_plan(LC_SERVE["max_batch"], cfg.num_heads,
                         cfg.model_dim // cfg.num_heads, prog.pages_per_seq,
                         LC_SERVE["page_size"], 2,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    launches = {"paged_decode_attention": pa.launches,
                "flash_attention_fwd": fa.launches}
    want = {"paged_decode_attention": (stats["serve.decode_steps"] + 1) * L,
            "flash_attention_fwd": 0}
    want_combine = want["paged_decode_attention"] * int(plan.nsplit > 1)
    if launches != want or pa.launches_combine != want_combine:
        raise AssertionError(f"{label} launches {launches}, combine "
                             f"{pa.launches_combine} != {want}, "
                             f"{want_combine} ({plan})")
    if stats["serve.kv_pages_in_use"] != 0:
        raise AssertionError(f"{stats['serve.kv_pages_in_use']} KV pages "
                             f"left in use after close")
    if stats["serve.completed"] != len(prompts):
        raise AssertionError(f"{stats['serve.completed']} of "
                             f"{len(prompts)} requests completed")
    if prog._graphs is None:
        raise AssertionError(f"{label}: the program captured no graphs")
    tokens = int(sum(len(o) for o in outs))
    summary = {"requests": len(prompts), "tokens": tokens, "wall_s": wall,
               "prompt_tokens": int(sum(len(p) for p in prompts)),
               "tokens_per_sec": tokens / wall,
               "ttft_ms_p50": stats["serve.ttft_ms"]["p50"],
               "ttft_ms_p95": stats["serve.ttft_ms"]["p95"],
               "step_ms_p50": stats["serve.step_ms"]["p50"],
               "step_ms_p95": stats["serve.step_ms"]["p95"],
               "decode_steps": stats["serve.decode_steps"],
               "prefills": stats["serve.prefills"],
               "kv_refill_deferred": stats["serve.kv_refill_deferred"],
               "launches": launches,
               "paged_combine_launches": pa.launches_combine,
               "paged_plan": plan._asdict(),
               "capture_s": stats["serve.compile_seconds"]["max"]}
    log(f"[{label}] {json.dumps(summary)}")
    return summary


def phase_lc_serve_profile(torch, cfg, params, prompts,
                           label="lc-serve-profile", program=None):
    """``profile_requests`` requests under the profiler's CUDA activity:
    busy and B7 ms a decode step, the idle share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, stats, _ = lc_serve(torch, cfg, params, prompts,
                                  program=program)
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total",
                     getattr(evt, "cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, evt.count, evt.key))
    busy_s = sum(us for us, _, _ in rows) / 1e6
    paged_s = sum(us for us, _, key in rows if "paged_" in key) / 1e6
    rows.sort(reverse=True)
    steps = stats["serve.decode_steps"]
    summary = {"requests": len(prompts), "window_s": window,
               "device_busy_s": busy_s,
               "device_idle_share": 1.0 - busy_s / window,
               "decode_steps": steps, "prefills": stats["serve.prefills"],
               "busy_ms_per_decode_step": busy_s * 1e3 / steps,
               "paged_ms_per_decode_step": paged_s * 1e3 / steps,
               "paged_share_of_busy": paged_s / busy_s,
               "paged_kernels": paged_kernels_seen(rows),
               "top": [{"name": key[:90], "calls": n, "ms": us / 1e3,
                        "share_of_busy": us / 1e6 / busy_s}
                       for us, n, key in rows[:10]]}
    log(f"[{label}] {json.dumps(summary)}")
    return summary


def lc_top2_gap(torch, prog, params, prompt, position):
    """The dense plain program's top-2 logit gap and the two tokens at
    decode ``position`` of one request (its own greedy prefix fed
    back), through the program's model module."""
    lc = prog._mod
    cp = prog._compute_params(params)
    rs = prog.prefill(params, prog.prepare_feed({"ids": prompt}))
    state = prog.init_state(params, 1)
    prog.insert(state, 0, rs)
    tok = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
    for t in range(position + 1):
        logits, _, _ = lc._decode_step_cached(
            prog.cfg, cp, tok, torch.full((1,), t, dtype=torch.int32,
                                          device=DEVICE),
            state["base"], state["first"], state["kc"], state["vc"])
        tok = logits.argmax(dim=-1).to(torch.int32)
    top = logits[0].topk(2)
    return (top.values[0] - top.values[1]).item(), top.indices.tolist()


def phase_lc_serve_agree(torch, params, prompts, label="lc-serve-agree",
                         cfg=None, program=None):
    """``agree_requests`` requests served in fp32 (TF32 off) through the
    B7 kernel against ``standalone_greedy`` of the dense program (plain
    attention, no kernel), request by request; a difference passes only
    where the plain path's top-2 logit gap is at most 1e-3 (a near tie),
    as in the NMT agreement phase. The long-context LM by default; a
    ``cfg`` (fp32) and its ``program`` class for another causal LM."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import long_context as lc
    from parallax_tpu_torch.serve import standalone_greedy
    if cfg is None:
        cfg = lc.LongContextConfig(compute_dtype=torch.float32)
    program = program or pt.CausalLMDecodeProgram
    outs, _, stats, _ = lc_serve(torch, cfg, params, prompts,
                                 program=program)
    dense = program(cfg, LC_SERVE["max_src_len"], LC_SERVE["max_len"],
                    device=DEVICE)
    mismatches = []
    for i, (p, out) in enumerate(zip(prompts, outs)):
        ref = np.asarray(standalone_greedy(dense, params, {"ids": p},
                                           LC_SERVE["max_len"]))
        if len(ref) == len(out) and np.array_equal(ref, out):
            continue
        n = min(len(ref), len(out))
        first = int(np.flatnonzero(ref[:n] != out[:n])[0]) if \
            not np.array_equal(ref[:n], out[:n]) else n
        gap, top2 = lc_top2_gap(torch, dense, params, p, first)
        mismatches.append({"request": i, "position": first,
                           "top2_gap": gap, "top2_tokens": top2})
        log(f"[{label}] request {i}: first difference at position "
            f"{first}, plain top-2 logit gap {gap:.3g} between {top2}")
        if not gap <= 1e-3:
            raise AssertionError(
                f"request {i} differs at position {first} where the plain "
                f"path's top-2 gap is {gap:.3g} > 1e-3")
    summary = {"requests": len(prompts), "identical":
               len(prompts) - len(mismatches), "near_ties": mismatches,
               "kv_pages_in_use": stats["serve.kv_pages_in_use"]}
    if stats["serve.kv_pages_in_use"] != 0:
        raise AssertionError(f"KV pages left in use in {label}")
    log(f"[{label}] {json.dumps(summary)}")
    return summary


# -- phases 12h-12l: the switch-MoE LM and NMT beam search --------------------

# moe-train: MoeLMConfig() (vocab 32000, D 512, 8 heads of 64, expert_dim
# 1024, 16 experts, top-1, 6 layers, bf16) with the flash kernels, batches
# of 16 x 1024 (the model's max_len; no JAX example fixes a batch for this
# model, its tests use 8 x 16)
MOE_TRAIN = dict(batch=16, seq=1024, steps=10, profile_steps=3,
                 agree_batch=4, agree_steps=3, agree_tol=2e-3)
MOE_GROUPS = (
    ("flash B4-B6", r"flash_\w*kernel"),
    ("bf16-operand products on cuBLAS's sgemmEx (fp32 compute)",
     r"sgemmEx_kernel<float, __nv_bfloat16"),
    ("fp32 head and router products ([16384, 512] x [512, 32000])",
     r"(?i)sgemm|nvjet_s|f32f32_f32f32|gemm_f32"),
    ("bf16 GEMMs (the expert einsums, 94 % of their FLOPs; projections)",
     r"(?i)gemm|nvjet|xmma|cutlass|cublas"),
    ("Adam and the clip (multi-tensor)", r"(?i)multi_tensor|foreach"),
    ("log-softmax", r"(?i)softmax"),
    ("routing: sort, scatter, gather, index", r"(?i)sort|radix|scatter|"
                                             r"gather|index"),
    ("reductions (LayerNorm statistics, sums)", r"(?i)reduce"),
    ("elementwise (LayerNorm, ReLU, gates, residuals, casts)",
     r"(?i)elementwise|vectorized|unrolled"),
    ("copies and fills", r"(?i)copy|memcpy|memset|fill|cat"),
)
# nmt-beam: examples/nmt_eval.py's widths and defaults (vocab 32000, D 512,
# 8 heads, MLP 2048, 6 + 6 layers, max_len 128, beam 4, length penalty
# 1.0, batch 16, sources of max_len // 2 ids from numpy seed 123)
NMT_BEAM = dict(max_len=128, beam=4, alpha=1.0, batch=16, src_len=64,
                calls=3, agree_tol=1e-3)


def moe_session(torch, **cfg_kw):
    """MoeLMConfig() through parallel_run HYBRID on the card, seed 0."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import moe_lm
    cfg = moe_lm.MoeLMConfig(**cfg_kw)
    sess, *_ = pt.parallel_run(
        moe_lm.build_model(cfg),
        parallax_config=pt.Config(run_option="HYBRID"), seed=SEED,
        device=DEVICE)
    return cfg, sess


def moe_batches(cfg, batch, seq, n=4):
    from parallax_tpu_torch.models import moe_lm
    rng = np.random.default_rng(SEED)
    return [moe_lm.make_batch(rng, batch, seq, cfg.vocab_size)
            for _ in range(n)]


def moe_model_flops(cfg, batch, seq):
    """FLOPs of one training step (forward x 3) from the shapes: the bf16
    products (q/k/v, output, the causal half of the attention's two
    T x T products, the experts) counted once over the routed work (each
    token through its top-k experts) and once as executed (the dense
    fallback of one card runs every expert on every token, then the
    gates' combine), and the fp32 head and router products."""
    D, F, E, V, L = (cfg.model_dim, cfg.expert_dim, cfg.num_experts,
                     cfg.vocab_size, cfg.num_layers)
    tokens = batch * seq
    attn = (2 * tokens * D * 3 * D + 2 * tokens * D * D
            + 2 * 2 * batch * seq * seq * D // 2)
    routed = 2 * 2 * tokens * D * F * cfg.top_k
    executed = 2 * 2 * tokens * D * F * E + 2 * tokens * E * D
    return {"bf16_routed_tflop": 3 * L * (attn + routed) / 1e12,
            "bf16_executed_tflop": 3 * L * (attn + executed) / 1e12,
            "fp32_tflop": 3 * (2 * tokens * D * V
                               + L * 2 * tokens * D * E) / 1e12}


def phase_moe_train(torch, card):
    """The MoE LM through parallel_run HYBRID on one card, bf16, with the
    flash kernels: ``sess.warmup`` captures the step, then ``steps`` timed
    steps (tokens a second, step ms p50 and p95 from CUDA events, peak
    memory, the routed and executed FLOPs' shares of 989 TF/s); B4, B5
    and B6 must launch once a layer a step (6 each), every loss finite
    and the last below the first, ``moe_dropped`` 0 (one card runs the
    dense path); then ``profile_groups`` by ``MOE_GROUPS``."""
    from parallax_tpu_torch.ops import flash_attention as fa
    torch.cuda.empty_cache()
    cfg, sess = moe_session(torch, use_pallas_attention=True)
    B, T, steps = MOE_TRAIN["batch"], MOE_TRAIN["seq"], MOE_TRAIN["steps"]
    batches = moe_batches(cfg, B, T)
    t_build = time.perf_counter()
    sess.prepare(batches[0])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    placements = set(sess.engine.plan.placements.values())
    if placements != {"replicated"}:
        raise AssertionError(f"moe-train on one card: placements "
                             f"{placements}, want every variable whole")
    capture = capture_train(torch, sess, B)
    for name in FLASH_COUNTERS:
        setattr(fa, name, 0)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    t0 = time.perf_counter()
    outs = []
    feed = (batches[i % 4] for i in range(steps))
    for out in sess.run_iter(feed, fetches=["loss", "lm_loss", "aux_loss",
                                            "moe_dropped"]):
        outs.append(out)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.launches,
                "flash_attention_dq": fa.launches_dq,
                "flash_attention_dkv": fa.launches_dkv}
    per_step = {k: v / steps for k, v in launches.items()}
    if set(per_step.values()) != {float(cfg.num_layers)}:
        raise AssertionError(f"moe-train flash launches a step {per_step}: "
                             f"want {cfg.num_layers} of each")
    losses, lm, aux, dropped = ([float(o[i]) for o in outs]
                                for i in range(4))
    if not all(math.isfinite(x) for x in losses + aux):
        raise AssertionError(f"non-finite moe-train loss: {losses} {aux}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"moe-train loss did not fall: {losses}")
    if any(d != 0.0 for d in dropped):
        raise AssertionError(f"moe_dropped {dropped} on the dense path")
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    p50 = statistics.median(step_ms)
    flops = moe_model_flops(cfg, B, T)
    routed = (flops["bf16_routed_tflop"] + flops["fp32_tflop"]) * 1e12
    executed = (flops["bf16_executed_tflop"] + flops["fp32_tflop"]) * 1e12
    summary = {
        "card": card,
        "config": {"vocab": cfg.vocab_size, "model_dim": cfg.model_dim,
                   "heads": cfg.num_heads, "expert_dim": cfg.expert_dim,
                   "experts": cfg.num_experts, "top_k": cfg.top_k,
                   "layers": cfg.num_layers, "compute": "bfloat16",
                   "run_option": "HYBRID", "batch": B, "seq": T},
        "tokens_per_sec": steps * B * T / wall, "timed_steps": steps,
        "wall_s": wall, "step_ms_p50": p50, "step_ms_p95": p95(step_ms),
        "losses": losses, "lm_losses": lm, "aux_losses": aux,
        "moe_dropped": dropped, "engine_build_s": build_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "model_flops": flops,
        "routed_share_of_bf16_peak": steps / wall * routed
        / PEAK_OPS_PER_S["bfloat16"],
        "executed_share_of_bf16_peak": steps / wall * executed
        / PEAK_OPS_PER_S["bfloat16"],
        "launches": launches, "launches_per_step": per_step,
        "capture": capture}
    summary["profile"] = prof = profile_groups(
        torch, sess, batches, MOE_TRAIN["profile_steps"], MOE_GROUPS)
    summary["timed_idle_share"] = 1.0 - prof["device_busy_ms_per_step"] \
        / (wall * 1e3 / steps)
    log(f"[moe-train] {json.dumps(summary)}")
    sess.close()
    torch.cuda.empty_cache()
    return summary


def phase_moe_agree(torch):
    """``agree_steps`` eager steps of the same model at batch 4 x 1024 from
    one init, the flash kernels (B4-B6, 6 launches a step each) against
    the plain causal core; losses within 2e-3 relative (the tolerance of
    ``lc-agree``)."""
    from parallax_tpu_torch.ops import flash_attention as fa
    losses, launches = {}, {}
    for name, flash in (("flash", True), ("plain", False)):
        cfg, sess = moe_session(torch, use_pallas_attention=flash)
        batches = moe_batches(cfg, MOE_TRAIN["agree_batch"],
                              MOE_TRAIN["seq"], MOE_TRAIN["agree_steps"])
        before = fa.launches
        with mode_ctx("eager"):
            losses[name] = [float(sess.run("loss", feed_dict=b))
                            for b in batches]
        launches[name] = fa.launches - before
        sess.close()
        del sess
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["flash"],
                                               losses["plain"])]
    summary = {"losses": losses, "max_rel_diff": max(rel),
               "tol": MOE_TRAIN["agree_tol"], "flash_launches": launches}
    log(f"[moe-agree] {json.dumps(summary)}")
    want = {"flash": MOE_TRAIN["agree_steps"] * 6, "plain": 0}
    if launches != want:
        raise AssertionError(f"moe-agree B4 launches {launches} != {want}")
    if not (all(math.isfinite(x) for v in losses.values() for x in v)
            and max(rel) <= MOE_TRAIN["agree_tol"]):
        raise AssertionError(f"flash and plain MoE losses differ by "
                             f"{max(rel)} relative > "
                             f"{MOE_TRAIN['agree_tol']}: {losses}")
    return summary


def nmt_beam_inputs(cfg):
    rng = np.random.default_rng(123)
    return rng.integers(3, cfg.vocab_size, (NMT_BEAM["batch"],
                                            NMT_BEAM["src_len"])) \
        .astype(np.int32)


def beam_score(torch, nmt, cfg, params, src, row, alpha):
    """The plain path's score of one decoded row: its teacher-forced
    log-probability through EOS, over the GNMT length penalty when it
    ends in EOS (as ``beam_decode`` ranks finished beams), raw when it
    does not."""
    src = torch.as_tensor(src[None], device=DEVICE).long()
    row = torch.as_tensor(row, device=DEVICE).long()
    tgt_in = torch.cat([torch.full((1,), nmt.BOS_ID, device=DEVICE,
                                   dtype=torch.long), row[:-1]])[None]
    enc, valid = nmt._encode(cfg, params, src)
    logp = torch.log_softmax(nmt._decode_logits(cfg, params, tgt_in, enc,
                                                valid)[0], dim=-1)
    toks = row.tolist()
    n = toks.index(nmt.EOS_ID) + 1 if nmt.EOS_ID in toks else len(toks)
    total = float(logp[torch.arange(n), row[:n]].sum())
    if nmt.EOS_ID in toks:
        return total / float(nmt._length_penalty(float(n), alpha))
    return total


def phase_nmt_beam(torch):
    """NMT ``beam_decode`` at ``examples/nmt_eval.py``'s widths and
    defaults, the cached path in bf16 with the flash encoder (B4, 6
    launches a call): sentences a second and ms a decode step over
    ``calls`` timed calls after a warm one. Then fp32 (TF32 off): the
    beams with the kernel encoder against the plain encoder's, row by
    row; a differing row passes only where the plain path scores both
    hypotheses within 1e-3 (a near tie). ``corpus_bleu`` of the bf16
    beams against the bf16 greedy decode is reported as a smoke check of
    the BLEU (in [0, 100])."""
    from parallax_tpu_torch.common.evaluation import corpus_bleu
    from parallax_tpu_torch.models import nmt
    from parallax_tpu_torch.ops import flash_attention as fa
    kw = dict(vocab_size=32000, model_dim=512, num_heads=8, mlp_dim=2048,
              num_layers=6, max_len=NMT_BEAM["max_len"], num_partitions=1)
    cfg = nmt.NMTConfig(use_pallas_attention=True, **kw)
    params = nmt.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    src = nmt_beam_inputs(cfg)
    K, alpha, T = NMT_BEAM["beam"], NMT_BEAM["alpha"], NMT_BEAM["max_len"]

    def decode(c, p):
        return nmt.beam_decode(p, c, src, beam_width=K, alpha=alpha)

    with torch.no_grad():
        decode(cfg, params)
        torch.cuda.synchronize()
        fa.launches = 0
        t0 = time.perf_counter()
        for _ in range(NMT_BEAM["calls"]):
            beams = decode(cfg, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention_fwd": fa.launches}
        if fa.launches != NMT_BEAM["calls"] * cfg.num_layers:
            raise AssertionError(f"nmt-beam B4 launches {fa.launches}: want "
                                 f"{cfg.num_layers} a call")
        beams = beams.cpu().numpy()
        greedy = nmt.greedy_decode(params, cfg, src).cpu().numpy()
        hyps = [nmt.ids_to_tokens(r) for r in beams]
        refs = [nmt.ids_to_tokens(r) for r in greedy]
        bleu = corpus_bleu(refs, hyps)
        if not 0.0 <= bleu <= 100.0:
            raise AssertionError(f"corpus BLEU {bleu} outside [0, 100]")
        del params
        torch.cuda.empty_cache()
        f32 = {}
        for name, flash in (("kernel", True), ("plain", False)):
            c32 = nmt.NMTConfig(use_pallas_attention=flash,
                                compute_dtype=torch.float32, **kw)
            p32 = nmt.init_params(
                c32, torch.Generator(device=DEVICE).manual_seed(SEED),
                DEVICE)
            f32[name] = decode(c32, p32).cpu().numpy()
        near = []
        for i in np.flatnonzero((f32["kernel"] != f32["plain"]).any(1)):
            a, b = (beam_score(torch, nmt, c32, p32, src[i], f32[k][i],
                               alpha) for k in ("kernel", "plain"))
            near.append({"row": int(i), "plain_scores": [a, b]})
            log(f"[nmt-beam] row {i}: the kernel encoder's beam differs; "
                f"plain scores {a:.6g} and {b:.6g}")
            if not abs(a - b) <= NMT_BEAM["agree_tol"]:
                raise AssertionError(
                    f"nmt-beam row {i}: fp32 beams differ where the plain "
                    f"path scores them {a} and {b}")
        del p32
    torch.cuda.empty_cache()
    summary = {"config": {**kw, "beam": K, "alpha": alpha,
                          "batch": NMT_BEAM["batch"],
                          "src_len": NMT_BEAM["src_len"],
                          "compute": "bfloat16"},
               "calls": NMT_BEAM["calls"], "wall_s": wall,
               "sentences_per_sec": NMT_BEAM["calls"] * NMT_BEAM["batch"]
               / wall,
               "ms_per_decode_step": wall * 1e3 / (NMT_BEAM["calls"] * T),
               "launches": launches,
               "eos_rows": int(sum(nmt.EOS_ID in r.tolist() for r in beams)),
               "bleu_beam_vs_greedy": bleu,
               "fp32_rows_identical": NMT_BEAM["batch"] - len(near),
               "fp32_near_ties": near}
    log(f"[nmt-beam] {json.dumps(summary)}")
    return summary


# -- phases 10-12: ResNet-50 v1.5 training -------------------------------------

# examples/cnn_benchmark_driver.py's defaults: resnet50_v1.5 at 224 px,
# 1000 classes, a global batch of 256 (all on the one card), 4 cycled
# synthetic batches (cnn.make_batch, numpy seed 0)
RESNET = dict(name="resnet50_v1.5", batch=256, image_size=224, classes=1000,
              warmup=5, steps=30, profile_steps=5)
# resnet-agree: one step of the 4-stage [1, 1, 1, 1] ResNet at full width
# on the card against the CPU, in fp32 and in float64. In fp32 a
# pre-activation within about 1e-6 of 0 takes the other ReLU branch on
# one device, and the last stage has only 196 positions a channel, so one
# such flip moves its gradients by about 0.5 %: the port's own fp32 CPU
# gradients are up to 6.5e-2 of a leaf's peak off float64. So fp32 holds
# the loss (1e-5 relative) and the new statistics (1e-4 of each leaf's
# peak) and bounds the gradients at 0.1 of the peak; float64, where no
# branch flips, holds all three to 1e-9.
RESNET_AGREE = dict(batch=4, image_size=224, classes=1000, tol={
    "float32": {"loss": 1e-5, "grads": 0.1, "stats": 1e-4},
    "float64": {"loss": 1e-9, "grads": 1e-9, "stats": 1e-9}})
# device kernels by group, first match wins (names of cuDNN's sm90
# convolution kernels carry fprop, dgrad or wgrad; cuDNN runs many 1x1
# convolutions as cuBLAS (nvjet) or CUTLASS GEMMs whose names do not
# say the direction, and the dense layer's three GEMMs a step are among
# them)
RESNET_GROUPS = (
    ("conv_wgrad", r"wgrad"),
    ("conv_dgrad", r"dgrad"),
    ("conv_fprop", r"fprop"),
    ("conv_gemm", r"nvjet|gemm|ImplicitGemmConvolution|cutlass"),
    ("batch_norm", r"batch_norm"),
    ("optimizer", r"multi_tensor_apply"),
    ("h2d_copy", r"Memcpy HtoD"),
)
# layout conversions that cuDNN inserts when activations and weights
# are not both channels_last
TRANSPOSE = r"(?i)nchw_?to_?nhwc|nhwc_?to_?nchw"


def model_flops(torch, module, image_size):
    """Model FLOPs of one image: 2 x the multiply-adds of the
    convolutions and the dense layer in one forward (counted on meta
    tensors), and 3 times that for a training step (the forward and the
    backward's two products)."""
    from torch.overrides import TorchFunctionMode
    from parallax_tpu_torch.models import _nn
    macs = 0

    class Count(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            nonlocal macs
            out = func(*args, **(kwargs or {}))
            if func is torch.conv2d:
                w = args[1]
                macs += out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
            elif func is torch.addmm:
                macs += args[1].shape[0] * args[1].shape[1] * \
                    args[2].shape[1]
            return out

    params, stats = _nn.init(module, torch.Generator(), "meta", image_size)
    with Count():
        _nn.apply(module, params, stats, torch.empty(
            (1, image_size, image_size, 3), device="meta"))
    return {"forward_gflop": 2 * macs / 1e9, "train_gflop": 6 * macs / 1e9}


def resnet_batches():
    from parallax_tpu_torch.models import cnn
    rng = np.random.default_rng(SEED)
    return [cnn.make_batch(rng, RESNET["batch"], RESNET["image_size"],
                           RESNET["classes"]) for _ in range(4)]


def phase_resnet_train(torch):
    """ResNet-50 v1.5 through parallel_run(Config(run_option="AR")):
    5 warmup and 30 timed steps, images/sec, step ms from CUDA events,
    peak memory and the model-FLOPs share of the bf16 peak; then
    ``resnet-profile``."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.core import classify
    from parallax_tpu_torch.models import cnn
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = cnn.build_model(RESNET["name"], num_classes=RESNET["classes"],
                            image_size=RESNET["image_size"])
    if not model.stateful:
        raise AssertionError("ResNet-50's Model is not stateful")
    sess, *_ = pt.parallel_run(
        model, parallax_config=pt.Config(run_option="AR"), seed=SEED,
        device=DEVICE)
    batches = resnet_batches()
    t_build = time.perf_counter()
    sess.prepare(batches[0])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    placements = set(sess.engine.plan.placements.values())
    if placements != {"replicated"}:
        raise AssertionError(f"AR placements {placements}")
    capture = capture_train(torch, sess, RESNET["batch"])
    state0 = {p: t.clone()
              for p, t in classify.flatten(sess.state.model_state)}
    losses = [sess.run("loss", feed_dict=batches[0])]
    unchanged = [p for p, t in classify.flatten(sess.state.model_state)
                 if torch.equal(t, state0[p])]
    if unchanged or len(state0) != 2 * 53:
        raise AssertionError(f"model_state after the first step: "
                             f"{len(unchanged)} of {len(state0)} leaves "
                             f"unchanged (want 0 of 106)")
    for i in range(1, RESNET["warmup"]):
        losses.append(sess.run("loss", feed_dict=batches[i % 4]))
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    t0 = time.perf_counter()
    feed = (batches[i % 4] for i in range(RESNET["steps"]))
    accs = []
    for loss, acc in sess.run_iter(feed, fetches=["loss", "accuracy"]):
        losses.append(loss)
        accs.append(acc)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite ResNet loss: {losses}")
    leaves = [t for _, t in classify.flatten(sess.state.params)]
    if not bool(torch.stack([torch.isfinite(t).all() for t in leaves]).all()):
        raise AssertionError("a ResNet parameter is not finite")
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    images_per_sec = RESNET["steps"] * RESNET["batch"] / wall
    flops = model_flops(torch, cnn.build_module(
        RESNET["name"], RESNET["classes"])[0], RESNET["image_size"])
    achieved = images_per_sec * flops["train_gflop"] * 1e9
    summary = {
        "config": {**{k: RESNET[k] for k in ("name", "batch", "image_size",
                                             "classes")},
                   "compute": "bfloat16", "run_option": "AR",
                   "params": sum(t.numel() for t in leaves)},
        "images_per_sec": images_per_sec, "timed_steps": RESNET["steps"],
        "wall_s": wall, "step_ms_p50": statistics.median(step_ms),
        "step_ms_p95": step_ms[min(len(step_ms) - 1,
                                   int(math.ceil(0.95 * len(step_ms))) - 1)],
        "first_loss": losses[0], "last5_mean_loss":
            statistics.mean(losses[-5:]),
        "last_accuracy": float(accs[-1]), "losses": losses,
        "engine_build_s": build_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "model_gflop_per_image": flops,
        "model_tflops": achieved / 1e12,
        "share_of_bf16_peak": achieved / PEAK_OPS_PER_S["bfloat16"],
        "capture": capture}
    log(f"[resnet-train] {json.dumps({k: v for k, v in summary.items() if k != 'losses'})}")
    profile = profile_resnet(torch, sess, batches,
                             wall * 1e3 / RESNET["steps"])
    summary["graph_pair"] = graph_pair(
        torch, sess, batches, lambda b: float(len(b["labels"])), "resnet")
    summary["graph_pair"]["graph"].update(capture)
    sess.close()
    torch.cuda.empty_cache()
    return summary, profile


def profile_resnet(torch, sess, batches, timed_step_ms):
    """``profile_steps`` steps under the profiler's CUDA activity: launches
    a step, the device's idle share, and busy time by group
    (``RESNET_GROUPS``; the rest is every other kernel). Fails on a
    layout-transpose kernel. The idle share of the profiled window counts
    the pipeline's fill and the profiler's own host cost; the timed steps'
    idle share is 1 - busy ms a step / ``timed_step_ms``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        feed = (batches[i % 4] for i in range(RESNET["profile_steps"]))
        for loss in sess.run_iter(feed, fetches="loss"):
            pass
        float(loss)
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total",
                     getattr(evt, "cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, evt.count, evt.key))
    if not rows:
        raise AssertionError("the ResNet profile recorded no device activity")
    rows.sort(reverse=True)
    steps = RESNET["profile_steps"]
    busy_us = sum(us for us, _, _ in rows)

    def group(key):
        return next((g for g, pat in RESNET_GROUPS if re.search(pat, key)),
                    "rest")

    by_group = {}
    for us, n, key in rows:
        g = by_group.setdefault(group(key), {"ms_per_step": 0.0,
                                             "launches_per_step": 0.0})
        g["ms_per_step"] += us / 1e3 / steps
        g["launches_per_step"] += n / steps
    for g in by_group.values():
        g["share_of_busy"] = g["ms_per_step"] * 1e3 * steps / busy_us
    by_group["conv_all"] = {k: sum(by_group.get(g, {}).get(k, 0.0) for g in (
        "conv_fprop", "conv_dgrad", "conv_wgrad", "conv_gemm"))
        for k in ("ms_per_step", "launches_per_step", "share_of_busy")}
    transposes = [key for _, _, key in rows if re.search(TRANSPOSE, key)]
    summary = {"steps": steps, "window_s": window,
               "device_busy_ms_per_step": busy_us / 1e3 / steps,
               "device_idle_share": 1.0 - busy_us / 1e6 / window,
               "device_idle_share_timed": 1.0 - busy_us / 1e3 / steps
               / timed_step_ms,
               "device_launches_per_step": sum(n for _, n, _ in rows) / steps,
               "by_group": by_group, "transposes": transposes,
               "kernels": [{"name": key, "group": group(key), "calls": n,
                            "ms": us / 1e3, "share_of_busy": us / busy_us}
                           for us, n, key in rows]}
    shown = {**summary, "kernels": [{**k, "name": k["name"][:110]}
                                    for k in summary["kernels"][:25]]}
    log(f"[resnet-profile] {json.dumps(shown)}")
    if transposes:
        raise AssertionError(f"layout-transpose kernels in the ResNet "
                             f"step: {transposes}")
    return summary


def phase_resnet_agree(torch):
    """One step of ResNet(stage_sizes=[1, 1, 1, 1]) at full width (64
    filters, 224 px, 1000 classes, batch 4) on the card against the
    port's own CPU run of the same step, in fp32 (TF32 off) and in
    float64: the loss, every gradient and the new batch statistics, each
    within ``RESNET_AGREE``'s tolerance (gradients and statistics as the
    largest error of a leaf over its peak). Every BatchNorm scale is
    drawn in [0.5, 1.5], so that no gradient is zero by construction
    (the blocks' last scales start at zero)."""
    from parallax_tpu_torch.core import classify
    from parallax_tpu_torch.models import cnn, resnet
    c = RESNET_AGREE
    params, state = cnn.module_model(resnet.ResNet(
        stage_sizes=(1, 1, 1, 1), num_classes=c["classes"]),
        c["image_size"]).init_fn(torch.Generator().manual_seed(SEED), "cpu")
    gen = torch.Generator().manual_seed(SEED + 1)
    for path, t in classify.flatten(params):
        if path.endswith("scale"):
            t.uniform_(0.5, 1.5, generator=gen)
    batch = cnn.make_batch(np.random.default_rng(SEED), c["batch"],
                           c["image_size"], c["classes"])

    def on(tree, dev, dtype):
        if isinstance(tree, dict):
            return {k: on(v, dev, dtype) for k, v in tree.items()}
        return tree.detach().to(dev, dtype).clone()

    def step(dtype, dev):
        model = cnn.module_model(resnet.ResNet(
            stage_sizes=(1, 1, 1, 1), num_classes=c["classes"],
            dtype=dtype), c["image_size"])
        p, s = on(params, dev, dtype), on(state, dev, dtype)
        flat = classify.flatten(p)
        for _, t in flat:
            t.requires_grad_(True)
        b = {"images": torch.from_numpy(batch["images"]).to(dev, dtype),
             "labels": torch.from_numpy(batch["labels"]).to(dev)}
        t0 = time.perf_counter()
        loss, _, new = model.call_loss(p, b, torch.Generator(device=dev), s)
        grads = torch.autograd.grad(loss, [t for _, t in flat])
        return {"loss": loss.item(),
                "grads": {path: g.cpu() for (path, _), g in
                          zip(flat, grads)},
                "stats": {path: t.cpu() for path, t in
                          classify.flatten(new)},
                "s": time.perf_counter() - t0}

    def worst(got, want):
        """(largest error of a leaf over its peak, that leaf)."""
        out = (0.0, None)
        for path, w in want.items():
            peak = w.abs().max().item()
            err = (got[path] - w).abs().max().item()
            rel = err / peak if peak > 0 else (0.0 if err == 0 else math.inf)
            if out[1] is None or rel > out[0]:
                out = (rel, path)
        return out

    summary = {"config": {"stage_sizes": [1, 1, 1, 1], "filters": 64,
                          "image_size": c["image_size"], "batch": c["batch"],
                          "tf32": False}, "tol": c["tol"]}
    ok = True
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        cpu, card = step(dtype, "cpu"), step(dtype, DEVICE)
        grads, grad_leaf = worst(card["grads"], cpu["grads"])
        stats, stat_leaf = worst(card["stats"], cpu["stats"])
        got = {"loss": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
               "grads": grads, "stats": stats}
        summary[name] = {"loss_cpu": cpu["loss"], "loss_card": card["loss"],
                         **{f"{k}_err": v for k, v in got.items()},
                         "worst_grad_leaf": grad_leaf,
                         "worst_stat_leaf": stat_leaf,
                         "cpu_s": cpu["s"], "card_s": card["s"]}
        ok = ok and all(got[k] <= c["tol"][name][k] for k in got)
    summary["leaves"] = len(cpu["grads"])
    summary["stat_leaves"] = len(cpu["stats"])
    log(f"[resnet-agree] {json.dumps(summary)}")
    if not ok:
        raise AssertionError("the ResNet step on the card disagrees with the "
                             "CPU beyond the stated tolerances")
    return summary


# -- graphs: capture, graph-agree and graph-pair ------------------------------

# graph-pair: each path's steps eagerly (compile.disable_capture()) and as
# replays of its captured graph, in the order eager, graph, graph, eager
# within one session; then profile_steps of each under the profiler
PAIR = dict(steps=15, profile_steps=5, serve_profile_requests=64)
PAIR_ORDER_MODES = ("eager", "graph", "graph", "eager")
# host calls that put work on the card's queue
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
               "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
               "cudaMemcpyAsync", "cudaMemsetAsync", "cuLaunchKernel",
               "cuLaunchKernelEx")
# graph-agree: steps of each training path, eager against graphs
AGREE_STEPS = 5


def mode_ctx(mode):
    import contextlib
    from parallax_tpu_torch.compile import graphs
    return graphs.disable_capture() if mode == "eager" \
        else contextlib.nullcontext()


def p95(sorted_ms):
    return sorted_ms[min(len(sorted_ms) - 1,
                         int(math.ceil(0.95 * len(sorted_ms))) - 1)]


def pool_bytes(torch, graphs_):
    """Bytes of the memory segments the graphs' private pools hold (None
    where the allocator's snapshot does not say)."""
    try:
        pools = {tuple(g.pool()) for g in graphs_}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)
    except Exception:               # an allocator without pool ids
        return None


def capture_train(torch, sess, batch_size):
    """``sess.warmup`` for one batch size: its capture seconds, the rise
    in ``max_memory_allocated`` while it ran (the state's copy, the warm
    step and the graph's pool) and the pool's own segments."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    seconds = sess.warmup(batch_sizes=[batch_size])
    torch.cuda.synchronize()
    graphs_ = [g for g in sess.engine._executables.values() if g is not None]
    return {"capture_s": seconds[batch_size],
            "warmup_peak_rise_bytes": torch.cuda.max_memory_allocated() - base,
            "pool_bytes": pool_bytes(torch, [g.graph for g in graphs_]),
            "graph_launches": {f"{m.rsplit('.', 1)[-1]}.{n}": k for (m, n), k
                               in graphs_[0].launches.items()}}


def timed_steps(torch, sess, batches, steps, units_of):
    """``steps`` steps through ``run_iter``: units (words, images) a
    second and step ms (CUDA events between step ends) p50 and p95."""
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    t0 = time.perf_counter()
    units = 0.0
    last = None
    feed = (batches[i % 4] for i in range(steps))
    for i, last in enumerate(sess.run_iter(feed, fetches="loss")):
        units += units_of(batches[i % 4])
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    float(last)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return {"per_sec": units / wall, "step_ms_p50": statistics.median(step_ms),
            "step_ms_p95": p95(step_ms)}


def host_profile(torch, run, steps):
    """``run()`` under the profiler's CPU and CUDA activity: the card's busy
    ms a step and idle share, its kernels a step, and the host's calls
    that queue work on it (``LAUNCH_APIS``) a step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    from torch.autograd import DeviceType
    busy_us = kernels = 0
    api = {}
    for evt in prof.key_averages():
        if evt.key in LAUNCH_APIS:
            api[evt.key] = evt.count
        elif evt.device_type == DeviceType.CUDA:
            busy_us += getattr(evt, "device_time_total",
                               getattr(evt, "cuda_time_total", 0.0))
            kernels += evt.count
    return {"device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_idle_share": 1.0 - busy_us / 1e6 / window,
            "device_kernels_per_step": kernels / steps,
            "host_launches_per_step": sum(api.values()) / steps,
            "host_launch_calls": api}


def graph_pair(torch, sess, batches, units_of, label):
    """The eager step against the graph replay in one session: ``PAIR``
    steps in the order eager, graph, graph, eager, then a profile of each
    mode."""
    runs = {"eager": [], "graph": []}
    for mode in PAIR_ORDER_MODES:
        with mode_ctx(mode):
            runs[mode].append(timed_steps(torch, sess, batches,
                                          PAIR["steps"], units_of))
    out = {}
    for mode, rs in runs.items():
        def run():
            last = None
            for i in range(PAIR["profile_steps"]):
                last = sess.run("loss", feed_dict=batches[i % 4])
            float(last)

        with mode_ctx(mode):
            prof = host_profile(torch, run, PAIR["profile_steps"])
        out[mode] = {"per_sec": [r["per_sec"] for r in rs],
                     "step_ms_p50": [r["step_ms_p50"] for r in rs],
                     "step_ms_p95": [r["step_ms_p95"] for r in rs], **prof}
    log(f"[graph-pair:{label}] {json.dumps(out)}")
    return out


def phase_graph_agree(torch):
    """LM1B (keep_prob 0.9: dropout masks and sampled candidates from the
    step's generator) and NMT training, ``AGREE_STEPS`` steps eagerly and
    as graph replays, each from a fresh session of seed 0 on the same
    batches: the losses and the final state, leaf by leaf, compared
    bitwise; where a leaf differs, its largest difference over its peak
    is recorded and held to 1e-6."""
    from parallax_tpu_torch.core.engine import state_tensors
    summary = {}
    for name, make, batches_of in (("lm1b", lm1b_session, lm1b_batches),
                                   ("nmt", nmt_train_session, nmt_batches)):
        runs = {}
        for mode in ("eager", "graph"):
            cfg, sess = make(torch)
            batches = batches_of(cfg)
            sess.prepare(batches[0])
            with mode_ctx(mode):
                losses = [float(sess.run("loss", feed_dict=batches[i % 4]))
                          for i in range(AGREE_STEPS)]
            captured = sum(g is not None
                           for g in sess.engine._executables.values())
            if captured != (mode == "graph"):
                raise AssertionError(f"{name} {mode}: {captured} graphs")
            runs[mode] = (losses, [t.detach().clone()
                                   for t in state_tensors(sess.state)])
            sess.close()
            del sess
            torch.cuda.empty_cache()
        (le, se), (lg, sg) = runs["eager"], runs["graph"]
        worst, differ = 0.0, 0
        for a, b in zip(se, sg):
            if torch.equal(a, b):
                continue
            differ += 1
            peak = a.double().abs().max().item()
            err = (a.double() - b.double()).abs().max().item()
            worst = max(worst, err / peak if peak > 0 else math.inf)
        summary[name] = {"eager_losses": le, "graph_losses": lg,
                         "losses_bitwise": le == lg, "leaves": len(se),
                         "leaves_differing": differ,
                         "max_rel_diff": worst}
        del runs, se, sg
        torch.cuda.empty_cache()
    log(f"[graph-agree] {json.dumps(summary)}")
    for name, r in summary.items():
        rel = max([abs(a - b) / abs(b) for a, b in zip(r["eager_losses"],
                                                       r["graph_losses"])])
        if not (r["max_rel_diff"] <= 1e-6 and rel <= 1e-6):
            raise AssertionError(f"{name}: graph and eager steps differ "
                                 f"beyond 1e-6 of the peak: {r}")
    return summary


# -- the run ----------------------------------------------------------------


# the kernel-phase cases at the shapes the main paths launch each kernel
# at ("lc_serve" is moe-serve's decode step too)
MAIN_PATH_CASES = {
    "flash_attention_fwd": ["serve", "train_enc", "train_dec", "bert",
                            "lc_train", "moe_train", "nmt_beam"],
    "flash_attention_dq": ["train_enc", "train_dec", "bert", "lc_train",
                           "moe_train"],
    "flash_attention_dkv": ["train_enc", "train_dec", "bert", "lc_train",
                            "moe_train"],
    "paged_decode_attention": ["serve", "lc_serve"],
    "lstm_fwd": ["train"], "lstm_fwd_res": ["train"], "lstm_bwd": ["train"],
}


def worst_case(rows):
    """The row of the main-path case where the kernel fares worst against
    its library call (the largest ms over library ms), or the last row
    where no case has a library call."""
    timed = [r for r in rows if r["library_ms"]]
    if not timed:
        return rows[-1]
    return max(timed, key=lambda r: r["ms"] / r["library_ms"])


def kernel_line(results, launches):
    """One entry per kernel, its numbers at the main-path case (bf16, the
    type the main paths launch it in) where it fares worst against its
    library call: ``case`` names it, and ``main_path`` gives every
    main-path case's numbers. B4's launches are the NMT serving, NMT,
    BERT, long-context and MoE training paths' and NMT beam search's,
    B5's and B6's the four training paths', B7's the three serving
    paths'. An LSTM entry names the source of the route its case ran
    on."""
    sm90_src = "parallax_tpu_torch/csrc/flash_attention_sm90.cu"
    meta = {
        "flash_attention_fwd": (
            sm90_src, "parallax_tpu/ops/pallas_attention.py:141"),
        "flash_attention_dq": (
            sm90_src, "parallax_tpu/ops/pallas_attention.py:298"),
        "flash_attention_dkv": (
            sm90_src, "parallax_tpu/ops/pallas_attention.py:326"),
        "paged_decode_attention": (
            "parallax_tpu_torch/csrc/paged_attention.cu",
            "parallax_tpu/ops/pallas_paged_attention.py:278"),
        "lstm_fwd": (None, "parallax_tpu/ops/pallas_lstm.py:290"),
        "lstm_fwd_res": (None, "parallax_tpu/ops/pallas_lstm.py:299"),
        "lstm_bwd": (None, "parallax_tpu/ops/pallas_lstm.py:477"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        rows = [next(r for r in results if r["kernel"] == name
                     and r["case"] == case and r["dtype"] == "bfloat16")
                for case in MAIN_PATH_CASES[name]]
        r = worst_case(rows)
        out.append({"name": name, "route": "cuda",
                    "source": source or r["source"],
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "case": r["case"],
                    "main_path": [{k: m[k] for k in (
                        "case", "max_abs_err", "ms", "plain_ms",
                        "bound_ms", "library_ms")} for m in rows]})
    return {"kernels": out}


# one run of the A/B: the child process imports chip_smoke and the
# package from its working directory (this checkout or the other one)
PAIR_CHILD = """
import json, torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.phase_build(torch)
kernels = [r for r in c.phase_lstm_kernels(torch)
           if r["case"] == "train" and r["dtype"] == "bfloat16"]
train, prof = c.phase_train(torch)
steps = prof["steps"]
print("PAIR " + json.dumps({
    "words_per_sec": train["lm1b_words_per_sec_per_chip"],
    "step_ms_p50": train["step_ms_p50"], "step_ms_p95": train["step_ms_p95"],
    "busy_ms_per_step": prof["device_busy_s"] * 1e3 / steps,
    "launches_per_step": prof["device_launches_per_step"],
    "idle_share": prof["device_idle_share"],
    "lstm": {r["kernel"]: {k: r.get(k) for k in
                           ("device_ms", "ms", "library_ms", "route")}
             for r in kernels}}))
"""


# the same for serving: the paged kernel cases (bf16, and the serving
# shape in fp32), the serve phase, and 64 requests under the profiler for
# the busy time a decode step and the paged kernels' share of it
PAIR_CHILD_SERVE = """
import json, re, torch, numpy as np
from torch.profiler import ProfilerActivity, profile
import chip_smoke as c
from parallax_tpu_torch.models import nmt
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.phase_build(torch)
flush = torch.empty(512 << 20, dtype=torch.uint8, device=c.DEVICE)
kernels = []
for dtype in (torch.bfloat16, torch.float32):
    for case in c.paged_cases():
        if dtype == torch.float32 and case[0] != "serve":
            continue
        r = c.run_paged_case(torch, case, dtype, flush)
        assert r["ok"], r
        kernels.append({k: r.get(k) for k in (
            "case", "dtype", "device_ms", "ms", "warm_ms", "bound_ms",
            "max_abs_err", "plan")})
del flush
cfg = nmt.NMTConfig(use_pallas_attention=True, num_partitions=1)
requests = c.make_requests(256, np.random.default_rng(c.SEED),
                           cfg.vocab_size)
params, serve, _ = c.phase_serve(torch, cfg, requests)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    _, _, stats, _ = c.serve(torch, cfg, params, requests[:64])
    torch.cuda.synchronize()
busy = paged = 0.0
names = {}
for e in prof.key_averages():
    us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
    busy += us
    m = re.search(r"paged_\\w+kernel\\w*", e.key)
    if m and us > 0:
        paged += us
        names[m.group(0)] = names.get(m.group(0), 0) + e.count
steps = stats["serve.decode_steps"]
print("PAIR " + json.dumps({
    "tokens_per_sec": serve["tokens_per_sec"],
    "step_ms_p50": serve["step_ms_p50"], "step_ms_p95": serve["step_ms_p95"],
    "profile_decode_steps": steps,
    "busy_ms_per_decode_step": busy / 1e3 / steps,
    "paged_ms_per_decode_step": paged / 1e3 / steps,
    "paged_share_of_busy": paged / busy, "paged_kernels": names,
    "paged": kernels}))
"""


PAIR_ORDER = ("other", "this", "this", "other") * 2


def run_pair(other: Path, what: str = "lm1b") -> int:
    """A/B between the checkout at ``other`` (for example the parent
    commit, unpacked with ``git archive``) and this one, on one card in
    one call: ``other``, this, this, ``other``, twice, each a fresh process
    running its own ``phase_build`` and then, for ``what`` "lm1b", its
    ``phase_lstm_kernels`` and ``phase_train``; for "serve", its paged
    kernel cases, ``phase_serve`` and a profiled serve run. Prints one
    JSON line per run and writes them to ``build/chip_smoke_pair.json``
    (``chip_smoke_pair_serve.json`` for "serve")."""
    child = {"lm1b": PAIR_CHILD, "serve": PAIR_CHILD_SERVE}[what]
    runs = []
    for label in PAIR_ORDER:
        root = ROOT if label == "this" else other
        proc = subprocess.run([sys.executable, "-c", child],
                              cwd=root, capture_output=True, text=True,
                              timeout=900)
        line = [x for x in proc.stdout.splitlines() if x.startswith("PAIR ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"A/B run of {root} failed "
                                 f"(exit {proc.returncode})")
        run = {"tree": label, "root": str(root), **json.loads(line[0][5:])}
        runs.append(run)
        log(f"[pair] {json.dumps(run)}")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    name = "chip_smoke_pair.json" if what == "lm1b" else \
        f"chip_smoke_pair_{what}.json"
    (out_dir / name).write_text(json.dumps(runs, indent=1))
    return 0


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
    if sys.argv[1:2] == ["--pair"]:
        return run_pair(Path(sys.argv[2]).resolve(), *sys.argv[3:4])
    # every fp32 comparison below runs in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    seconds = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 2)
        return out

    card = phase("build", phase_build, torch)
    results = phase("kernels", phase_kernels, torch) + \
        phase("flash-bwd-kernels", phase_flash_bwd_kernels, torch)
    paged_splits = phase("paged-splits", paged_split_sweep, torch)
    failed = [f"{r['kernel']}/{r['case']}/{r['dtype']}" for r in results
              if not r["ok"]]
    if failed:
        raise AssertionError(f"kernels disagree with their plain "
                             f"versions: {failed}")
    from parallax_tpu_torch.models import nmt
    cfg = nmt.NMTConfig(use_pallas_attention=True, num_partitions=1)
    requests = make_requests(256, np.random.default_rng(SEED),
                             cfg.vocab_size)
    params, serve_summary, served = phase("serve", phase_serve, torch, cfg,
                                          requests)
    profile_summary = phase("profile", phase_profile, torch, cfg, params,
                            requests[:64])
    serve_pair = phase("serve-graph-pair", phase_serve_pair, torch, cfg,
                       params, requests, served, serve_summary)
    del served
    agree = phase("agreement", phase_agreement, torch, params, cfg,
                  requests[:32])
    del params
    lstm_results = phase("lstm-kernels", phase_lstm_kernels, torch)
    failed = [f"{r['kernel']}/{r['case']}/{r['dtype']}" for r in lstm_results
              if not r["ok"]]
    if failed:
        raise AssertionError(f"LSTM kernels disagree with their plain "
                             f"versions: {failed}")
    train_route = {r["kernel"]: r["route"] for r in lstm_results
                   if r["case"] == "train" and r["dtype"] == "bfloat16"}
    if train_route != dict.fromkeys(("lstm_fwd", "lstm_fwd_res",
                                     "lstm_bwd"), "lstm_sm90"):
        raise AssertionError(f"bf16 LSTM routes at the training shape "
                             f"{train_route}: B1, B2 and B3 must take the "
                             f"persistent kernels")
    lstm_repeat = phase("lstm-repeat", lstm_repeatability, torch)
    lstm_sweep = phase("lstm-sweep", lstm_step_sweep, torch)
    lstm_bwd_sweep = phase("lstm-bwd-sweep", lstm_step_sweep, torch,
                           "lstm_bwd")
    lstm_groups = phase("lstm-bwd-groups", lstm_bwd_groups, torch)
    train, train_profile = phase("train", phase_train, torch)
    dist_train = phase("dist-train", phase_dist_train, torch,
                       train["losses"], card)
    train_agree = phase("train-agree", phase_train_agreement, torch)
    nmt_train, nmt_profile = phase("nmt-train", phase_nmt_train, torch)
    nmt_agree = phase("nmt-train-agree", phase_nmt_train_agreement, torch)
    resnet_train, resnet_profile = phase("resnet-train", phase_resnet_train,
                                         torch)
    resnet_agree = phase("resnet-agree", phase_resnet_agree, torch)
    bert_train = phase("bert-train", phase_bert_train, torch, card)
    bert_agree = phase("bert-agree", phase_bert_agree, torch)
    lc_train = phase("lc-train", phase_lc_train, torch, card)
    lc_agree = phase("lc-agree", phase_lc_agree, torch)
    from parallax_tpu_torch.models import long_context
    lc_cfg = long_context.LongContextConfig()
    lc_params = long_context.init_params(
        lc_cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    prompts = lc_prompts(LC_SERVE["requests"], np.random.default_rng(SEED),
                         lc_cfg.vocab_size)
    lc_serve_summary = phase("lc-serve", phase_lc_serve, torch, lc_cfg,
                             lc_params, prompts)
    lc_serve_profile = phase("lc-serve-profile", phase_lc_serve_profile,
                             torch, lc_cfg, lc_params,
                             prompts[:LC_SERVE["profile_requests"]])
    lc_serve_agree = phase("lc-serve-agree", phase_lc_serve_agree, torch,
                           lc_params, prompts[:LC_SERVE["agree_requests"]])
    del lc_params
    moe_train = phase("moe-train", phase_moe_train, torch, card)
    moe_agree = phase("moe-agree", phase_moe_agree, torch)
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import moe_lm
    moe_cfg = moe_lm.MoeLMConfig()
    moe_params = moe_lm.init_params(
        moe_cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    moe_serve = phase("moe-serve", phase_lc_serve, torch, moe_cfg,
                      moe_params, prompts, "moe-serve",
                      pt.MoeLMDecodeProgram)
    moe_serve_profile = phase(
        "moe-serve-profile", phase_lc_serve_profile, torch, moe_cfg,
        moe_params, prompts[:LC_SERVE["profile_requests"]],
        "moe-serve-profile", pt.MoeLMDecodeProgram)
    moe_serve_agree = phase(
        "moe-serve-agree", phase_lc_serve_agree, torch, moe_params,
        prompts[:LC_SERVE["agree_requests"]], "moe-serve-agree",
        moe_lm.MoeLMConfig(compute_dtype=torch.float32),
        pt.MoeLMDecodeProgram)
    del moe_params
    torch.cuda.empty_cache()
    nmt_beam = phase("nmt-beam", phase_nmt_beam, torch)
    graph_agree = phase("graph-agree", phase_graph_agree, torch)
    graph_pairs = {"serve": serve_pair, "lm1b": train["graph_pair"],
                   "nmt": nmt_train["graph_pair"],
                   "resnet": resnet_train["graph_pair"]}
    log(f"[graph-pair] {json.dumps(graph_pairs)}")
    launches = {**serve_summary["launches"], **train["launches"]}
    for name, n in list(nmt_train["launches"].items()) + list(
            dist_train["launches"].items()) + list(
            bert_train["launches"].items()) + list(
            lc_train["launches"].items()) + list(
            lc_serve_summary["launches"].items()) + list(
            moe_train["launches"].items()) + list(
            moe_serve["launches"].items()) + list(
            nmt_beam["launches"].items()):
        launches[name] = launches.get(name, 0) + n
    line = kernel_line(results + lstm_results, launches)
    record = {"card": card, "kernels": line["kernels"],
              "cases": results + lstm_results, "paged_splits": paged_splits,
              "lstm_repeat": lstm_repeat,
              "lstm_sweep": lstm_sweep, "lstm_bwd_sweep": lstm_bwd_sweep,
              "lstm_bwd_groups": lstm_groups,
              "serve": serve_summary, "profile": profile_summary,
              "agreement": agree, "train": train,
              "train_profile": train_profile, "train_agreement": train_agree,
              "dist_train": dist_train,
              "nmt_train": nmt_train, "nmt_train_profile": nmt_profile,
              "nmt_train_agreement": nmt_agree,
              "resnet_train": resnet_train, "resnet_profile": resnet_profile,
              "resnet_agreement": resnet_agree, "bert_train": bert_train,
              "bert_agreement": bert_agree, "lc_train": lc_train,
              "lc_agreement": lc_agree, "lc_serve": lc_serve_summary,
              "lc_serve_profile": lc_serve_profile,
              "lc_serve_agreement": lc_serve_agree,
              "moe_train": moe_train, "moe_agreement": moe_agree,
              "moe_serve": moe_serve, "moe_serve_profile": moe_serve_profile,
              "moe_serve_agreement": moe_serve_agree, "nmt_beam": nmt_beam,
              "graph_agree": graph_agree,
              "graph_pair": graph_pairs, "phase_seconds": seconds,
              "wall_s": time.perf_counter() - t_start}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"[phase-seconds] {json.dumps(seconds)}")
    log(f"[done] {record['wall_s']:.1f}s")
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
