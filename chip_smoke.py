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
   occupancy 100 and 25 %); each case prints its plan. After
   ``moe-serve``, B7 again (``moe-serve-b7``) at that phase's own
   positions: 64 of its requests, each slot's last position inside its
   served tokens.
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
6c. ``layouts-train``: the same LM1B (config, seed, batches, warmup
   and timed steps) with every feed's ``batch_specs`` on 'repl' alone
   under slices and a general ``param_specs`` override
   (``P(('repl', 'shard'), None)`` on ``lstm/w_proj``). At one rank
   every split is the identity, so every loss must equal the train
   phase's bit for bit, and B2/B3 launch once a step as there.
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
12g. ``lc-serve-agree``: 16 of the requests served in fp32 (TF32 off)
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
12k. ``moe-serve-agree``: 16 of the requests in fp32 through B7 against
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
heads of 64, a mask with every key valid) and ``oneshot`` (B4 in fp32 and
bf16 at the one-shot translator's full batch: B 32, T 64, 8 heads of 64,
each row padded after a length drawn in [16, 64]) and ``lc_pipe`` (bf16
B4, and B5/B6 without an lse cotangent, at lc-pipe's microbatch: B 2,
T 8192, 8 heads of 64, causal).

The kernel phase also has ``serve_g3``: B7 at the serving shape with 3
queries a slot (S 64, 8 heads of 64, 8 pages of 16 over a 512-page
pool, positions drawn as in ``serve``), fp32 and bf16: serve-spec's
verify.

14. ``serve-spec``: the serve phase's 256 requests through
    ``NMTDecodeProgram(..., prefill_chunk_layers=1, spec_tokens=2,
    draft_cfg/draft_params=layer_skip_draft(cfg, params, 1))``: one
    prefill chunk an iteration (7 graphs a prefill), the draft's catch-up
    and 2 proposal steps and the target's verify of 3 queries a slot in
    one graph. Tokens/s, iteration p50/p95, TTFT p50, the accept rate,
    tokens an iteration, chunks; B7 6 times a verify and B4 7 times a
    prefill beyond the warmup's (14 B4, 6 B7); then 64 requests under the
    profiler (busy and idle share; the sm90 paged and flash kernels, no
    first kernel).
15. ``serve-spec-agree``: 32 requests through the same stack in fp32
    (TF32 off) against the plain ``greedy_decode`` and the program's own
    ``standalone_greedy``, under ``agreement``'s top-2-gap rule; then the
    same requests with the whole target as its draft: accept rate above
    0.9 and the same tokens.
16. ``serve-prefix``: the serve program with ``ServeConfig(
    prefix_cache=True)``, 256 requests by the JAX package's
    shared_prefix_feed rule (half from 3 fixed 64-id sources), caps 64
    and 128 alternating: a sharing-off round, then cold, warm and
    extended (every cap 128) in one session. Every round's tokens equal
    the sharing-off round's, warm TTFT p50 at most 0.8 x cold, no page in
    use after close; hits, replayed tokens, evictions and copy-on-write
    copies printed. A last round sends 16 new sources at cap 40 and
    again at 128: copy-on-write copies, tokens equal to the sharing-off
    session's.
16b. ``oneshot``: the serve phase's model behind ``ServeSession(infer_fn,
    params, example_feed={"src": ...}, ragged_feeds=("src",))`` with
    ``ServeConfig(max_batch=32, batch_buckets=(32,), length_buckets=[32,
    64], max_wait_ms=2)``, ``infer_fn`` the translator
    ``greedy_decode(params, cfg, src, max_len=128)``: the warmup captures
    one graph a (batch, length) signature (2; every batch padded to 32
    rows, so a request's output does not depend on its batch, which
    ``serve-mesh`` holds bitwise); the 256 requests' sources, each decoded
    to 128
    tokens: requests/s, latency p50/p95, batch occupancy,
    ``serve.recompiles`` (must be 0); B4 6 times a batch beyond the
    warmup's 6 a signature. Then 32 requests through the translator in
    fp32 (batch bucket 32 alone) against ``greedy_decode`` of each alone
    (plain encoder), under ``agreement``'s top-2-gap rule.
16c. ``fleet``: two decode replicas on the card behind ``ServeFleet``,
    each with its own ``NMTDecodeProgram`` at the serve phase's geometry;
    the 256 requests with a ``FaultInjector`` crashing replica 0 at its
    200th dispatch: tokens/s beside the serve phase's, failovers,
    retries, ejections, requests lost (must be 0). Then a replica scaled
    up, 3 NMT training steps at the serving config (HYBRID), and their
    parameters pushed under traffic (``ParallaxSession.push_weights``):
    2 hot swaps, no program captures anything after its warmup; B7 6 a
    decode step and B4 6 a prefill, plus each replica's warmup (the
    training steps' launches are taken out). Then a two-replica fp32
    fleet given the pushed weights: 32 requests against
    ``greedy_decode`` under them, top-2-gap rule.
16d. ``disagg``: ``DisaggFleet`` (one prefill replica, one decode
    replica, both ``ServeConfig(prefix_cache=True)``) against a
    colocated one-replica ``ServeFleet`` on the 256 requests: tokens
    equal, wire bytes a request, transfer ms p50, TTFT p50 beside
    colocated, no page in use after close; B4 on the prefill replica (6
    an exported prefill), B7 on the decode replica (6 a decode step),
    each plus the warmups'.
16e. ``serve-mesh`` (after ``disagg``): the serve phase's NMT decode (64
    slots, page 16) and the oneshot phase's translator, each through
    ``ServeSession(..., model=nmt.build_model(cfg), mesh=...)`` over the
    mesh of a one-rank NCCL process group (rank 0 leads; at one rank no
    header is broadcast), the parameters placed by the engine's plan:
    every request's tokens bitwise the serve phase's and every output
    bitwise the oneshot phase's; B4 and B7 as those phases count them;
    ``serve.recompiles`` 0; tokens/s and requests/s beside theirs.
17. ``lc-serve-chunked`` (after ``lc-serve-agree``): ``lc-serve``'s program
    with ``prefill_chunk_layers=1`` on 64 prompts, tokens identical to
    the unchunked program's in this call; TTFT p50 and decode p50 of
    both beside ``lc-serve``'s.
18. ``lm1b-serve`` (after ``nmt-beam``): ``LM1BDecodeProgram(LM1BConfig(),
    max_src_len=20, max_len=32)``, 64 slots, 128 prompts of 2-20 ids:
    tokens/s and step p50 (plain cells, no kernel); 8 requests served in
    fp32 against ``standalone_greedy`` under the top-2-gap rule.
18b. ``ckpt-resume`` (after ``lm1b-serve``): LM1BConfig() (slices, B2/B3)
    fed by the native ``TokenDataset`` over a Zipf token file written from
    SEED under a fresh temporary directory (its free space printed first;
    under 3 x the state's bytes the phase fails). Run A: 10 steps with
    async saves every 5, its step-10 save skipped (nothing reads it; the
    step-5 commit is joined at ``close()``); run B, a new session on the
    directory, must restore step 5 and data cursor 5, then
    ``run_iter(TokenDataset(...), skip="auto")`` runs steps 5-9 (a sync
    save at 10): losses bitwise equal to A's. Prints the checkpoint's
    bytes, each save's seconds on the dispatch thread, the commit's join,
    the restore's seconds, step ms p50 with and without a commit in
    flight, and B2/B3's launches. The directory is removed.
18c. ``nan-rollback``: NMTConfig(use_pallas_attention=True) (B4-B6) with
    ``RecoveryConfig(enabled=True, snapshot_every_steps=2)``, captured; a
    batch whose ``w`` holds a NaN at step 4: one rollback, the hook once,
    the losses after it bitwise equal to a run of the clean batches alone;
    then ``max_retries`` + 1 NaN batches raise ``RecoverySurrender``.
18d. ``data-feed``: ResNet-50 (B 256, 224 px, batches made afresh each
    step from a seeded generator: uint8 pixels scaled to float32), the
    sequential loop against ``run_iter`` at prefetch depth 2, then the
    same pair over 4 batches made ahead; LM1B fed by ``TokenDataset``, the
    sequential loop against ``prefetch_to_device(..., place_batch)`` into
    ``run_iter(placed=True)``: losses bitwise equal, images/s and words/s,
    step ms p50 and data-wait ms p50 of each.
18e. ``nmt-data``: NMTConfig() fed by ``NMTBatchIterator`` (batch 64,
    buckets 16-64) over a corpus written from SEED (lengths 4-64),
    ``shape_buckets=[64]`` and ``warmup()``; one untimed step a length
    bucket captures its graph (each bucket after the first counted in
    ``engine.recompiles``, as the JAX package counts it); then the epoch,
    timed: one graph a bucket, no capture and no recompile inside the
    timed loop, B4-B6 launched in each bucket, losses finite.
18j. ``elastic-train`` (after ``nmt-data``): ``tests/
    torch_elastic_driver.py --lm1b`` as a subprocess master, which calls
    the launcher's ``launch_workers`` on the one-rank layout
    ``[("localhost", 0)]`` with ``max_restarts=1``, ``has_checkpoint``
    and a redirect directory (one card holds one NCCL rank, and
    ``parallel_run`` starts no launcher for one rank). The rank,
    LM1BConfig() on ``cuda:0`` in a one-rank NCCL group, saves a sync
    checkpoint at step 4 and SIGKILLs itself after step 7, the run's
    last, on attempt 0 (an uninterrupted run of steps 1-7); the launcher
    relaunches it, and attempt 1 restores step 4 with no call of its own
    and runs steps 5-7 again. Checked: steps 5-7 bitwise across the
    attempts, so every resumed loss bitwise the uninterrupted run's; B2/B3
    once a step in each attempt; the journal's ``launch``,
    ``elastic_restart`` and ``exit`` (rc 0); both attempts' redirect
    logs. Prints the time to
    recover, from the crash to the resumed first step, split into
    teardown, spawn, process group, restore and capture. The checkpoint
    directory (under 2 x the state's bytes free the phase fails) is
    removed.

18k. ``warmup-bg`` (after ``train-agree``): ``train``'s LM1B with
    ``shape_buckets=(64, 128)``, 12 steps of batches of 128 and 64 rows
    dispatched right after ``warmup(background=True)`` returns, against
    a foreground-warmed session on the same batches: losses bitwise
    equal, each bucket captured once in each session (two captures, both
    graphs live), the thread's ``error`` None, B2/B3 once a step plus
    once a capture, no recompile; prints the steps dispatched before the
    thread finished.
18l. ``drivers`` (after ``ckpt-resume``): ``parallax_tpu_torch.examples``
    called in-process through ``main(argv)`` at the drivers' default
    widths: ``lm1b_driver --lstm_impl pallas`` (10 steps; B2/B3 once a
    step plus the capture's warm call), ``lm1b_eval`` on ``ckpt-resume``'s
    checkpoint of LM1BConfig() (B1 once a batch, fp32), ``nmt_driver
    --pallas_attention`` (6 steps, saving a checkpoint; B4-B6 18 a step
    plus the warm call's) and ``nmt_eval --beam_width 4
    --pallas_attention`` on it (B4 6 a batch): finite losses, perplexity
    and BLEU.
18f. ``skip-thoughts-train`` (after ``train-agree``):
    ``SkipThoughtsConfig()`` at its published widths (vocab 20000, E 620,
    GRU hidden 2400, bf16; Kiros et al. 2015, uni-skip) through
    ``parallel_run(..., Config(run_option="HYBRID"))``, batch 64 of
    30-token sentences: 3 eager steps of one session bitwise equal to 3
    replays of another's captured step (losses and state), then 10 timed
    steps: sentences/s, p50 and p95 from CUDA events, peak memory, the
    model FLOPs' share of 989 TF/s, busy by group; ``emb`` alone sparse.
18g. ``lm1b-full``: ``build_full_softmax_model(LM1BConfig(lstm_impl=
    "kernel"))`` (V 793470, E 512, H 2048, P 512, batch 128 x 20; the fp32
    logits 8.1 GB): captured, 2 + 5 timed steps, words/s, p50, peak
    memory, B2/B3 once a step, the full-softmax head's share of busy,
    and ``train``'s words/s over this phase's (the JAX bench's
    ``vs_baseline``).
18h. ``lc-pipe`` (after ``lc-agree``): (a) ``LongContextConfig(
    parallelism="pipeline", use_pallas_attention=True)``, GPipe and
    1F1B, at lc-train's shape on one card (a ring of one stage runs the
    rows in layer order, as JAX on one device): captured, 3 steps each,
    B4-B6 6 a step each, losses within 2e-3 of lc-train's first 3;
    (b) ``ops.pipeline.pipeline_apply`` and ``pipeline_value_and_grad``
    on a one-rank mesh (S 1, M 4) over the LC stage at B 8 x T 8192, one
    captured step each against the sequential application (loss 2e-3,
    gradients 2e-2 of their peak), their peak memory and B4-B6 launches
    (GPipe 24 each; 1F1B B4 48, B5 and B6 24). Cross-rank BatchNorm and
    rings of more than one stage are held on gloo ranks only
    (tests/test_torch_pipeline.py); one card shows neither.
18i. ``tune-train`` (after ``obs-overhead``): ``train``'s LM1B with
    ``Config(tune_config=TuneConfig())``. On one card the plan space is
    one plan, AR's tp 1: the base HYBRID engine's meta-tensor counts
    price it, the OOM preflight captures the candidate on a fresh state
    (left bitwise as ``init_state`` makes it) against the card's memory,
    and its 12-step trial (B2/B3 once a step) settles the search:
    ``tune_summary()`` with each trial's predicted and measured ms and
    the cost basis. A separate line ranks ``emittable_plans(8)`` by
    ``predict`` from the same one-card inputs: predictions alone, no
    trial behind them. ``profile-train``: ``profile_steps(10)`` over the
    tuned session's replayed steps (a warm-up step, then 10 traced), then
    ``profile_summary()``: the trace must hold 10 launches each of B2's
    and B3's kernels
    (``lstm_fwd_kernel_sm90``, ``lstm_bwd_kernel_sm90``), coverage and
    the sparse path's self time above 0; prints coverage (the JAX
    package's guard asks 0.90), the category shares and the top kernels;
    ``write_calibration`` writes a file ``tune.calibrate.load`` reads
    back. ``tune-calibrated``: a second tuned session loads that file
    (``Config.calibration_path``): its scored terms carry the ratios and
    equal the first session's nominal terms divided by them.

19. ``graph-agree``: LM1B (dropout on) and NMT training, 5 steps
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
import gc
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
# TF32 on the tensor cores (dense): fp32 B4 and B6 form each product as
# three TF32 products (split operands), so their tensor-core bound counts
# three times the operations at this rate
PEAK_TF32_OPS_PER_S = 495e12
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


def bound_tf32x3(bytes_moved: int, ops: int):
    """(bound_ms, bound_by) of a split-operand (3xTF32) kernel: the bytes
    over the memory rate against three TF32 products per operation over
    the TF32 tensor-core rate."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = 3 * ops / PEAK_TF32_OPS_PER_S * 1e3
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
    # sources of 64 ids, none of them pad: the mask passed is all valid);
    # "oneshot" the one-shot translator's full batch in the 64 bucket (32
    # sources padded to 64)
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
            ("lc_pipe", 2, 8192, 8, 64, True, None),
            ("nmt_beam", 16, 64, 8, 64, False, "full"),
            ("oneshot", 32, 64, 8, 64, False, "pad")]


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
# 16, T 1024, 8 heads of 64, causal), and lc-pipe's microbatch of the
# long-context LM's stage (B 2, T 8192, 8 heads of 64, causal; no lse
# cotangent: the stage calls the flash attention as it is)
BF16_ONLY = ("t2048", "t2048_causal", "bert", "lc_train", "moe_train",
             "lc_pipe")


# the fp32 flash kernels redesigned as split-operand TF32 tensor-core
# products (csrc/flash_attention_f32_sm90.cu); fp32 dq runs its first kernel
FP32_SPLIT = ("flash_fwd_kernel", "flash_dkv_kernel")


def flash_kernel_name(kernel, dtype_name):
    """The CUDA kernel a flash wrapper launches for the dtype: the sm90
    (TMA + wgmma) kernels in bf16; in fp32 the split-operand TF32 ones
    (``_tf32x3``) for the forward and dk/dv, the first kernel for dq."""
    if dtype_name == "bfloat16":
        return f"{kernel}_sm90"
    return f"{kernel}_tf32x3" if kernel in FP32_SPLIT else kernel


def first_fp32_kernel(torch, kernel, q, k, v, mask, causal, scale,
                      dout=None, lse=None, delta=None):
    """A call of the first fp32 forward or dk/dv kernel
    (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``; off the
    route since the split-operand redesign) on the wrapper's inputs, its
    outputs in fresh buffers: the "earlier" time of the fp32 rows."""
    from parallax_tpu_torch.ops import _cuda
    from parallax_tpu_torch.ops import flash_attention as fa
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    mp = None if mask is None else mask.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "flash_fwd_kernel":
        fn = _cuda.function("flash_attention", "pt_flash_fwd", fa._ARGTYPES)
        out = torch.empty_like(q)
        lse_out = torch.empty((B, H, Tq), dtype=torch.float32, device=DEVICE)
        return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mp,
                          out.data_ptr(), lse_out.data_ptr(), B, H, Tq, Tk,
                          hd, scale, int(causal), stream)
    fn = _cuda.function("flash_attention_bwd", "pt_flash_dkv",
                        fa._DKV_ARGTYPES)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mp,
                      dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), B, H, Tq, Tk, hd, scale,
                      int(causal), stream)


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
    r = {"kernel": "flash_attention_fwd", "case": label,
         "dtype": dtype_name,
         "shape": {"B": B, "T": T, "H": H, "hd": hd, "causal": causal,
                   "mask": mask_kind},
         "ok": ok, "max_abs_err": err, "tol": tol, "plain_rows": rows,
         "lse_max_abs_err": lse_err, "ms": kernel_ms,
         "device_ms": kernel_device_ms,
         "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops}
    if dtype == torch.float32:
        r.update(split_fp32_extras(
            torch, "flash_fwd_kernel", bytes_moved, ops,
            first_fp32_kernel(torch, "flash_fwd_kernel", q, k, v, mask,
                              causal, scale)))
    return r


def split_fp32_extras(torch, kernel, bytes_moved, ops, earlier):
    """An fp32 split-operand row's 3xTF32 tensor-core bound and the first
    kernel's time on the same inputs (CUDA events and profiler)."""
    bound3, bound3_by = bound_tf32x3(bytes_moved, ops)
    return {"bound_tf32x3_ms": bound3, "bound_tf32x3_by": bound3_by,
            "earlier_ms": time_ms(torch, earlier),
            "earlier_device_ms": device_ms(torch, earlier, f"{kernel}<")}


# -- phase 2: the paged-decode attention --------------------------------------


def paged_cases():
    from parallax_tpu_torch.ops.paged_attention import FLAGSHIP_DECODE as F
    # (label, S, G, D, heads, page_size, P, pool_pages, occupancy);
    # "serve" is the decode step of the serving path below
    # "lc_serve" is lc-serve's decode step: 48 pages of 16 a slot over a
    # 3072-page pool, each slot's last position drawn in [63, 766] (the
    # longest prompt's last position to its last decode step's) with the
    # pages that reach it
    # "serve_g3" is serve-spec's verify: the serving shape at 3 queries a
    # slot (spec_tokens 2), positions drawn as for "serve"
    out = [("serve", 64, 1, 512, 8, 16, 8, 512, None),
           ("serve_g3", 64, 3, 512, 8, 16, 8, 512, None),
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
        elif isinstance(occ, tuple):
            # ("served", [(prompt length, tokens served)] a slot): the
            # slot somewhere inside that request's decode
            plen, served = occ[1][s]
            last = plen - 1 + int(rng.integers(0, served))
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
                      "occupancy": occ[0] if isinstance(occ, tuple)
                      else occ, "live_pages": visible_pages},
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
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}){split_note(r)}")
    return results


def split_note(r):
    """The log's note of an fp32 split-operand row: its 3xTF32 bound and
    the first kernel's times."""
    if "earlier_ms" not in r:
        return ""
    return (f"; 3xTF32 bound {r['bound_tf32x3_ms']:.5f} ms "
            f"({r['bound_tf32x3_by']}), first kernel {r['earlier_ms']:.4f} "
            f"ms (device {r['earlier_device_ms']} ms)")


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
            ("moe_train", 16, 1024, 1024, 8, 64, True, None, False),
            ("lc_pipe", 2, 8192, 8192, 8, 64, True, None, False)]


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
    earlier = None
    if dtype == torch.float32:
        earlier = first_fp32_kernel(torch, "flash_dkv_kernel", q, k, v, mask,
                                    causal, scale, dout, lse, delta)
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
        if earlier is not None and kname in FP32_SPLIT:
            results[-1].update(split_fp32_extras(
                torch, kname, in_bytes + out_bytes, ops, earlier))
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
            f"({r['bound_by']}){split_note(r)}")
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
    # the warmup runs the prefill twice (the capture's eager call and one
    # replay, whose request state it inserts) and the step once
    want = {"flash_attention_fwd": (stats["serve.prefills"] + 2) * L,
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
               "pool_bytes": pool_bytes(torch, [prog._graphs.prefill.graph,
                                                prog._graphs.step.graph])}
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


def lm1b_session(torch, lstm_impl="kernel", config_kw=None, **cfg_kw):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import lm1b
    cfg = lm1b.LM1BConfig(num_partitions=TRAIN["num_partitions"],
                          sparse_grad_mode="slices", lstm_impl=lstm_impl,
                          **cfg_kw)
    sess, *_ = pt.parallel_run(
        lm1b.build_model(cfg),
        parallax_config=pt.Config(run_option="HYBRID",
                                  sparse_grad_mode="slices",
                                  **(config_kw or {})),
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
    # the warmup through run_iter too: the staging ring's slots are
    # allocated before the clock starts
    losses = list(sess.run_iter(
        (batches[i % 4] for i in range(TRAIN["warmup"])), fetches="loss"))
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


# -- obs-train and obs-overhead: the observability layer around LM1B ----------

# obs-train: 16 clean LM1B batches with a NaN one fed at step 7, a
# snapshot every 7 steps (the rollback lands on the step before the NaN
# one), the numerics sample every 5 steps and the drift sweep every 10;
# obs-overhead: rounds of 40 steps of each arm, interleaved
OBS = dict(steps=16, nan_at=7, snapshot_every=7, numerics_interval=5,
           drift_interval=10, perturb=0.05, flops_tol=1e-2,
           wall_tol=0.02, rounds=7, round_steps=40, budget=0.02)


def obs_config(tmp, arm, snapshot_every=None):
    """The session knobs of one observability arm: "full" every knob on
    (the Chrome trace, the metrics sink, health, numerics and the drift
    sweep, the flight recorder and journal into ``tmp``, recovery),
    "default" (and "off", built and run under ``obs.disable()``) none."""
    import parallax_tpu_torch as pt
    kw = dict(run_option="HYBRID", sparse_grad_mode="slices")
    if arm == "full":
        kw.update(
            trace_path=str(Path(tmp) / "trace.json"),
            metrics_path=str(Path(tmp) / "metrics.jsonl"),
            metrics_interval_s=10.0, monitor_health=True,
            numerics_interval=OBS["numerics_interval"],
            numerics_drift_interval=OBS["drift_interval"],
            flight_dir=str(Path(tmp) / "flight"),
            journal_path=str(Path(tmp) / "journal.jsonl"),
            recovery_config=pt.RecoveryConfig(
                enabled=True, snapshot_every_steps=snapshot_every
                or OBS["snapshot_every"], max_retries=2))
    return pt.Config(**kw)


def obs_session(torch, tmp, arm, snapshot_every=None):
    """``lm1b_session``'s LM1B (bf16, B2/B3) with ``obs_config``'s
    knobs, prepared and its step captured for the training batch."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import lm1b
    cfg = lm1b.LM1BConfig(num_partitions=TRAIN["num_partitions"],
                          sparse_grad_mode="slices", lstm_impl="kernel")
    sess, *_ = pt.parallel_run(
        lm1b.build_model(cfg),
        parallax_config=obs_config(tmp, arm, snapshot_every),
        seed=SEED, device=DEVICE)
    batches = lm1b_batches(cfg)
    sess.prepare(batches[0])
    capture = capture_train(torch, sess, TRAIN["batch"])
    return cfg, sess, batches, capture


def paged_count():
    from parallax_tpu_torch.ops import paged_attention as pa
    return pa.launches


def obs_sentinels(torch, sess):
    """``run_drift_sentinels()`` with the launch counters zeroed around
    it, then the same pairs with an injected drift: the results, the
    launches of each (fp32 B2, B3 and B7) and the LSTM pair's route."""
    from parallax_tpu_torch.obs import numwatch
    from parallax_tpu_torch.ops import lstm
    zero_lstm_counts()
    zero_launches()
    clean = sess.run_drift_sentinels()
    perturbed = [s.check() for s in numwatch.default_sentinels(
        perturb=OBS["perturb"], device=DEVICE)]
    torch.cuda.synchronize()
    launches = {**lstm_counts(), "paged_decode_attention": paged_count()}
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    T, B, H, P = 6, 8, 32, 16
    route = {"fwd": lstm.fwd_route(torch.float32, T, B, H, P, sm).source,
             "bwd": lstm.bwd_route(torch.float32, T, B, H, P, sm).source}
    return clean, perturbed, launches, route


def phase_obs_train(torch):
    """LM1B as ``train`` runs it (bf16 B2/B3, captured) with every
    observability knob on: the rollback artifact of a NaN batch names
    the poisoned feed and carries the numerics, journal, goodput and
    memory sections; the drift sentinels launch fp32 B2/B3 and B7 and
    agree with the plain versions, a perturbed pair is flagged; the
    timeline rows sum to the loop's wall; ``step_flops`` holds to the
    LM1B shape formula; no alert fires on the clean steps; the clean
    steps' losses equal, bitwise, a session's with every knob off."""
    import glob
    import shutil
    import tempfile
    from parallax_tpu_torch import obs
    from parallax_tpu_torch.common import flops as flops_lib
    from parallax_tpu_torch.obs import memwatch, numwatch
    tmp = tempfile.mkdtemp(prefix="parallax-obs-")
    k = OBS["nan_at"]
    try:
        torch.cuda.empty_cache()
        cfg, sess, batches, capture = obs_session(torch, tmp, "full")
        eng = sess.engine
        stats = sess.compile_stats()
        num_graphs = eng.captured_graphs(numerics=True)
        if len(num_graphs) != 1 or len(eng.captured_graphs()) != 1:
            raise AssertionError(f"obs-train: graphs {stats}")
        num_capture_s = list(eng.numerics_capture_seconds.values())[0]
        num_pool = memwatch.graph_pool_bytes([g.graph for g in num_graphs])
        clean = [batches[i % 4] for i in range(OBS["steps"])]
        bad = dict(clean[k], w=clean[k]["w"].copy())
        bad["w"][0, 0] = np.nan
        feed = clean[:k] + [bad] + clean[k:]
        zero_lstm_counts()
        zero_launches()
        losses, clean_alerts = [], None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, b in enumerate(feed):
            if i == k:
                clean_alerts = (sess.alerts.evaluate(),
                                sess.alerts.summary()["firings_total"])
            losses.append(float(sess.run("loss", feed_dict=b)))
        torch.cuda.synchronize()
        loop_wall = time.perf_counter() - t0
        loop_launches = {**lstm_counts(),
                         "paged_decode_attention": paged_count()}
        sess.health.poll(block=True)
        sess.numerics.poll(block=True)
        snap = sess.metrics_snapshot()
        sweeps = int(snap.get("numerics.drift.lstm_bwd.checks", 0))
        rows = sess.timeline.rows()
        flops = sess.step_flops()
        want_flops = flops_lib.lm1b_matmul_flops_per_word(cfg) \
            * TRAIN["batch"] * TRAIN["num_steps"]
        clean_s, perturbed, sentinel_launches, route = \
            obs_sentinels(torch, sess)
        arts = glob.glob(str(Path(tmp) / "flight" /
                             "flight_nonfinite_rollback_*.json"))
        doc = json.loads(Path(arts[0]).read_text()) if len(arts) == 1 \
            else None
        account = sess.ops_account()
        samples = sess.numerics.total_samples
        sess.close()
        del sess, eng, num_graphs
        torch.cuda.empty_cache()
        trace_doc = json.loads((Path(tmp) / "trace.json").read_text())
        sink = (Path(tmp) / "metrics.jsonl").read_text().splitlines()
        journal = [json.loads(x) for x in
                   (Path(tmp) / "journal.jsonl").read_text().splitlines()]
        # every knob off (built and run under the killswitch): the clean
        # batches alone
        obs.disable()
        try:
            _, ref, _, _ = obs_session(torch, tmp, "off")
            want = [float(ref.run("loss", feed_dict=b)) for b in clean]
            ref.close()
            del ref
        finally:
            obs.enable()
        torch.cuda.empty_cache()
    finally:
        obs.enable()
        shutil.rmtree(tmp, ignore_errors=True)
    dispatches = len(feed)
    want_launches = {"lstm_fwd": 0,
                     "lstm_fwd_res": dispatches + 2 * sweeps,
                     "lstm_bwd": dispatches + sweeps,
                     "paged_decode_attention": sweeps}
    # the walls telescope (dispatch end to dispatch end) to the loop's
    # wall; a row's parts are its measured phases plus the residual (a
    # lazy read attributed back, like the wait behind a snapshot's
    # copy, can exceed its row: the residual is then 0)
    walls = sum(r["wall_ms"] for r in rows) / 1e3
    parts_ok = all(min(r[c] for c in (
        "data_wait_ms", "convert_ms", "h2d_ms", "dispatch_ms",
        "fetch_block_ms", "device_est_ms")) >= 0 for r in rows)
    summary = {
        "steps": dispatches, "nan_at": k, "losses": losses,
        "reference": want, "capture_s": capture["capture_s"],
        "numerics_capture_s": num_capture_s,
        "numerics_pool_bytes": num_pool, "pool_bytes": capture["pool_bytes"],
        "compile_stats": stats, "numerics_samples": samples,
        "drift_sweeps_in_loop": sweeps, "loop_launches": loop_launches,
        "sentinel_launches": sentinel_launches, "sentinel_route": route,
        "sentinels": clean_s, "perturbed": perturbed,
        "loop_wall_s": loop_wall, "timeline_wall_s": walls,
        "timeline_rows": len(rows), "step_flops": flops,
        "formula_flops": want_flops,
        "clean_alert_firings": clean_alerts[1] if clean_alerts else None,
        "account": account, "trace_events": len(trace_doc["traceEvents"]),
        "sink_lines": len(sink), "journal_events": len(journal),
        "provenance": doc["detail"].get("provenance") if doc else None,
        "trip_stats_basis": doc["detail"].get("trip_stats_basis")
        if doc else None,
        "flight_sections": sorted(doc) if doc else None,
        "launches": add_counts(dict(loop_launches), sentinel_launches)}
    log(f"[obs-train] {json.dumps({k_: v for k_, v in summary.items() if k_ not in ('losses', 'reference', 'compile_stats')})}")
    if doc is None:
        raise AssertionError(f"obs-train: {len(arts)} rollback artifacts")
    prov = doc["detail"].get("provenance") or {}
    if prov.get("culprit") != "feed/w" or not prov.get(
            "trip_stats_sampled"):
        raise AssertionError(f"obs-train: provenance {prov}; "
                             f"{doc['detail'].get('provenance_error')}")
    for section in ("numerics", "journal_tail", "goodput", "ops",
                    "memwatch"):
        v = doc.get(section)
        if not v or (isinstance(v, dict) and "_error" in v):
            raise AssertionError(f"obs-train: artifact section {section} "
                                 f"is {v!r}")
    if not doc["memwatch"]["samples"] or not doc["numerics"]["trail"]:
        raise AssertionError("obs-train: no memory or numerics samples in "
                             "the artifact")
    if not doc["detail"].get("stats_trail"):
        raise AssertionError("obs-train: no stats trail in the artifact")
    if route != {"fwd": "lstm", "bwd": "lstm"}:
        raise AssertionError(f"obs-train: sentinel LSTM route {route}")
    if sentinel_launches != {"lstm_fwd": 0, "lstm_fwd_res": 4,
                             "lstm_bwd": 2, "paged_decode_attention": 2}:
        raise AssertionError(f"obs-train: sentinel launches "
                             f"{sentinel_launches}")
    for r in clean_s:
        if r["flagged"] or not r["rel_err"] <= r["rel_err_tol"]:
            raise AssertionError(f"obs-train: sentinel {r}")
    if not all(r["flagged"] for r in perturbed):
        raise AssertionError(f"obs-train: a perturbed pair passed "
                             f"{perturbed}")
    if sweeps != 1 or loop_launches != want_launches:
        raise AssertionError(f"obs-train: loop launches {loop_launches} "
                             f"!= {want_launches} ({sweeps} sweeps)")
    if not parts_ok or abs(walls - loop_wall) > OBS["wall_tol"] * loop_wall:
        raise AssertionError(f"obs-train: timeline rows sum to {walls} s "
                             f"against the loop's {loop_wall} s")
    if not flops or abs(flops / want_flops - 1) > OBS["flops_tol"]:
        raise AssertionError(f"obs-train: step_flops {flops} against the "
                             f"formula's {want_flops}")
    if clean_alerts is None or clean_alerts[0] or clean_alerts[1]:
        raise AssertionError(f"obs-train: alerts on the clean steps "
                             f"{clean_alerts}")
    if losses[:k] + losses[k + 1:] != want or math.isfinite(losses[k]):
        raise AssertionError(f"obs-train: losses {losses} against every "
                             f"knob off {want}")
    if samples < 1 or not sink or not journal or not summary[
            "trace_events"]:
        raise AssertionError(f"obs-train: samples {samples}, sink "
                             f"{len(sink)}, journal {len(journal)}")
    return summary


def phase_obs_overhead(torch):
    """LM1B ``train`` words/s under three observability arms, in
    interleaved rounds (each round every arm in a rotated order): the
    default session (the always-on set), the same under
    ``obs.disable()`` (built and run there) and every knob on. The
    default arm's median must stay within 2 % of the disabled arm's
    (the JAX package's budget); the full arm is printed."""
    import shutil
    import tempfile
    from parallax_tpu_torch import obs
    tmp = tempfile.mkdtemp(prefix="parallax-obs-")
    arms = ("default", "off", "full")
    sessions = {}
    try:
        torch.cuda.empty_cache()
        for arm in arms:
            if arm == "off":
                obs.disable()
            try:
                # the full arm snapshots for recovery at the default
                # cadence (a 6.58 GB copy to the host every 25 steps)
                sessions[arm] = obs_session(torch, tmp, arm,
                                            snapshot_every=25)
            finally:
                obs.enable()
        words = lambda b: float(b["w"].sum())
        runs = {arm: [] for arm in arms}
        for r in range(OBS["rounds"] + 1):
            order = arms[r % 3:] + arms[:r % 3]
            for arm in order:
                _, sess, batches, _ = sessions[arm]
                if arm == "off":
                    obs.disable()
                try:
                    t = timed_steps(torch, sess, batches,
                                    OBS["round_steps"], words)
                finally:
                    obs.enable()
                if r:                      # round 0 warms every arm
                    runs[arm].append(t)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        obs.enable()
        for _, sess, _, _ in sessions.values():
            sess.close()
        sessions.clear()
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    med = {arm: statistics.median(t["per_sec"] for t in runs[arm])
           for arm in arms}
    ms = {arm: statistics.median(t["step_ms_p50"] for t in runs[arm])
          for arm in arms}
    summary = {"rounds": OBS["rounds"], "round_steps": OBS["round_steps"],
               "words_per_sec": med, "step_ms_p50": ms,
               "default_over_off": med["default"] / med["off"],
               "full_over_off": med["full"] / med["off"],
               "budget": OBS["budget"], "peak_memory_gb": peak_gb,
               "runs": {arm: [t["per_sec"] for t in runs[arm]]
                        for arm in arms}}
    log(f"[obs-overhead] {json.dumps(summary)}")
    if med["default"] < (1.0 - OBS["budget"]) * med["off"]:
        raise AssertionError(f"obs-overhead: the default arm's "
                             f"{med['default']:.0f} words/s is more than "
                             f"{OBS['budget']:.0%} under the disabled "
                             f"arm's {med['off']:.0f}")
    return summary


# -- tune-train, profile-train, tune-calibrated: the planner around LM1B --------

# the trial of TuneConfig()'s defaults: 12 steps, the median of the last 8;
# then a profiled window of 10 replayed steps
TUNE = dict(profile_steps=10, rel=1e-9)


def lstm_counts():
    from parallax_tpu_torch.ops import lstm
    return {"lstm_fwd": lstm.launches_fwd,
            "lstm_fwd_res": lstm.launches_fwd_res,
            "lstm_bwd": lstm.launches_bwd}


def zero_lstm_counts():
    from parallax_tpu_torch.ops import lstm
    for name in LSTM_COUNTERS:
        setattr(lstm, name, 0)


def tuned_lm1b(torch, calibration_path=None):
    """``train``'s LM1B planned by the mesh auto-tuner, prepared (the
    probe, the preflight and the switch to the first candidate)."""
    import parallax_tpu_torch as pt
    cfg, sess = lm1b_session(torch, config_kw=dict(
        tune_config=pt.TuneConfig(), calibration_path=calibration_path))
    batches = lm1b_batches(cfg)
    sess.prepare(batches[0])
    torch.cuda.synchronize()
    return cfg, sess, batches


def phase_tune_train(torch):
    """The mesh search on one card: the plan its probe and preflight
    chose, the state the preflight's capture left (bitwise a fresh
    init), the trial's steps to the settled decision, and the
    predictions-only ranking of the eight-card plan space from the same
    inputs. Returns the live session for ``profile-train``."""
    import dataclasses as dc
    from parallax_tpu_torch.core import engine as engine_lib
    from parallax_tpu_torch.tune import costmodel, search
    torch.cuda.empty_cache()
    zero_lstm_counts()
    t0 = time.perf_counter()
    cfg, sess, batches = tuned_lm1b(torch)
    prepare_s = time.perf_counter() - t0
    inputs = sess._search._inputs
    # the scored plans' unrounded terms, which tune-calibrated divides
    nominal = {pc.plan.describe(): dict(pc.terms)
               for pc in sess._search._scored}
    plan = sess.plan.describe()
    graphs_ = sess.engine.captured_graphs()
    if plan != "dp1xtp1/AR" or len(graphs_) != 1:
        raise AssertionError(f"tune-train: plan {plan}, {len(graphs_)} "
                             f"graph(s) after the preflight")
    fresh = sess.engine.init_state(SEED)
    same = all(torch.equal(a, b) for a, b in zip(
        engine_lib.state_tensors(sess.state),
        engine_lib.state_tensors(fresh)))
    del fresh
    if not same:
        raise AssertionError("tune-train: the preflight's capture changed "
                             "the state")
    losses = []
    steps = 0
    while sess.tune_summary() is None:
        losses.append(float(sess.run("loss", feed_dict=batches[steps % 4])))
        steps += 1
        if steps > 64:
            raise AssertionError("tune-train: the search did not settle")
    torch.cuda.synchronize()
    launches = lstm_counts()
    s = sess.tune_summary()
    if s["winner"]["plan"] != plan or s["trials_measured"] != 1 or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"tune-train: decision {s['winner']}, "
                             f"losses {losses}")
    # the warm call of the preflight's capture, then one a step
    want = {"lstm_fwd": 0, "lstm_fwd_res": steps + 1,
            "lstm_bwd": steps + 1}
    if launches != want:
        raise AssertionError(f"tune-train: LSTM launches {launches} != "
                             f"{want}")
    eight = dc.replace(inputs, num_devices=8)
    ranking = sorted((costmodel.predict(p, eight) for p in
                      search.emittable_plans(8)), key=lambda c: c.total_s)
    summary = {
        "plan": plan, "prepare_s": prepare_s, "trial_steps": steps,
        "decision": {k: s[k] for k in (
            "candidates_enumerated", "pruned_equivalent",
            "pruned_by_cost_model", "pruned_oom", "hbm_budget_bytes",
            "hbm_headroom", "preflight_checked", "trials", "winner",
            "search_seconds", "cost_basis")},
        "inputs": {k: v for k, v in dc.asdict(inputs).items()
                   if k != "pipeline"},
        "losses": losses, "launches": launches}
    log(f"[tune-train] {json.dumps(summary)}")
    log("[tune-train-8-card-predictions] predictions only, no trial: "
        "the one-card inputs priced over 8 cards " + json.dumps(
            [{"plan": c.plan.describe(),
              "predicted_ms": round(c.total_s * 1e3, 6),
              "terms_ms": {k: round(v * 1e3, 6)
                           for k, v in c.terms.items()}}
             for c in ranking]))
    summary["eight_card_predictions"] = [
        (c.plan.describe(), c.total_s * 1e3) for c in ranking]
    return summary, sess, batches, nominal


def residual_gaps(doc, steps, top=6):
    """Where a window's residual lies: the device-idle gaps inside the
    step envelopes (``xprof.attribute``'s wall less its busy union),
    summed by the device events either side, the largest first (names
    cut to 60 characters)."""
    from parallax_tpu_torch.obs import xprof
    ops, _ = xprof.device_op_events(doc)
    merged = xprof.merge_intervals([(e["ts"], e["ts"] + e["dur"])
                                    for e in ops])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], i)
                   for i in range(len(merged) - 1)), reverse=True)
    inter = {i for _, i in gaps[:steps - 1]}
    ends = {e["ts"] + e["dur"]: e["name"][:60] for e in ops}
    starts = {e["ts"]: e["name"][:60] for e in ops}
    out = {}
    for g, i in gaps:
        if i in inter or g <= 0:
            continue
        key = (ends.get(merged[i][1], "?"), starts.get(merged[i + 1][0],
                                                       "?"))
        us, n = out.get(key, (0.0, 0))
        out[key] = (us + g, n + 1)
    return [{"after": a, "before": b, "ms": round(us / 1e3, 4), "gaps": n}
            for (a, b), (us, n) in sorted(out.items(),
                                          key=lambda kv: -kv[1][0])[:top]]


def launch_to_kernel_us(doc):
    """Each replayed kernel's start less its graph launch's (the
    ``cudaGraphLaunch`` host event of the same correlation id), in us:
    min and median, and the kernels each launch shows, in launch order. A
    negative one is a kernel stamped before the call that launched it."""
    launches = {e["args"]["correlation"]: e["ts"]
                for e in doc["traceEvents"] if e.get("ph") == "X"
                and e.get("name") == "cudaGraphLaunch"
                and "correlation" in (e.get("args") or {})}
    per = dict.fromkeys(sorted(launches, key=launches.get), 0)
    deltas = []
    for e in doc["traceEvents"]:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") == "kernel" \
                and corr in launches:
            deltas.append(e["ts"] - launches[corr])
            per[corr] += 1
    if not deltas:
        return None
    deltas.sort()
    return {"min": deltas[0], "median": deltas[len(deltas) // 2],
            "kernels": len(deltas), "per_launch": list(per.values())}


def phase_profile_train(torch, sess, batches):
    """``profile_steps`` over the tuned session's replayed steps: the
    trace's B2/B3 launches, the attribution (coverage, category shares,
    the sparse path's time, the top kernels) and a calibration file
    written and read back. Closes the session; returns the summary and
    the file's path."""
    import tempfile
    from parallax_tpu_torch.obs import xprof
    from parallax_tpu_torch.tune import calibrate
    n = TUNE["profile_steps"]
    zero_lstm_counts()
    outdir = sess.profile_steps(n)
    # the window's warm-up step (profiler.py), then the n traced ones
    for i in range(n + 1):
        sess.run("loss", feed_dict=batches[i % 4])
    torch.cuda.synchronize()
    in_window = lstm_counts()
    t0 = time.perf_counter()
    a = sess.profile_summary()
    parse_s = time.perf_counter() - t0
    launches = lstm_counts()
    doc, path = xprof.load_trace(outdir)
    kernels = xprof.kernel_counts(doc)
    seen = {name: sum(c for k, c in kernels.items() if name in k)
            for name in ("lstm_fwd_kernel_sm90", "lstm_bwd_kernel_sm90")}
    cal_path = str(Path(tempfile.mkdtemp(prefix="parallax-cal-"))
                   / "calibration.json")
    sess.write_calibration(cal_path)
    record = calibrate.load(cal_path)
    sess.close()
    summary = {
        "steps": a["steps"], "track_basis": a["track_basis"],
        "coverage": a["coverage"], "jax_guard_coverage": 0.90,
        "wall_ms": a["wall_ms"], "step_wall_ms": a["step_wall_ms"],
        "attributed_ms": a["attributed_ms"],
        "residual_ms": a["residual_ms"],
        "by_category": a["by_category"], "collectives": a["collectives"],
        "dense_sparse": a["dense_sparse"], "layers": a["layers"],
        "top_ops": [{k: r[k] for k in ("op", "category", "self_ms",
                                       "count", "layer", "split")}
                    for r in a["top_ops"][:12]],
        "residual_gaps": residual_gaps(doc, n),
        "launch_to_kernel_us": launch_to_kernel_us(doc),
        "lstm_kernels_in_trace": seen, "parse_s": parse_s,
        "launches_in_window": in_window, "launches": launches,
        "calibration": record, "trace": path}
    log(f"[profile-train] {json.dumps(summary)}")
    if seen != {"lstm_fwd_kernel_sm90": n, "lstm_bwd_kernel_sm90": n}:
        raise AssertionError(f"profile-train: B2/B3 kernels in the trace "
                             f"{seen}, want {n} each")
    if in_window != {"lstm_fwd": 0, "lstm_fwd_res": n + 1,
                     "lstm_bwd": n + 1}:
        raise AssertionError(f"profile-train: launches in the window "
                             f"{in_window}")
    if a["track_basis"] != "device" or not a["coverage"] or \
            a["coverage"] <= 0:
        raise AssertionError(f"profile-train: coverage {a['coverage']} "
                             f"on {a['track_basis']}")
    if not a["dense_sparse"]["sparse_self_ms"] > 0:
        raise AssertionError(f"profile-train: the sparse path's self time "
                             f"{a['dense_sparse']}")
    if record is None or not calibrate.ratios(record):
        raise AssertionError(f"profile-train: calibration {record}")
    return summary, cal_path


def phase_tune_calibrated(torch, cal_path, nominal):
    """A second tuned session loading ``cal_path``: its scored terms
    carry the file's ratios and equal ``nominal``'s (the first session's
    scored terms, {plan: terms}) divided by them; its trial settles."""
    from parallax_tpu_torch.tune import calibrate
    ratios = calibrate.ratios(calibrate.load(cal_path))
    torch.cuda.empty_cache()
    zero_lstm_counts()
    cfg, sess, batches = tuned_lm1b(torch, calibration_path=cal_path)
    scored = [(pc.plan.describe(), pc.calibration, dict(pc.terms))
              for pc in sess._search._scored]
    steps = 0
    while sess.tune_summary() is None:
        sess.run("loss", feed_dict=batches[steps % 4])
        steps += 1
    torch.cuda.synchronize()
    s = sess.tune_summary()
    launches = lstm_counts()
    sess.close()
    torch.cuda.empty_cache()
    terms = {}
    for plan, applied, got in scored:
        if applied != ratios:
            raise AssertionError(f"tune-calibrated: applied {applied} != "
                                 f"{ratios}")
        for k, v in got.items():
            r = ratios.get("wire" if k.startswith("wire_")
                           and k != "wire_hidden_s" else "on_chip", 1.0)
            want = nominal[plan][k] / r
            if k != "wire_hidden_s" and not math.isclose(
                    v, want, rel_tol=TUNE["rel"], abs_tol=0.0):
                raise AssertionError(f"tune-calibrated: {plan} {k} {v} != "
                                     f"{nominal[plan][k]} / {r}")
        terms[plan] = got
    summary = {"ratios": ratios, "scored_terms_s": terms,
               "nominal_terms_s": {p: nominal[p] for p in terms},
               "cost_basis": s["cost_basis"], "winner": s["winner"],
               "trial_steps": steps, "launches": launches}
    log(f"[tune-calibrated] {json.dumps(summary)}")
    if not s["cost_basis"].startswith("calibrated("):
        raise AssertionError(f"tune-calibrated: basis {s['cost_basis']}")
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


# -- layouts-train and elastic-train: the engine's layouts, the launcher --


def phase_layouts_train(torch, train_losses):
    """The train phase's LM1B (same config, seed, batches, warmup and
    timed steps) with every feed on 'repl' alone and a general override
    on a dense weight: at one rank every split is the identity, so the
    losses must equal the train phase's bit for bit, B2/B3 once a
    step."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.core.mesh import P
    from parallax_tpu_torch.models import lm1b
    cfg = lm1b.LM1BConfig(num_partitions=TRAIN["num_partitions"],
                          sparse_grad_mode="slices", lstm_impl="kernel")
    model = lm1b.build_model(cfg)
    model.batch_specs = {k: P("repl", None) for k in ("x", "y", "w")}
    model.param_specs["lstm/w_proj"] = P(("repl", "shard"), None)
    sess, *_ = pt.parallel_run(
        model, parallax_config=pt.Config(run_option="HYBRID",
                                         sparse_grad_mode="slices"),
        seed=SEED, device=DEVICE)
    batches = lm1b_batches(cfg)
    sess.prepare(batches[0])
    eng = sess.engine
    if eng.batch_layout != "repl" or eng._batch_axes != ("repl",):
        raise AssertionError(f"layouts-train: batch layout "
                             f"{eng.batch_layout} {eng._batch_axes}")
    capture = capture_train(torch, sess, TRAIN["batch"])
    zero_lstm_counts()
    # the train phase's order: its warmup's batches, then its timed ones
    order = [i % 4 for i in range(TRAIN["warmup"])] + \
        [i % 4 for i in range(TRAIN["steps"])]
    steps = len(order)
    losses = [float(x) for x in sess.run_iter(
        (batches[i] for i in order), fetches="loss")]
    launches = lstm_counts()
    if launches != {"lstm_fwd": 0, "lstm_fwd_res": steps,
                    "lstm_bwd": steps}:
        raise AssertionError(f"layouts-train LSTM launch counts "
                             f"{launches} over {steps} steps")
    if losses != train_losses:
        bad = [i for i, (a, b) in enumerate(zip(losses, train_losses))
               if a != b]
        raise AssertionError(f"layouts-train losses differ from the train "
                             f"phase's at steps {bad[:5]}")
    summary = {"batch_layout": eng.batch_layout,
               "placements": {k: eng.plan.placements[k]
                              for k in ("lstm/w_proj", "emb")},
               "steps": steps, "losses_bitwise_equal_train": True,
               "capture_s": capture["capture_s"], "launches": launches}
    log(f"[layouts-train] {json.dumps(summary)}")
    sess.close()
    return summary


ELASTIC = dict(timeout_s=420, space_factor=2)


def phase_elastic_train(torch, card):
    """LM1B through a launcher-driven crash, relaunch and resume (the
    ``elastic-train`` phase of the module doc): the driver runs as a
    subprocess master; the resumed attempt's losses are held bitwise to
    attempt 0's, an uninterrupted run of the same steps."""
    import os
    import shutil
    import tempfile
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_elastic_driver as drv
    steps = drv.LM1B
    work = Path(tempfile.mkdtemp(prefix="parallax_elastic_"))
    try:
        free = shutil.disk_usage(work).free
        need = ELASTIC["space_factor"] * 6.58e9
        log(f"[elastic-train] {work}: {free / 1e9:.1f} GB free")
        if free < need:
            raise AssertionError(f"elastic-train needs {need / 1e9:.1f} GB "
                                 f"free for its checkpoint")
        out, ckpt = work / "run", work / "ckpt"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        env = dict(os.environ)
        env.pop("PARALLAX_RUN_OPTION", None)
        env.update({"PYTHONPATH": str(ROOT) + os.pathsep
                    + env.get("PYTHONPATH", ""),
                    "PARALLAX_DIST_TIMEOUT": "300"})
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "tests" / "torch_elastic_driver.py"),
             str(out), str(ckpt), "--lm1b"], cwd=str(ROOT), env=env,
            capture_output=True, text=True, timeout=ELASTIC["timeout_s"])
        wall = time.time() - t0
        logs = work / "run.logs"

        def tail(name):
            path = logs / name
            return path.read_text()[-3000:] if path.exists() else ""

        if proc.returncode != 0:
            raise AssertionError(
                f"elastic-train master exited {proc.returncode}: "
                f"{proc.stderr[-3000:]}\nattempt 0: "
                f"{tail('log_worker0_stderr')}\nattempt 1: "
                f"{tail('log_worker0_attempt1_stderr')}")
        master = json.loads(Path(f"{out}.master.json").read_text())
        kinds = [(e["kind"], e.get("fields", {}).get("rc"))
                 for e in master["events"]]
        if kinds != [("launch", None), ("elastic_restart", 137),
                     ("exit", 0)]:
            raise AssertionError(f"elastic-train journal {kinds}")
        want_logs = sorted(f"log_worker0{a}_{k}" for a in ("", "_attempt1")
                           for k in ("stdout", "stderr"))
        if master["logs"] != want_logs:
            raise AssertionError(f"elastic-train redirect logs "
                                 f"{master['logs']}")
        att = [json.loads(Path(f"{out}.attempt{k}.json").read_text())
               for k in (0, 1)]
        resumed = list(range(steps["ckpt_every"] + 1, steps["steps"] + 1))
        if att[1]["first_step"] != steps["ckpt_every"] \
                or sorted(int(k) for k in att[1]["losses"]) != resumed \
                or att[1]["overlap_checked"] != len(resumed):
            raise AssertionError(f"elastic-train resumed at step "
                                 f"{att[1]['first_step']}, ran "
                                 f"{sorted(att[1]['losses'])}, overlap "
                                 f"{att[1].get('overlap_checked')}")
        for step in resumed:
            if att[1]["losses"][str(step)] != att[0]["losses"][str(step)]:
                raise AssertionError(f"elastic-train step {step}: resumed "
                                     f"loss differs from the "
                                     f"uninterrupted run's")
        for a in att:
            n = a["steps_run"]
            if a["launches"] != {"lstm_fwd": 0, "lstm_fwd_res": n,
                                 "lstm_bwd": n}:
                raise AssertionError(f"elastic-train attempt "
                                     f"{a['attempt']}: LSTM launches "
                                     f"{a['launches']} over {n} steps")
        m0, m1 = att[0]["marks"], att[1]["marks"]
        restart = next(e["ts"] for e in master["events"]
                       if e["kind"] == "elastic_restart")
        split = {"teardown_s": restart - m0["crash"],
                 "spawn_s": m1["start"] - restart,
                 "process_group_s": m1["process_group"] - m1["start"],
                 "restore_s": m1["restored"] - m1["process_group"],
                 "capture_s": m1["first_step"] - m1["restored"]}
        launches = add_counts(dict(att[0]["launches"]), att[1]["launches"])
        summary = {"card": card,
                   "time_to_recover_s": m1["first_step"] - m0["crash"],
                   **split, "attempt0_steps": sorted(
                       int(k) for k in att[0]["losses"]),
                   "attempt1_steps": sorted(int(k) for k in
                                            att[1]["losses"]),
                   "overlap_bitwise": att[1]["overlap_checked"],
                   "losses_bitwise_equal_uninterrupted": True,
                   "journal": [k for k, _ in kinds], "wall_s": wall,
                   "launches": launches}
        log(f"[elastic-train] {json.dumps(summary)}")
        return summary
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
    words = []
    # the warmup through run_iter too: the staging ring's slots are
    # allocated before the clock starts
    losses = list(sess.run_iter(
        (batches[i % 4] for i in range(NMT_TRAIN["warmup"])),
        fetches="loss"))
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
    flash kernels (fp32 B4 and B6 the split-operand TF32 ones, B5 the
    first kernel) and through the plain attention with autograd."""
    from parallax_tpu_torch.ops import flash_attention as fa
    losses = {}
    for name, pallas in (("kernel", True), ("plain", False)):
        cfg, sess = nmt_train_session(torch, use_pallas_attention=pallas,
                                      compute_dtype=torch.float32)
        batches = nmt_batches(cfg)
        for counter in FLASH_COUNTERS:
            setattr(fa, counter, 0)
        losses[name] = [float(sess.run("loss", feed_dict=batches[i]))
                        for i in range(3)]
        if pallas:
            launches = {c: getattr(fa, c) for c in FLASH_COUNTERS}
        sess.close()
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["kernel"],
                                               losses["plain"])]
    summary = {"losses": losses, "max_rel_diff": max(rel), "tol": 1e-4,
               "launches": launches}
    log(f"[nmt-train-agree] {json.dumps(summary)}")
    if not max(rel) <= 1e-4:
        raise AssertionError(f"NMT kernel and plain losses differ by "
                             f"{max(rel)} relative > 1e-4")
    if not all(launches.values()):
        raise AssertionError(f"fp32 NMT training launched no flash kernel "
                             f"of some kind: {launches}")
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


def bert_model_flops(cfg, batch, seq=None, masked=None):
    """Model FLOPs of one training step (forward x 3), counted dense from
    the shapes: the blocks' bf16 products (q/k/v, output, MLP, and the
    attention's two T x T products over every position, padding
    included), and the fp32 heads (MLM at the masked positions: dense and
    the [D, V] output; NSP). ``seq`` and ``masked`` default to the
    bert-train phase's."""
    D, M, V, L = cfg.hidden_dim, cfg.mlp_dim, cfg.padded_vocab, \
        cfg.num_layers
    T = BERT_TRAIN["seq"] if seq is None else seq
    masked = BERT_TRAIN["masked"] if masked is None else masked
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


SM90_FLASH = ("flash_fwd_kernel_sm90", "flash_dq_kernel_sm90",
              "flash_dkv_kernel_sm90")


def profile_groups(torch, sess, batches, steps, groups_of, flash=SM90_FLASH,
                   lstm=()):
    """``steps`` steps under the profiler's CUDA activity: busy ms a step,
    the idle share, busy by ``groups_of`` ((name, kernel-name pattern),
    first match wins) and the top kernels; the steps must launch every
    kernel of ``flash`` (the three sm90 flash kernels by default) and
    ``lstm`` and no first flash or LSTM kernel."""
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
            "flash_kernels": flash_kernels_seen(rows, list(flash)),
            "lstm_kernels": lstm_kernels_seen(rows, list(lstm)),
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
    # the session's step FLOPs (counted on meta tensors, the kernels'
    # plain versions) against the shape formula: the flash dq and dk/dv
    # passes each recompute the scores, about 3.8 % more at T 512
    summary["step_flops"] = sess.step_flops()
    summary["step_flops_over_formula"] = summary["step_flops"] / step_flop
    log(f"[bert-train] {json.dumps(summary)}")
    sess.close()
    torch.cuda.empty_cache()
    if not 1.0 <= summary["step_flops_over_formula"] <= 1.05:
        raise AssertionError(f"bert-train: step_flops "
                             f"{summary['step_flops']} against the "
                             f"formula's {step_flop}")
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
# lengths drawn in [64, 512] and ids in [1, 32000); the fp32 agreement
# phases (lc-serve-agree, moe-serve-agree) take 16 of them, each against an
# eager dense reference of up to 256 steps
LC_SERVE = dict(max_src_len=512, max_len=256, page_size=16, pool_pages=3072,
                max_batch=64, max_queue=512, requests=256, min_prompt=64,
                profile_requests=64, agree_requests=16)


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
    summary["served"] = [[len(p), len(o)] for p, o in zip(prompts, outs)]
    return summary


def moe_serve_b7(torch, served):
    """B7 at ``moe-serve``'s own positions (its S 64 G 1 D 512 page 16
    P 48 decode step over a 3072-page pool): slot ``s`` holds request
    ``s``, its last position drawn inside that request's served tokens.
    Checked against the plain version and timed as the kernel phase's
    cases are."""
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=DEVICE)
    case = ("moe_serve", LC_SERVE["max_batch"], 1, 512, 8,
            LC_SERVE["page_size"],
            -(-(LC_SERVE["max_src_len"] + LC_SERVE["max_len"])
              // LC_SERVE["page_size"]), LC_SERVE["pool_pages"],
            ("served", served[:LC_SERVE["max_batch"]]))
    r = run_paged_case(torch, case, torch.bfloat16, flush)
    del flush
    log(f"[moe-serve-b7] {'ok' if r['ok'] else 'FAILED'} err "
        f"{r['max_abs_err']:.3g} (tol {r['tol']:.3g}) kernel {r['ms']:.4f} "
        f"ms cold, {r['warm_ms']:.4f} ms warm (device {r['device_ms']} ms)"
        f" plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})")
    if not r["ok"]:
        raise AssertionError("moe-serve-b7: B7 disagrees with its plain "
                             "version at moe-serve's positions")
    return r


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
    # the rest of the warmup through run_iter: the staging ring's slots
    # are allocated before the clock starts
    losses += sess.run_iter(
        (batches[i % 4] for i in range(1, RESNET["warmup"])),
        fetches="loss")
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


# -- phases 14-18: chunked prefill, speculative decode, the prefix cache, ----
# -- LM1B serving -------------------------------------------------------------

# serve-spec: the serve phase's program with prefill_chunk_layers=1 and a
# one-layer layer-skip draft proposing 2 tokens an iteration (B7 verifies
# 3 queries a slot: the "serve_g3" kernel case)
SPEC = dict(spec_tokens=2, draft_layers=1, prefill_chunk_layers=1,
            profile_requests=64, agree_requests=32)
# serve-prefix: sources drawn as in the JAX package's shared_prefix_feed
# (tools/loadgen.py): with probability 0.5 one of 3 fixed 64-id sources,
# else a unique one of 32-64 ids; caps alternate 64 and 128. The "cow"
# round then sends 16 new 64-id sources at cap 40 (2.5 pages) and again
# at 128, so each continuation maps 2 cached pages and copies the third
PREFIX = dict(requests=256, share=0.5, pool=3, pool_seed=777, caps=(64, 128),
              ttft_ratio=0.8, cow_requests=16, cow_cap=40)
LC_CHUNKED = dict(requests=64)
# lm1b-serve: LM1BConfig() (bf16 compute, fp32 tables) at prompts of 2-20
# ids and 32 new tokens, 64 slots; 8 requests checked in fp32
LM1B_SERVE = dict(max_src_len=20, max_len=32, max_batch=64, requests=128,
                  min_prompt=2, check=8)
KERNEL_COUNTERS = (("flash_attention_fwd", "flash_attention", "launches"),
                   ("paged_decode_attention", "paged_attention", "launches"))


def launch_counts():
    import importlib
    return {name: getattr(importlib.import_module(
        f"parallax_tpu_torch.ops.{mod}"), attr)
        for name, mod, attr in KERNEL_COUNTERS}


def zero_launches():
    from parallax_tpu_torch.ops import flash_attention as fa
    from parallax_tpu_torch.ops import paged_attention as pa
    fa.launches = pa.launches = pa.launches_combine = 0


def serve_program(torch, cfg, params=None, spec=False, chunked=False,
                  draft_layers=SPEC["draft_layers"]):
    """The serve phase's NMTDecodeProgram, with chunked prefill and the
    layer-skip draft when asked."""
    import parallax_tpu_torch as pt
    kw = {}
    if chunked:
        kw["prefill_chunk_layers"] = SPEC["prefill_chunk_layers"]
    if spec:
        dcfg, dparams = pt.serve.layer_skip_draft(cfg, params, draft_layers)
        kw.update(spec_tokens=SPEC["spec_tokens"], draft_cfg=dcfg,
                  draft_params=dparams)
    return pt.NMTDecodeProgram(
        cfg, max_src_len=SERVE["max_src_len"], max_len=SERVE["max_len"],
        page_size=SERVE["page_size"], pool_pages=SERVE["pool_pages"],
        attn_impl="kernel", device=DEVICE, **kw)


def serve_session(torch, prog, params, **sc_kw):
    import parallax_tpu_torch as pt
    return pt.ServeSession(
        program=prog, params=params, device=DEVICE,
        config=pt.Config(serve_config=pt.ServeConfig(
            max_batch=SERVE["max_batch"], max_queue=SERVE["max_queue"],
            **sc_kw)))


def serve_round(sess, feeds, caps):
    """One round of requests through a live session: (outputs, wall s,
    the stats before and after it). The garbage of earlier phases (a
    profiler's events, closed sessions) is collected first, so that a
    collection does not land inside the timed round."""
    gc.collect()
    before = sess.stats()
    t0 = time.perf_counter()
    reqs = [sess.submit(f, max_new_tokens=c) for f, c in zip(feeds, caps)]
    outs = [r.result(timeout=900) for r in reqs]
    return outs, time.perf_counter() - t0, before, sess.stats()


def round_ttft_p50(sess, n):
    """The TTFT p50 of the last ``n`` completed requests (their
    lifecycle records)."""
    recs = sess.request_records(n)
    return statistics.median(r["ttft_ms"] for r in recs)


def profile_serving(torch, run, label):
    """``run()`` under the profiler's CUDA activity: the card's busy time,
    the idle share of the window, the paged and flash kernels seen (the
    sm90 ones, never a first kernel) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = run()
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
    return got, {"window_s": window, "device_busy_s": busy_s,
                 "device_busy_share": busy_s / window,
                 "device_idle_share": 1.0 - busy_s / window,
                 "paged_kernels": paged_kernels_seen(rows),
                 "flash_kernels": flash_kernels_seen(
                     rows, ["flash_fwd_kernel_sm90"]),
                 "top": [{"name": key[:90], "calls": n, "ms": us / 1e3,
                          "share_of_busy": us / 1e6 / busy_s}
                         for us, n, key in rows[:8]]}


def phase_serve_spec(torch, cfg, params, requests):
    """The serve phase's 256 requests through chunked prefill
    (``prefill_chunk_layers=1``: 7 graphs a prefill, one chunk an
    iteration) and speculative decoding (a one-layer layer-skip draft,
    2 tokens proposed an iteration, the target's verify through B7 at 3
    queries a slot). B7 must launch 6 times a verify iteration and B4
    6 + 1 times a prefill (the target's encoder layers, the draft's
    one), beyond the warmup's own launches, which are counted apart:
    the chunk graphs' capture and replay (2 x 7 B4) and the speculative
    graph's capture (6 B7). Then ``profile_requests`` under the
    profiler: busy and idle share, ``paged_decode_kernel_sm90`` and
    ``flash_fwd_kernel_sm90`` and no first kernel."""
    from parallax_tpu_torch.ops import paged_attention as pa
    L = cfg.num_layers
    torch.cuda.synchronize()
    zero_launches()
    prog = serve_program(torch, cfg, params, spec=True, chunked=True)
    sess = serve_session(torch, prog, params)
    torch.cuda.synchronize()
    warm = launch_counts()
    try:
        outs, wall, _, stats = serve_round(
            sess, [{"src": s} for s, _ in requests],
            [c for _, c in requests])
    finally:
        sess.close()
    torch.cuda.synchronize()
    launches = launch_counts()
    stats = sess.stats()
    check_outputs(requests, outs, cfg.vocab_size)
    iters, prefills = stats["serve.decode_steps"], stats["serve.prefills"]
    want_warm = {"flash_attention_fwd": 2 * (L + 1),
                 "paged_decode_attention": L}
    want = {"flash_attention_fwd": want_warm["flash_attention_fwd"]
            + (L + 1) * prefills,
            "paged_decode_attention": want_warm["paged_decode_attention"]
            + L * iters}
    if warm != want_warm or launches != want or pa.launches_combine:
        raise AssertionError(
            f"serve-spec launches {launches} (warmup {warm}, combine "
            f"{pa.launches_combine}) != {want} (warmup {want_warm}) for "
            f"{iters} iterations and {prefills} prefills")
    if stats["serve.prefill_chunks"] != prefills * (L + 1) or \
            prefills != len(requests):
        raise AssertionError(f"serve-spec: {stats['serve.prefill_chunks']}"
                             f" chunks for {prefills} prefills")
    if stats["serve.kv_pages_in_use"] != 0 or \
            stats["serve.completed"] != len(requests):
        raise AssertionError(f"serve-spec: pages {stats['serve.kv_pages_in_use']}"
                             f", completed {stats['serve.completed']}")
    tokens = int(sum(len(o) for o in outs))
    accepted, proposed = stats["serve.spec_accepted"], \
        stats["serve.spec_proposed"]
    n = SPEC["profile_requests"]

    def run():
        sess2 = serve_session(torch, serve_program(torch, cfg, params,
                                                   spec=True, chunked=True),
                              params)
        try:
            return serve_round(sess2, [{"src": s} for s, _ in requests[:n]],
                               [c for _, c in requests[:n]])[3]
        finally:
            sess2.close()

    pstats, prof = profile_serving(torch, run, "serve-spec")
    summary = {"requests": len(requests), "tokens": tokens, "wall_s": wall,
               "tokens_per_sec": tokens / wall,
               "iteration_ms_p50": stats["serve.step_ms"]["p50"],
               "iteration_ms_p95": stats["serve.step_ms"]["p95"],
               "ttft_ms_p50": stats["serve.ttft_ms"]["p50"],
               "iterations": iters, "tokens_per_iteration": tokens / iters,
               "tokens_per_slot_iteration":
                   tokens / (proposed / SPEC["spec_tokens"]),
               "accept_rate": accepted / proposed,
               "spec_proposed": proposed, "spec_accepted": accepted,
               "prefills": prefills,
               "prefill_chunks": stats["serve.prefill_chunks"],
               "launches": launches, "warmup_launches": warm,
               "graph_captures": stats["serve.graph_captures"],
               "capture_s": stats["serve.compile_seconds"]["max"],
               "profile": {"requests": n,
                           "iterations": pstats["serve.decode_steps"],
                           "busy_ms_per_iteration":
                               prof["device_busy_s"] * 1e3
                               / pstats["serve.decode_steps"], **prof}}
    log(f"[serve-spec] {json.dumps(summary)}")
    return summary


def phase_serve_spec_agree(torch, params, cfg_bf16, requests):
    """``agree_requests`` requests through the same stack (chunked
    prefill, the draft, B7 at 3 queries a slot) in fp32 with TF32 off:
    each request's tokens against the plain ``greedy_decode`` and against
    the program's own ``standalone_greedy`` (one slot, plain steps); a
    difference passes only where the plain path's top-2 logit gap is at
    most 1e-3 at the first differing position, as in ``agreement``. Then
    the same requests with the whole target as its own draft
    (``layer_skip_draft(cfg, params, 6)``): its proposals must be
    accepted (rate above 0.9: the draft's dense plain attention and the
    target's B7 verify differ only in rounding), and its tokens must
    equal the first run's."""
    from parallax_tpu_torch.models import nmt
    from parallax_tpu_torch.serve import standalone_greedy
    cfg = dataclasses.replace(cfg_bf16, compute_dtype=torch.float32)
    ref_cfg = dataclasses.replace(cfg, use_pallas_attention=False)
    prog = serve_program(torch, cfg, params, spec=True, chunked=True)
    sess = serve_session(torch, prog, params)
    try:
        outs, _, _, stats = serve_round(
            sess, [{"src": s} for s, _ in requests],
            [c for _, c in requests])
    finally:
        sess.close()
    stats = sess.stats()
    check_outputs(requests, outs, cfg.vocab_size)
    near = {"greedy": [], "standalone": []}
    for i, ((src, cap), out) in enumerate(zip(requests, outs)):
        greedy = nmt.greedy_decode(params, ref_cfg, src[None],
                                   max_len=cap)[0].cpu().numpy()
        eos = np.flatnonzero(greedy == nmt.EOS_ID)
        if eos.size:
            greedy = greedy[:eos[0] + 1]
        alone = np.asarray(standalone_greedy(prog, params, {"src": src}, cap))
        for what, ref in (("greedy", greedy), ("standalone", alone)):
            if len(ref) == len(out) and np.array_equal(ref, out):
                continue
            n = min(len(ref), len(out))
            first = int(np.flatnonzero(ref[:n] != out[:n])[0]) if \
                not np.array_equal(ref[:n], out[:n]) else n
            gap, top2 = top2_gap(torch, params, ref_cfg, src, first)
            near[what].append({"request": i, "position": first,
                               "top2_gap": gap, "top2_tokens": top2})
            log(f"[serve-spec-agree] request {i} against {what}: first "
                f"difference at {first}, plain top-2 gap {gap:.3g}")
            if not gap <= 1e-3:
                raise AssertionError(
                    f"serve-spec request {i} differs from {what} at "
                    f"{first} where the plain top-2 gap is {gap:.3g}")
    perfect = serve_session(torch, serve_program(
        torch, cfg, params, spec=True, chunked=True,
        draft_layers=cfg.num_layers), params)
    try:
        p_outs, _, _, p_stats = serve_round(
            perfect, [{"src": s} for s, _ in requests],
            [c for _, c in requests])
    finally:
        perfect.close()
    p_rate = p_stats["serve.spec_accepted"] / p_stats["serve.spec_proposed"]
    p_differ = [i for i, (a, b) in enumerate(zip(p_outs, outs))
                if not np.array_equal(a, b)]
    summary = {"requests": len(requests),
               "perfect_draft": {
                   "accept_rate": p_rate,
                   "tokens_per_slot_iteration": p_stats["serve.tokens"]
                   / (p_stats["serve.spec_proposed"] / SPEC["spec_tokens"]),
                   "differing_from_first_run": p_differ},
               "identical_to_greedy": len(requests) - len(near["greedy"]),
               "identical_to_standalone":
                   len(requests) - len(near["standalone"]),
               "near_ties": near,
               "accept_rate": stats["serve.spec_accepted"]
               / stats["serve.spec_proposed"],
               "kv_pages_in_use": stats["serve.kv_pages_in_use"]}
    log(f"[serve-spec-agree] {json.dumps(summary)}")
    if stats["serve.kv_pages_in_use"] != 0:
        raise AssertionError("KV pages left in use in serve-spec-agree")
    if not p_rate > 0.9 or p_differ:
        raise AssertionError(f"serve-spec-agree with the target as its own "
                             f"draft: accept rate {p_rate}, tokens differ "
                             f"in {p_differ}")
    return summary


def prefix_requests(vocab):
    """``PREFIX['requests']`` sources by the shared_prefix_feed rule at
    the serving geometry, with their caps (alternating), and how many
    came from the shared pool."""
    pr = np.random.default_rng(PREFIX["pool_seed"])
    Ts = SERVE["max_src_len"]
    pool = [pr.integers(3, vocab, (Ts,)).astype(np.int32)
            for _ in range(PREFIX["pool"])]
    out = []
    shared = 0
    for i in range(PREFIX["requests"]):
        r = np.random.default_rng(3000 + i)
        if r.random() < PREFIX["share"]:
            src = pool[int(r.integers(0, len(pool)))]
            shared += 1
        else:
            src = r.integers(3, vocab, (int(r.integers(Ts // 2, Ts + 1)),)
                             ).astype(np.int32)
        out.append((src, PREFIX["caps"][i % 2]))
    return out, shared


def phase_serve_prefix(torch, cfg, params):
    """The serve phase's program behind ``ServeConfig(prefix_cache=True)``:
    rounds of the same 256 requests with sharing off, then in one session
    cold, warm and extended (every cap 128: replays continue past the
    cached tokens, copying a boundary page when it is partial), then the
    "cow" round (16 new sources at cap 40, then at 128: at least one
    copy-on-write copy). Every round's tokens equal the sharing-off
    session's (the extended round's start with them, and equal them where
    they ended at EOS; the cow round's at 128 equal them); warm
    TTFT p50 at most 0.8 x cold; no page in use after close."""
    reqs, shared = prefix_requests(cfg.vocab_size)
    feeds = [{"src": s} for s, _ in reqs]
    caps = [c for _, c in reqs]
    # the cow round's sources: unique, never sent before it
    cow_feeds = [{"src": np.random.default_rng(3000 + PREFIX["requests"] + i)
                  .integers(3, cfg.vocab_size, (SERVE["max_src_len"],))
                  .astype(np.int32)} for i in range(PREFIX["cow_requests"])]
    cap = max(PREFIX["caps"])
    zero_launches()
    off = serve_session(torch, serve_program(torch, cfg), params)
    try:
        base, wall_off, _, _ = serve_round(off, feeds, caps)
        ttft_off = round_ttft_p50(off, len(reqs))
        cow_base = serve_round(off, cow_feeds, [cap] * len(cow_feeds))[0]
    finally:
        off.close()
    prog = serve_program(torch, cfg)
    sess = serve_session(torch, prog, params, prefix_cache=True)
    rounds = {}
    try:
        for name, rcaps in (("cold", caps), ("warm", caps),
                            ("extended", [max(PREFIX["caps"])] * len(reqs))):
            outs, wall, before, after = serve_round(sess, feeds, rcaps)
            delta = {k: after[k] - before[k] for k in (
                "serve.prefix.hits", "serve.prefix.misses",
                "serve.prefix.full_hits", "serve.prefix.cow_copies",
                "serve.prefix.replayed_tokens", "serve.prefills",
                "serve.decode_steps", "serve.tokens")}
            rounds[name] = {"outs": outs, "wall_s": wall,
                            "ttft_ms_p50": round_ttft_p50(sess, len(reqs)),
                            "decoded_tokens_per_sec":
                                delta["serve.tokens"] / wall,
                            **{k.split(".")[-1]: v for k, v in delta.items()},
                            "evictions": after["serve.prefix.evictions"]}
        # the copy-on-write round: new sources, cached at a cap that
        # ends inside a page, then continued to the full cap
        serve_round(sess, cow_feeds, [PREFIX["cow_cap"]] * len(cow_feeds))
        cow_outs, _, before, after = serve_round(
            sess, cow_feeds, [cap] * len(cow_feeds))
        rounds["cow"] = {"requests": len(cow_feeds), **{
            k.split(".")[-1]: after[k] - before[k] for k in (
                "serve.prefix.hits", "serve.prefix.full_hits",
                "serve.prefix.cow_copies", "serve.prefix.replayed_tokens")}}
        live = sess.stats()
        pstats = sess.prefix_stats()
    finally:
        sess.close()
    stats = sess.stats()
    launches = launch_counts()
    differ = {"cow": [i for i, (a, b) in enumerate(zip(cow_outs, cow_base))
                      if not np.array_equal(a, b)]}
    for name, r in rounds.items():
        if name == "cow":
            continue
        bad = []
        for i, (a, b) in enumerate(zip(r["outs"], base)):
            if name == "extended":
                ok = np.array_equal(a[:len(b)], b) and (
                    len(b) == caps[i] or np.array_equal(a, b))
            else:
                ok = np.array_equal(a, b)
            if not ok:
                bad.append(i)
        differ[name] = bad
    summary = {"requests": len(reqs),
               "shared": shared,
               "off": {"wall_s": wall_off, "ttft_ms_p50": ttft_off,
                       "tokens_per_sec": sum(len(o) for o in base)
                       / wall_off},
               **{name: {k: v for k, v in r.items() if k != "outs"}
                  for name, r in rounds.items()},
               "differing": differ, "prefix_stats": pstats,
               "kv_sharing_ratio_live": live["serve.kv_sharing_ratio"],
               "kv_pages_in_use_after_close": stats["serve.kv_pages_in_use"],
               "launches": launches}
    log(f"[serve-prefix] {json.dumps(summary)}")
    if any(differ.values()):
        raise AssertionError(f"serve-prefix: tokens differ from the "
                             f"sharing-off round in {differ}")
    if not rounds["warm"]["ttft_ms_p50"] <= \
            PREFIX["ttft_ratio"] * rounds["cold"]["ttft_ms_p50"]:
        raise AssertionError(f"serve-prefix: warm TTFT p50 "
                             f"{rounds['warm']['ttft_ms_p50']} ms > "
                             f"{PREFIX['ttft_ratio']} x cold "
                             f"{rounds['cold']['ttft_ms_p50']} ms")
    if stats["serve.kv_pages_in_use"] != 0:
        raise AssertionError("serve-prefix: pages in use after close")
    if rounds["cow"]["cow_copies"] < 1:
        raise AssertionError(f"serve-prefix: the cow round made no "
                             f"copy-on-write copy: {rounds['cow']}")
    return summary


def phase_lc_serve_chunked(torch, cfg, params, prompts, lc_summary):
    """``lc-serve``'s program with ``prefill_chunk_layers=1`` on 64 of its
    prompts, beside the unchunked program on the same prompts in this
    call: tokens identical (the same kernels in the same order), TTFT p50
    and decode p50 of both, and B7 6 times a decode step."""
    from parallax_tpu_torch.ops import paged_attention as pa
    L = cfg.num_layers
    outs = {}
    runs = {}
    launches = {}
    for name, kw in (("unchunked", {}), ("chunked",
                                         {"prefill_chunk_layers": 1})):
        torch.cuda.synchronize()
        zero_launches()
        o, wall, stats, prog = lc_serve(torch, cfg, params, prompts, **kw)
        torch.cuda.synchronize()
        outs[name] = o
        launches[name] = launch_counts()
        want = {"flash_attention_fwd": 0, "paged_decode_attention":
                (stats["serve.decode_steps"] + 1) * L}
        if launches[name] != want or pa.launches_combine:
            raise AssertionError(f"lc-serve-chunked {name} launches "
                                 f"{launches[name]} != {want}")
        if stats["serve.kv_pages_in_use"] != 0:
            raise AssertionError(f"lc-serve-chunked {name}: pages in use")
        runs[name] = {"tokens_per_sec": sum(len(x) for x in o) / wall,
                      "ttft_ms_p50": stats["serve.ttft_ms"]["p50"],
                      "step_ms_p50": stats["serve.step_ms"]["p50"],
                      "decode_steps": stats["serve.decode_steps"],
                      "prefill_chunks": stats.get("serve.prefill_chunks"),
                      "graph_captures": stats["serve.graph_captures"]}
    differ = [i for i, (a, b) in enumerate(zip(outs["chunked"],
                                               outs["unchunked"]))
              if not np.array_equal(a, b)]
    summary = {"requests": len(prompts), **runs,
               "lc_serve_ttft_ms_p50": lc_summary["ttft_ms_p50"],
               "lc_serve_step_ms_p50": lc_summary["step_ms_p50"],
               "identical_tokens": not differ, "differing": differ,
               "launches": launches["chunked"]}
    log(f"[lc-serve-chunked] {json.dumps(summary)}")
    if differ:
        raise AssertionError(f"lc-serve-chunked: chunked tokens differ in "
                             f"requests {differ}")
    if runs["chunked"]["prefill_chunks"] != len(prompts) * (L + 1):
        raise AssertionError("lc-serve-chunked: chunk count")
    return summary


def lm1b_top2_gap(torch, prog, params, prompt, position):
    """The program's own top-2 logit gap at decode ``position`` of one
    request decoded alone (its greedy prefix fed back)."""
    from parallax_tpu_torch.models import lm1b
    cp = prog._compute_params(params)
    ids = torch.as_tensor(prog.prepare_feed({"ids": prompt})["ids"][None],
                          device=DEVICE)
    c, h, _, first = lm1b._lstm_prefill(prog.cfg, cp, ids, prog.pad_id)
    tok = first
    for _ in range(position + 1):
        logits, c, h = lm1b._lstm_decode_step(prog.cfg, cp, tok, c, h)
        tok = logits.argmax(dim=-1).to(torch.int32)
    top = logits[0].topk(2)
    return (top.values[0] - top.values[1]).item(), top.indices.tolist()


def phase_lm1b_serve(torch):
    """``LM1BDecodeProgram(LM1BConfig(), max_src_len=20, max_len=32)`` at
    LM1B's published widths (bf16 cells, fp32 tables and the full
    793,470-word softmax), 64 slots, 128 prompts of 2-20 ids: tokens/s
    and step p50 (plain cells: no kernel on this path). Then 8 of them
    served by the fp32 program (TF32 off) against its
    ``standalone_greedy``, under the top-2-gap rule."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import lm1b
    from parallax_tpu_torch.serve import standalone_greedy
    cfg = lm1b.LM1BConfig()
    params = lm1b.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, (int(rng.integers(
        LM1B_SERVE["min_prompt"], LM1B_SERVE["max_src_len"] + 1)),))
        .astype(np.int32) for _ in range(LM1B_SERVE["requests"])]
    out = {}
    for name, c in (("bf16", cfg),
                    ("fp32", dataclasses.replace(
                        cfg, compute_dtype=torch.float32))):
        prog = pt.LM1BDecodeProgram(c, LM1B_SERVE["max_src_len"],
                                    LM1B_SERVE["max_len"], device=DEVICE)
        sess = pt.ServeSession(
            program=prog, params=params, device=DEVICE,
            config=pt.Config(serve_config=pt.ServeConfig(
                max_batch=LM1B_SERVE["max_batch"], max_queue=512)))
        use = prompts if name == "bf16" else prompts[:LM1B_SERVE["check"]]
        try:
            outs, wall, _, _ = serve_round(sess, [{"ids": p} for p in use],
                                           [LM1B_SERVE["max_len"]] * len(use))
        finally:
            sess.close()
        stats = sess.stats()
        for o in outs:
            if o.shape != (LM1B_SERVE["max_len"],) or o.min() < 0 or \
                    o.max() >= cfg.vocab_size:
                raise AssertionError(f"lm1b-serve: bad output {o.shape}")
        out[name] = {"requests": len(use), "wall_s": wall,
                     "tokens_per_sec": sum(len(o) for o in outs) / wall,
                     "step_ms_p50": stats["serve.step_ms"]["p50"],
                     "step_ms_p95": stats["serve.step_ms"]["p95"],
                     "ttft_ms_p50": stats["serve.ttft_ms"]["p50"],
                     "decode_steps": stats["serve.decode_steps"],
                     "graphs": prog._graphs is not None}
        if not out[name]["graphs"]:
            raise AssertionError("lm1b-serve: the program captured no graph")
        if name == "fp32":
            near = []
            for i, (p, o) in enumerate(zip(use, outs)):
                ref = np.asarray(standalone_greedy(prog, params, {"ids": p},
                                                   LM1B_SERVE["max_len"]))
                if np.array_equal(ref, o):
                    continue
                first = int(np.flatnonzero(ref != o)[0])
                gap, top2 = lm1b_top2_gap(torch, prog, params, p, first)
                near.append({"request": i, "position": first,
                             "top2_gap": gap, "top2_tokens": top2})
                if not gap <= 1e-3:
                    raise AssertionError(
                        f"lm1b-serve request {i} differs from "
                        f"standalone_greedy at {first}, top-2 gap {gap:.3g}")
            out[name]["identical_to_standalone"] = len(use) - len(near)
            out[name]["near_ties"] = near
        del prog, sess
    del params
    torch.cuda.empty_cache()
    log(f"[lm1b-serve] {json.dumps(out)}")
    return out


# -- one-shot serving, the fleet and disaggregation -----------------------------

# oneshot: the translator behind the micro-batcher, 12 signatures (batch
# buckets 1-32 x lengths 32 and 64), every request decoded to 128 tokens
# one batch bucket (every batch padded to 32 rows): 2 captures, not 12,
# and a request's output independent of the batch it lands in
ONESHOT = dict(max_batch=32, batch_buckets=(32,), length_buckets=(32, 64),
               max_wait_ms=2, max_len=128, agree_requests=32)
# fleet: two decode replicas on the card, replica 0 crashed after its
# 200th dispatch (scheduler loop pass) once traffic starts; then a third
# replica scaled up, 3 NMT training steps pushed under traffic
FLEET = dict(replicas=2, crash_after=200, train_steps=3,
             swap_requests=64, agree_requests=32)


def agree_tokens(torch, params, ref_cfg, requests, outs, label):
    """Each served token row against the plain path's ``greedy_decode``
    of the request alone (cut after EOS), under the top-2-gap rule: a
    row may differ only from a position where the plain path's top-2
    logit gap is at most 1e-3. Returns the near ties."""
    from parallax_tpu_torch.models import nmt
    near = []
    for i, ((src, cap), out) in enumerate(zip(requests, outs)):
        out = np.asarray(out)
        ref = nmt.greedy_decode(params, ref_cfg, src[None],
                                max_len=cap)[0].cpu().numpy()
        eos = np.flatnonzero(ref == nmt.EOS_ID)
        if eos.size:
            ref = ref[:eos[0] + 1]
        eos = np.flatnonzero(out == nmt.EOS_ID)
        if eos.size:
            out = out[:eos[0] + 1]
        if len(ref) == len(out) and np.array_equal(ref, out):
            continue
        n = min(len(ref), len(out))
        first = int(np.flatnonzero(ref[:n] != out[:n])[0]) if \
            not np.array_equal(ref[:n], out[:n]) else n
        gap, top2 = top2_gap(torch, params, ref_cfg, src, first)
        near.append({"request": i, "position": first, "top2_gap": gap,
                     "top2_tokens": top2})
        log(f"[{label}] request {i}: first difference at {first}, plain "
            f"top-2 gap {gap:.3g} between tokens {top2}")
        if not gap <= 1e-3:               # NaN fails too
            raise AssertionError(
                f"{label}: request {i} differs at position {first} where "
                f"the plain path's top-2 gap is {gap:.3g} > 1e-3")
    return near


def oneshot_session(torch, cfg, params, session_kw=None, **sc_kw):
    """``ServeSession(infer_fn, params, example_feed=...)`` with the
    translator as ``infer_fn``: ``greedy_decode`` of a micro-batch of
    sources padded to a length bucket. Its warmup captures every (batch,
    length) signature. ``session_kw``: more ``ServeSession`` arguments
    (the mesh and the model of ``serve-mesh``)."""
    sc_kw.setdefault("batch_buckets", ONESHOT["batch_buckets"])
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import nmt

    def infer_fn(p, batch):
        return {"tokens": nmt.greedy_decode(p, cfg, batch["src"],
                                            max_len=ONESHOT["max_len"])}

    return pt.ServeSession(
        infer_fn, params, device=DEVICE, **(session_kw or {}),
        example_feed={"src": np.full((max(ONESHOT["length_buckets"]),),
                                     nmt.PAD_ID, np.int32)},
        ragged_feeds=("src",), pad_value=nmt.PAD_ID,
        config=pt.Config(serve_config=pt.ServeConfig(
            max_batch=ONESHOT["max_batch"],
            length_buckets=list(ONESHOT["length_buckets"]),
            max_wait_ms=ONESHOT["max_wait_ms"],
            max_queue=SERVE["max_queue"], **sc_kw)))


def phase_oneshot(torch, cfg, params, requests):
    """The 256 requests (their sources; every one decoded to 128 tokens)
    through the one-shot translator: warmup seconds and graphs captured
    (2), requests/s, latency p50/p95, batch occupancy,
    ``serve.recompiles`` (0). B4 launches 6 times a batch beyond the
    warmup's 6 a signature. Then 32 requests in fp32 (one batch bucket,
    32: two captures) against ``greedy_decode`` of each alone, under the
    top-2-gap rule."""
    from parallax_tpu_torch.models import nmt
    from parallax_tpu_torch.ops import flash_attention as fa
    L = cfg.num_layers
    zero_launches()
    t0 = time.perf_counter()
    sess = oneshot_session(torch, cfg, params)
    warmup_s = time.perf_counter() - t0
    warm_launches = launch_counts()
    try:
        gc.collect()
        t0 = time.perf_counter()
        reqs = [sess.submit({"src": src}) for src, _ in requests]
        outs = [r.result(timeout=900)["tokens"] for r in reqs]
        wall = time.perf_counter() - t0
    finally:
        sess.close()
    served = outs
    stats = sess.stats()
    launches = launch_counts()
    vocab = cfg.vocab_size
    for out in outs:
        if out.shape != (ONESHOT["max_len"],) or out.min() < 0 \
                or out.max() >= vocab:
            raise AssertionError(f"oneshot: bad output {out.shape}, "
                                 f"range [{out.min()}, {out.max()}]")
    sigs = len(ONESHOT["length_buckets"]) * len(ONESHOT["batch_buckets"])
    want = {"flash_attention_fwd": (stats["serve.batches"] + sigs) * L,
            "paged_decode_attention": 0}
    lat = stats["serve.request_latency_ms"]
    occ = stats["serve.batch_occupancy"]
    summary = {"requests": len(requests), "wall_s": wall,
               "requests_per_sec": len(requests) / wall,
               "tokens_per_sec": len(requests) * ONESHOT["max_len"] / wall,
               "latency_ms_p50": lat["p50"], "latency_ms_p95": lat["p95"],
               "batches": stats["serve.batches"],
               "batch_occupancy_mean": occ["mean"],
               "batch_occupancy_p50": occ["p50"],
               "step_ms_p50": stats["serve.step_ms"]["p50"],
               "step_ms_p95": stats["serve.step_ms"]["p95"],
               "warmup_s": warmup_s,
               "capture_s_max": stats["serve.compile_seconds"]["max"],
               "graphs": stats["serve.graph_captures"],
               "recompiles": stats["serve.recompiles"],
               "warmup_launches": warm_launches, "launches": launches}
    log(f"[oneshot] {json.dumps(summary)}")
    if stats["serve.graph_captures"] != sigs:
        raise AssertionError(f"oneshot: {stats['serve.graph_captures']} "
                             f"graphs captured, not {sigs}")
    if stats["serve.recompiles"] != 0:
        raise AssertionError(f"oneshot: {stats['serve.recompiles']} "
                             f"captures at serve time")
    if stats["serve.completed"] != len(requests):
        raise AssertionError(f"oneshot: {stats['serve.completed']} of "
                             f"{len(requests)} requests completed")
    if launches != want:
        raise AssertionError(f"oneshot: launch counts {launches} != "
                             f"{want}")
    # fp32 (TF32 off) against greedy_decode of each request alone
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    n = ONESHOT["agree_requests"]
    sess = oneshot_session(torch, cfg32, params)
    try:
        reqs = [sess.submit({"src": src}) for src, _ in requests[:n]]
        outs = [r.result(timeout=900)["tokens"] for r in reqs]
    finally:
        sess.close()
    ref_cfg = dataclasses.replace(cfg32, use_pallas_attention=False)
    near = agree_tokens(torch, params, ref_cfg,
                        [(s, ONESHOT["max_len"]) for s, _ in requests[:n]],
                        outs, "oneshot-agree")
    summary["agreement"] = {"requests": n, "identical": n - len(near),
                            "near_ties": near}
    log(f"[oneshot-agree] {json.dumps(summary['agreement'])}")
    return summary, served


def fleet_factory(torch, cfg, params, programs, **sc_kw):
    """A decode-replica factory: each replica its own ``NMTDecodeProgram``
    at the serve phase's geometry (a program serves one live session),
    recorded in ``programs`` by replica id."""
    import parallax_tpu_torch as pt
    sc = pt.Config(serve_config=pt.ServeConfig(
        max_batch=SERVE["max_batch"], max_queue=SERVE["max_queue"],
        **sc_kw))

    def make_replica(rid, **kw):
        prog = serve_program(torch, cfg)
        programs[rid] = prog
        return pt.ServeSession(program=prog, params=params, config=sc,
                               device=DEVICE, **kw)
    return make_replica


def crash_injector(rid, after):
    """A ``FaultInjector`` that arms a crash on replica ``rid`` at its
    ``after``-th dispatch counted from ``start()``."""
    import parallax_tpu_torch as pt

    class Injector(pt.FaultInjector):
        def __init__(self):
            super().__init__()
            self.counting = False
            self.dispatches = {}
            self.active_at_crash = None

        def start(self):
            self.dispatches = {}
            self.counting = True

        def on_dispatch(self, replica_id):
            if self.counting:
                n = self.dispatches.get(replica_id, 0) + 1
                self.dispatches[replica_id] = n
                if replica_id == rid and n == after:
                    self.active_at_crash = self.fleet_load()
                    self.counting = False
                    self.arm(rid, "crash")
            return super().on_dispatch(replica_id)

    return Injector()


def detached(tree):
    """A parameter tree's leaves detached from autograd (copies)."""
    if isinstance(tree, dict):
        return {k: detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(detached(v) for v in tree)
    return tree.detach().clone()


def fleet_step_counts(fleet_stats):
    return {rid: (r["serve"].get("serve.decode_steps", 0),
                  r["serve"].get("serve.prefills", 0))
            for rid, r in fleet_stats["replicas"].items()}


def train_nmt(torch, cfg, steps):
    """A training session at the serving config (its parameter shapes)
    after ``steps`` NMT training steps (HYBRID, seed 0, the warmup of
    ``nmt-train``)."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import nmt
    tcfg = dataclasses.replace(cfg, warmup_steps=10)
    sess, *_ = pt.parallel_run(
        nmt.build_model(tcfg),
        parallax_config=pt.Config(run_option="HYBRID"), seed=SEED,
        device=DEVICE)
    batches = nmt_batches(tcfg)
    losses = [float(sess.run("loss", feed_dict=batches[i % len(batches)]))
              for i in range(steps)]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"fleet: training losses {losses}")
    return sess, losses


def phase_fleet(torch, cfg, params, requests, serve_summary):
    """Two NMT decode replicas on the card, each its own program: the 256
    requests with replica 0 crashed at its 200th dispatch (tokens/s
    beside the serve phase's, failovers, retries, ejections, requests
    lost: 0). Then a replica scaled up, and 3 NMT training steps pushed
    under traffic (``push_weights``: 2 hot swaps, no program captures
    anything after its warmup). B7 launches 6 times a decode step (each
    replica's warmup's once); B4 6 times a prefill (each warmup's twice).
    Then the same in fp32: 32 requests served after the push equal
    ``greedy_decode`` under the pushed weights, under the top-2-gap
    rule. The fleet serves its telemetry (``start_exporter``), scraped
    over 127.0.0.1 after the crash, and its flight recorder leaves one
    ``fleet_crash`` artifact with the fleet, router and in-flight
    sections."""
    import glob
    import shutil
    import tempfile
    import urllib.request
    import parallax_tpu_torch as pt
    from parallax_tpu_torch import obs
    L = cfg.num_layers
    programs = {}
    inj = crash_injector(0, FLEET["crash_after"])
    flight_dir = tempfile.mkdtemp(prefix="parallax-fleet-")
    anomaly, journal = obs.AnomalyMonitor(), obs.EventJournal()
    zero_launches()
    t0 = time.perf_counter()
    fleet = pt.ServeFleet(fleet_factory(torch, cfg, params, programs),
                          config=pt.FleetConfig(
                              num_replicas=FLEET["replicas"],
                              max_replicas=FLEET["replicas"] + 1),
                          faults=inj,
                          flight=obs.FlightRecorder(flight_dir=flight_dir),
                          anomaly=anomaly, journal=journal)
    exporter = fleet.start_exporter()
    inj.fleet_load = lambda: {h.rid: h.session.load()
                              for h in fleet._router.handles()}
    spinup_s = time.perf_counter() - t0
    try:
        gc.collect()
        inj.start()
        t0 = time.perf_counter()
        reqs = [fleet.submit({"src": src}, max_new_tokens=cap)
                for src, cap in requests]
        outs, lost = [], 0
        for r in reqs:
            try:
                outs.append(r.result(timeout=900))
            except Exception as e:
                lost += 1
                log(f"[fleet] request {r.id} lost: {e!r}")
        wall = time.perf_counter() - t0
        crash_stats = fleet.stats()
        t0 = time.perf_counter()
        with urllib.request.urlopen(exporter.url, timeout=30) as r:
            scrape = r.read().decode()
        scrape_ms = (time.perf_counter() - t0) * 1e3
        captures_warm = {rid: p.captures for rid, p in programs.items()}
        # restore two live replicas, then push trained weights under
        # traffic
        t0 = time.perf_counter()
        new_rid = fleet.scale_up(reason="replace the crashed replica")
        scale_up_s = time.perf_counter() - t0
        captures_warm[new_rid] = programs[new_rid].captures
        # the training steps launch B4-B6 too: their launches are taken
        # out of the serving counts (no request is in flight meanwhile)
        before = launch_counts()
        train, losses = train_nmt(torch, cfg, FLEET["train_steps"])
        torch.cuda.synchronize()
        train_launches = {k: v - before[k]
                          for k, v in launch_counts().items()}
        try:
            swap_reqs = [fleet.submit({"src": src}, max_new_tokens=cap)
                         for src, cap in requests[:FLEET["swap_requests"]]]
            t0 = time.perf_counter()
            outcome = train.push_weights(fleet)
            push_s = time.perf_counter() - t0
            pushed = detached(train.gather_params())
        finally:
            train.close()
        swap_lost = 0
        for r in swap_reqs:
            try:
                r.result(timeout=900)
            except Exception as e:
                swap_lost += 1
                log(f"[fleet] request {r.id} lost across the swap: {e!r}")
        end_stats = fleet.stats()
        recompiles = fleet.recompiles()
        rebaselines = anomaly.registry.counter(
            "anomaly.deliberate_changes").value
        churn = sorted({e["kind"] for e in journal.events()
                        if e["subsystem"] == "fleet"})
    finally:
        fleet.close()
        dumps = glob.glob(str(Path(flight_dir) / "flight_fleet_crash*"))
        incident = json.loads(Path(dumps[0]).read_text()) \
            if len(dumps) == 1 else None
        shutil.rmtree(flight_dir, ignore_errors=True)
    launches = {k: v - train_launches[k]
                for k, v in launch_counts().items()}
    scrape_ok = ('parallax_fleet_failovers{source="fleet"}' in scrape
                 and 'source="replica1"' in scrape)
    if not scrape_ok or exporter._server is not None:
        raise AssertionError(f"fleet: the exporter's scrape "
                             f"({len(scrape)} bytes) lacks the fleet's "
                             f"failovers or replica 1, or it outlived the "
                             f"fleet")
    if rebaselines < 2 or not churn:
        raise AssertionError(f"fleet: {rebaselines} deliberate changes "
                             f"reported to the anomaly monitor, journal "
                             f"churn {churn}")
    if incident is None or incident["detail"].get("replica") != 0 or any(
            incident.get(k) is None for k in (
                "fleet", "router", "requests_in_flight")):
        raise AssertionError(f"fleet: {len(dumps)} fleet_crash artifacts; "
                             f"sections {sorted(incident or {})}")
    captures_end = {rid: p.captures for rid, p in programs.items()}
    if not outs or lost:
        raise AssertionError(f"fleet: {lost} request(s) lost across the "
                             f"crash")
    check_outputs(requests, outs, cfg.vocab_size)
    steps = fleet_step_counts(end_stats)
    decode_steps = sum(s for s, _ in steps.values())
    prefills = sum(p for _, p in steps.values())
    n_rep = len(programs)
    want = {"flash_attention_fwd": (prefills + 2 * n_rep) * L,
            "paged_decode_attention": (decode_steps + n_rep) * L}
    tokens = int(sum(len(o) for o in outs))
    summary = {"requests": len(requests), "tokens": tokens,
               "wall_s": wall, "tokens_per_sec": tokens / wall,
               "serve_tokens_per_sec": serve_summary["tokens_per_sec"],
               "fleet_over_serve": tokens / wall
               / serve_summary["tokens_per_sec"],
               "spinup_s": spinup_s, "scale_up_s": scale_up_s,
               "push_s": push_s, "lost": lost, "swap_lost": swap_lost,
               "train_losses": losses, "train_launches": train_launches,
               "crash_dispatches": inj.dispatches,
               "crash_fired": inj.fired("crash"),
               "load_at_crash": inj.active_at_crash,
               **{k: crash_stats[k] for k in (
                   "fleet.failovers", "fleet.retries", "fleet.ejections",
                   "fleet.failed", "fleet.completed")},
               "hops": {str(n): sum(1 for r in reqs
                                    if len(r.replicas) == n)
                        for n in (1, 2, 3)},
               "latency_ms_p50": crash_stats[
                   "fleet.request_latency_ms"]["p50"],
               "latency_ms_p95": crash_stats[
                   "fleet.request_latency_ms"]["p95"],
               "hotswaps": end_stats["fleet.hotswaps"],
               "push_outcome": {str(k): v for k, v in outcome.items()},
               "drain_s": end_stats["fleet.drain_seconds"],
               "captures_after_warmup": captures_warm,
               "captures_end": captures_end, "recompiles": recompiles,
               "steps_by_replica": steps, "launches": launches,
               "scrape_ms": scrape_ms, "scrape_bytes": len(scrape),
               "rebaselines": rebaselines, "journal_churn": churn,
               "incident_sections": sorted(incident),
               "incident_affected": len(
                   incident["detail"].get("affected_requests") or [])}
    log(f"[fleet] {json.dumps(summary)}")
    if inj.fired("crash") != 1:
        raise AssertionError("fleet: the injected crash did not fire")
    if swap_lost or end_stats["fleet.hotswaps"] != 2:
        raise AssertionError(f"fleet: hotswaps "
                             f"{end_stats['fleet.hotswaps']} (want 2), "
                             f"{swap_lost} lost across the swap")
    if captures_end != captures_warm or recompiles:
        raise AssertionError(f"fleet: captures {captures_warm} -> "
                             f"{captures_end}, recompiles {recompiles}")
    if launches != want:
        raise AssertionError(f"fleet: launch counts {launches} != {want}")
    for rid, r in end_stats["replicas"].items():
        if r["serve"].get("serve.kv_pages_in_use") not in (0, None) \
                and not r["dead"]:
            raise AssertionError(f"fleet: replica {rid} pages in use")
    # fp32: tokens after the push against greedy_decode under the pushed
    # weights
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    n = FLEET["agree_requests"]
    fleet = pt.ServeFleet(fleet_factory(torch, cfg32, params, {}),
                          config=pt.FleetConfig(
                              num_replicas=FLEET["replicas"]))
    try:
        fleet.push_weights(pushed)
        outs32 = [r.result(timeout=900) for r in [
            fleet.submit({"src": src}, max_new_tokens=cap)
            for src, cap in requests[:n]]]
        swaps32 = fleet.stats()["fleet.hotswaps"]
    finally:
        fleet.close()
    ref_cfg = dataclasses.replace(cfg32, use_pallas_attention=False)
    near = agree_tokens(torch, pushed, ref_cfg, requests[:n], outs32,
                        "fleet-agree")
    summary["agreement"] = {"requests": n, "identical": n - len(near),
                            "near_ties": near, "hotswaps": swaps32}
    log(f"[fleet-agree] {json.dumps(summary['agreement'])}")
    return summary


def phase_disagg(torch, cfg, params, requests):
    """``DisaggFleet`` with one prefill replica and one decode replica,
    both ``ServeConfig(prefix_cache=True)``, against a colocated one-
    replica ``ServeFleet`` on the 256 requests: tokens equal, wire bytes
    a request, transfer ms p50, TTFT p50 beside colocated, no page in use
    after close. B4 runs on the prefill replica (6 a prefill, eagerly,
    plus each warmup's 12) and never on the decode replica beyond its
    warmup; B7 on the decode replica (6 a decode step, plus each
    warmup's 6)."""
    import parallax_tpu_torch as pt
    L = cfg.num_layers
    feeds = [{"src": src} for src, _ in requests]
    caps = [cap for _, cap in requests]

    def run(front):
        gc.collect()
        t0 = time.perf_counter()
        reqs = [front.submit(f, max_new_tokens=c)
                for f, c in zip(feeds, caps)]
        outs = [r.result(timeout=900) for r in reqs]
        ttft = statistics.median(
            (r.t_first_token - r.t_enqueue) * 1e3 for r in reqs)
        return outs, time.perf_counter() - t0, ttft

    colo = pt.ServeFleet(fleet_factory(torch, cfg, params, {},
                                       prefix_cache=True),
                         config=pt.FleetConfig(num_replicas=1))
    try:
        colo_outs, colo_wall, colo_ttft = run(colo)
    finally:
        colo.close()
    programs_p, programs_d = {}, {}
    zero_launches()
    d = pt.DisaggFleet(
        fleet_factory(torch, cfg, params, programs_p, prefix_cache=True),
        fleet_factory(torch, cfg, params, programs_d, prefix_cache=True),
        prefill_config=pt.FleetConfig(num_replicas=1),
        decode_config=pt.FleetConfig(num_replicas=1))
    warm = launch_counts()
    try:
        outs, wall, ttft = run(d)
        dstats = d.stats()
        recompiles = d.recompiles()
    finally:
        d.close()
    launches = launch_counts()
    snap = d.metrics.snapshot()
    dec = d.decode_fleet.stats()["replicas"]["0"]["serve"]
    pre = d.prefill_fleet.stats()["replicas"]["0"]["serve"]
    differ = [i for i, (a, b) in enumerate(zip(outs, colo_outs))
              if not np.array_equal(a, b)]
    transfers = snap["serve.disagg.transfers"]
    want = {"flash_attention_fwd": (transfers + dec["serve.prefills"]
                                    + pre["serve.prefills"] + 4) * L,
            "paged_decode_attention": (dec["serve.decode_steps"]
                                       + pre["serve.decode_steps"] + 2) * L}
    summary = {"requests": len(requests),
               "tokens_per_sec": sum(len(o) for o in outs) / wall,
               "colocated_tokens_per_sec": sum(len(o) for o in colo_outs)
               / colo_wall,
               "ttft_ms_p50": ttft, "colocated_ttft_ms_p50": colo_ttft,
               "transfers": transfers,
               "wire_bytes_per_request": snap[
                   "serve.disagg.transfer_bytes"] / max(transfers, 1),
               "transfer_ms_p50": snap["serve.disagg.transfer_ms"]["p50"],
               "transfer_ms_p95": snap["serve.disagg.transfer_ms"]["p95"],
               "prefill_ms_p50": snap["serve.disagg.prefill_ms"]["p50"],
               "fallbacks": snap["serve.disagg.prefill_fallbacks"],
               "decode_replica": {k: dec[k] for k in (
                   "serve.prefix.hits", "serve.prefills",
                   "serve.decode_steps", "serve.kv_pages_in_use")},
               "prefill_replica_decode_steps": pre["serve.decode_steps"],
               "recompiles": recompiles, "differing": differ,
               "warmup_launches": warm, "launches": launches}
    log(f"[disagg] {json.dumps(summary)}")
    if differ:
        raise AssertionError(f"disagg: tokens differ from colocated in "
                             f"requests {differ}")
    if transfers != len(requests) or dec["serve.prefills"] != 0:
        raise AssertionError(f"disagg: {transfers} transfers, "
                             f"{dec['serve.prefills']} local prefills on "
                             f"the decode replica")
    if dec["serve.kv_pages_in_use"] != 0 or recompiles:
        raise AssertionError(f"disagg: pages in use "
                             f"{dec['serve.kv_pages_in_use']}, recompiles "
                             f"{recompiles}")
    if launches != want:
        raise AssertionError(f"disagg: launch counts {launches} != {want}")
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


# -- the input pipeline and checkpoints (data/, ckpt/) -----------------------

# ckpt-resume: LM1B at its published widths fed by the native loader over a
# Zipf token file written from SEED; run A 10 steps with async saves every
# 5, its step-10 save skipped, run B resumes at 5 with sync saves
CKPT = dict(batch=128, num_steps=20, steps=10, every=5, tokens=1 << 20,
            space_factor=3)
# nan-rollback: NMT at its published widths, a NaN in w at step 4
NAN = dict(steps=8, nan_at=4, snapshot_every=2, max_retries=3)
# data-feed: batches made afresh each step, or made ahead (4, cycled), fed
# sequentially against prefetched; the first 4 of each run untimed
FEED = dict(warm=4, resnet_steps=8, ahead_steps=16, lm1b_steps=12, depth=2)
# nmt-data: a corpus written from SEED, sentence lengths 4-64, 4 buckets
NMT_DATA = dict(pairs=2048, min_len=4, max_len=64, bucket_width=16,
                batch=64)


def lstm_counts():
    from parallax_tpu_torch.ops import lstm
    return {"lstm_fwd": lstm.launches_fwd,
            "lstm_fwd_res": lstm.launches_fwd_res,
            "lstm_bwd": lstm.launches_bwd}


def zero_lstm_counts():
    from parallax_tpu_torch.ops import lstm
    for name in LSTM_COUNTERS:
        setattr(lstm, name, 0)


def flash_counts():
    from parallax_tpu_torch.ops import flash_attention as fa
    return {"flash_attention_fwd": fa.launches,
            "flash_attention_dq": fa.launches_dq,
            "flash_attention_dkv": fa.launches_dkv}


def zero_flash_counts():
    from parallax_tpu_torch.ops import flash_attention as fa
    for name in FLASH_COUNTERS:
        setattr(fa, name, 0)


def add_counts(total, more):
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def zipf_token_file(path, vocab, n):
    """``n`` tokens of ``lm1b.make_batch``'s Zipf law (the synthetic
    stream of examples/lm1b_driver.py) from SEED, in the native loader's
    format."""
    from parallax_tpu_torch.data import write_token_file
    rng = np.random.default_rng(SEED)
    write_token_file(path, (rng.zipf(1.3, n) - 1) % vocab)


def lm1b_ckpt_session(torch, **config_kw):
    """LM1BConfig() (slices, B2/B3 on the sm90 route) through
    parallel_run with ``Config(**config_kw)``."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import lm1b
    cfg = lm1b.LM1BConfig(num_partitions=TRAIN["num_partitions"],
                          sparse_grad_mode="slices", lstm_impl="kernel")
    sess, *_ = pt.parallel_run(
        lm1b.build_model(cfg), parallax_config=pt.Config(
            run_option="HYBRID", sparse_grad_mode="slices", **config_kw),
        seed=SEED, device=DEVICE)
    return cfg, sess


def time_saves(sess, skip=()):
    """Clock the session's checkpoint save on the dispatch thread (a sync
    save whole; an async save's join of the previous commit and the issue
    of its copies to the host): a list of (step, seconds). The saves of
    the steps in ``skip`` are not made."""
    hook = sess._ckpt
    save = hook._save
    out = []

    def timed(step, leaves, extras):
        if step in skip:
            return
        t0 = time.perf_counter()
        save(step, leaves, extras)
        out.append((step, time.perf_counter() - t0))

    hook._save = timed
    return out


def manifest_bytes(manifest):
    """The state's bytes reckoned from a manifest: every leaf's elements
    times its dtype's size."""
    import torch
    from parallax_tpu_torch.ckpt import snapshot
    return sum(math.prod(e["shape"]) * torch.empty(
        (), dtype=snapshot.torch_dtype(e["dtype"])).element_size()
        for e in manifest["leaves"].values())


def phase_ckpt_resume(torch, keep=None):
    """LM1B at its published widths fed by a native ``TokenDataset``:
    run A takes 10 steps with async saves every 5 steps, the step-5 save
    committed by the writer thread while steps 5-9 run and joined at
    ``close()``, the step-10 save skipped (nothing reads it); run B, a
    new session on the
    same directory, restores step 5 and data cursor 5, skips 5 batches of a
    new dataset (``run_iter(skip="auto")``) and runs steps 5-9 with a sync
    save at 10. B's losses must equal A's bit for bit. Prints the
    checkpoint's bytes, the seconds the dispatch thread spent in each save,
    the commit's join at ``close()``, the restore, step ms p50 with and
    without a commit in flight, and B2/B3's launches. ``keep``: a list
    the temporary directory is appended to instead of being removed (run
    B's checkpoint under ``ck`` is then the caller's: the drivers phase's
    ``lm1b_eval`` reads it).
    """
    import itertools
    import shutil
    import tempfile
    from parallax_tpu_torch.ckpt import CheckpointStore, snapshot
    from parallax_tpu_torch.data import TokenDataset
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="parallax-ckpt-resume-"))
    try:
        ck = str(root / "ck")
        tokens = str(root / "tokens.bin")
        cfg, a = lm1b_ckpt_session(torch, ckpt_config=_ckpt_config(
            ck, async_save=True, max_to_keep=2))
        zipf_token_file(tokens, cfg.vocab_size, CKPT["tokens"])
        ds = TokenDataset(tokens, CKPT["batch"], CKPT["num_steps"],
                          seed=SEED)
        if ds.backend != "native":
            raise AssertionError(f"TokenDataset backend {ds.backend!r}: "
                                 f"the native loader did not build")
        batches = [ds.next_batch() for _ in range(CKPT["steps"])]
        ds.close()
        a.prepare(batches[0])
        state_bytes = sum(math.prod(leaf.shape) * torch.empty(
            (), dtype=snapshot.torch_dtype(leaf.dtype)).element_size()
            for leaf in a._state_leaves())
        free = shutil.disk_usage(root).free
        log(f"[ckpt-resume] state {state_bytes} bytes, free {free} bytes "
            f"under {root}")
        if free < CKPT["space_factor"] * state_bytes:
            raise AssertionError(
                f"ckpt-resume needs {CKPT['space_factor']} x {state_bytes} "
                f"bytes free under {root}; {free} bytes are free")
        capture_a = capture_train(torch, a, CKPT["batch"])
        saves_a = time_saves(a, skip=(CKPT["steps"],))
        zero_lstm_counts()
        torch.cuda.synchronize()
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()
        la, in_flight = [], []
        for b in batches:
            la.append(a.run("loss", feed_dict=b))
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            w = a._ckpt._writer
            in_flight.append(w is not None and w.is_alive())
        torch.cuda.synchronize()
        la = [float(x) for x in la]
        step_ms = [x.elapsed_time(y) for x, y in zip(events, events[1:])]
        launches = lstm_counts()
        t0 = time.perf_counter()
        a.close()                                  # joins the commit
        close_s = time.perf_counter() - t0
        del a
        torch.cuda.empty_cache()
        store = CheckpointStore(ck)
        if store.complete_steps() != [CKPT["every"]]:
            raise AssertionError(f"checkpoints {store.complete_steps()} "
                                 f"after run A, want [{CKPT['every']}]")
        manifest = store.read_manifest(5)
        if manifest["extras"]["data_cursor"] != 5:
            raise AssertionError(f"extras {manifest['extras']}")
        ckpt_bytes = sum(p.stat().st_size
                         for p in (Path(ck) / "5").iterdir())
        reckoned = manifest_bytes(manifest)
        _, b = lm1b_ckpt_session(torch, ckpt_config=_ckpt_config(
            ck, async_save=False, max_to_keep=1))
        t0 = time.perf_counter()
        start = b.prepare(batches[0])
        prepare_s = time.perf_counter() - t0
        if start != 5 or b.data_cursor != 5:
            raise AssertionError(f"run B restored step {start}, cursor "
                                 f"{b.data_cursor}; want 5 and 5")
        restore_s = b._ckpt.last_restore_seconds
        capture_b = capture_train(torch, b, CKPT["batch"])
        saves_b = time_saves(b)
        zero_lstm_counts()
        ds = TokenDataset(tokens, CKPT["batch"], CKPT["num_steps"],
                          seed=SEED)
        lb = [float(x) for x in b.run_iter(
            itertools.islice(iter(ds), CKPT["steps"]), fetches="loss",
            skip="auto")]
        ds.close()
        add_counts(launches, lstm_counts())
        steps_b = b.state.step
        b.close()
        del b
        torch.cuda.empty_cache()
        if lb != la[CKPT["every"]:]:
            raise AssertionError(f"resumed losses {lb} != run A's steps "
                                 f"5-9 {la[CKPT['every']:]}")
        if steps_b != CKPT["steps"]:
            raise AssertionError(f"run B ended at step {steps_b}")
        steps_run = CKPT["steps"] + CKPT["steps"] - CKPT["every"]
        want = {"lstm_fwd": 0, "lstm_fwd_res": steps_run,
                "lstm_bwd": steps_run}
        if launches != want:
            raise AssertionError(f"ckpt-resume LSTM launches {launches} != "
                                 f"{want}")
        # a step "with a commit in flight" starts while the writer runs;
        # the save step itself (4) is reported apart
        save_at = CKPT["every"] - 1
        without = [step_ms[i] for i in range(save_at)]
        with_ = [step_ms[i] for i in range(save_at + 1, CKPT["steps"])
                 if in_flight[i - 1]]
        summary = {
            "config": {"batch": CKPT["batch"],
                       "num_steps": CKPT["num_steps"],
                       "vocab": cfg.vocab_size,
                       "padded_vocab": cfg.padded_vocab,
                       "tokens": CKPT["tokens"], "backend": "native"},
            "state_bytes": state_bytes, "manifest_bytes": reckoned,
            "checkpoint_bytes": ckpt_bytes, "free_bytes": free,
            "leaves": len(manifest["leaves"]),
            "async_save_block_s": {str(s): v for s, v in saves_a},
            "close_join_s": close_s,
            "sync_save_s": {str(s): v for s, v in saves_b},
            "restore_s": restore_s, "prepare_with_restore_s": prepare_s,
            "step_ms": step_ms, "commit_in_flight": in_flight,
            "step_ms_p50_no_commit": (statistics.median(without)
                                      if without else None),
            "step_ms_p50_commit_in_flight": (statistics.median(with_)
                                             if with_ else None),
            "step_ms_save_step": step_ms[save_at],
            "capture_s": [capture_a["capture_s"], capture_b["capture_s"]],
            "losses_a": la, "losses_b": lb, "resumed_bitwise_equal": True,
            "launches": launches}
        log(f"[ckpt-resume] {json.dumps({k: v for k, v in summary.items() if not k.startswith('losses')})}")
        return summary
    finally:
        if keep is None:
            shutil.rmtree(root, ignore_errors=True)
        else:
            keep.append(root)


def _ckpt_config(ck, **kw):
    import parallax_tpu_torch as pt
    return pt.CheckPointConfig(ckpt_dir=ck, save_ckpt_steps=CKPT["every"],
                               **kw)


def nmt_rollback_session(torch):
    """NMTConfig() as nmt-train runs it, with NaN recovery (a snapshot
    every 2 steps, 3 retries)."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import nmt
    cfg = nmt.NMTConfig(use_pallas_attention=True, num_partitions=1,
                        max_len=NMT_TRAIN["src_len"], warmup_steps=10)
    sess, *_ = pt.parallel_run(
        nmt.build_model(cfg), parallax_config=pt.Config(
            run_option="HYBRID", recovery_config=pt.RecoveryConfig(
                enabled=True, snapshot_every_steps=NAN["snapshot_every"],
                max_retries=NAN["max_retries"])),
        seed=SEED, device=DEVICE)
    return cfg, sess


def phase_nan_rollback(torch):
    """NMT at its published widths (B4-B6) with recovery, captured: 8
    clean batches with one more, whose ``w`` holds a NaN, fed at step 4.
    One rollback (to the snapshot of step 4), the hook called once, and
    the losses after it equal, bit for bit, a run fed the 8 clean batches
    alone. Then ``max_retries`` + 1 NaN batches in a row must raise
    ``RecoverySurrender`` after ``max_retries`` rollbacks."""
    from parallax_tpu_torch.ckpt import RecoverySurrender
    from parallax_tpu_torch.models import nmt
    torch.cuda.empty_cache()
    k = NAN["nan_at"]
    cfg, s = nmt_rollback_session(torch)
    rng = np.random.default_rng(SEED)
    clean = []
    for _ in range(NAN["steps"] + 1):
        b = nmt.make_batch(rng, NMT_TRAIN["batch"], NMT_TRAIN["src_len"],
                           NMT_TRAIN["tgt_len"], cfg.vocab_size)
        lengths = rng.integers(16, NMT_TRAIN["src_len"] + 1,
                               NMT_TRAIN["batch"])
        for i, n in enumerate(lengths):
            b["src"][i, n:] = nmt.PAD_ID
        # the model's default weights, explicit: the NaN batch's w keeps
        # the signature of the clean ones
        b["w"] = (b["tgt_out"] != nmt.PAD_ID).astype(np.float32)
        clean.append(b)
    extra = clean.pop()
    bad = dict(extra, w=extra["w"].copy())
    bad["w"][0, 0] = np.nan
    feed = clean[:k] + [bad] + clean[k:]
    s.prepare(clean[0])
    capture = capture_train(torch, s, NMT_TRAIN["batch"])
    calls = []
    s.set_rollback_hook(calls.append)
    zero_flash_counts()
    host_ms = []
    got = []
    for b in feed:
        t0 = time.perf_counter()
        got.append(float(s.run("loss", feed_dict=b)))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    if calls != [1] or s._recovery.total_rollbacks != 1:
        raise AssertionError(f"rollbacks {s._recovery.total_rollbacks}, "
                             f"hook calls {calls}; want one")
    if s.state.step != NAN["steps"] or s.data_cursor != NAN["steps"] + 1:
        raise AssertionError(f"step {s.state.step}, cursor "
                             f"{s.data_cursor} after the rollback")
    surrendered = False
    try:
        for _ in range(NAN["max_retries"] + 1):
            s.run("loss", feed_dict=bad)
    except RecoverySurrender:
        surrendered = True
    if not surrendered or s._recovery.total_rollbacks != \
            1 + NAN["max_retries"]:
        raise AssertionError(f"no RecoverySurrender after "
                             f"{s._recovery.total_rollbacks} rollbacks")
    snapshot_s = s.metrics.histogram("recovery.snapshot_seconds").snapshot()
    snapshot_bytes = s._recovery.stats()["snapshot_nbytes"]
    launches = flash_counts()
    s.close()
    del s
    torch.cuda.empty_cache()
    _, r = nmt_rollback_session(torch)
    r.prepare(clean[0])
    capture_train(torch, r, NMT_TRAIN["batch"])
    zero_flash_counts()
    want = [float(r.run("loss", feed_dict=b)) for b in clean]
    add_counts(launches, flash_counts())
    r.close()
    del r
    torch.cuda.empty_cache()
    if got[:k] + got[k + 1:] != want:
        raise AssertionError(f"losses after the rollback {got} differ from "
                             f"the run without the batch {want}")
    if math.isfinite(got[k]) or not all(map(math.isfinite, want)):
        raise AssertionError(f"losses {got} / {want}")
    steps_run = 2 * NAN["steps"] + 1 + NAN["max_retries"] + 1
    per_step = 3 * cfg.num_layers
    expect = dict.fromkeys(flash_counts(), per_step * steps_run)
    if launches != expect:
        raise AssertionError(f"nan-rollback flash launches {launches} != "
                             f"{expect}")
    summary = {"nan_at": k, "rollbacks": 1, "surrender_after":
               NAN["max_retries"], "losses": got, "reference": want,
               "rollback_step_host_ms": host_ms[k],
               "step_host_ms_p50": statistics.median(host_ms),
               "snapshot_seconds": snapshot_s,
               "snapshot_bytes": snapshot_bytes,
               "capture_s": capture["capture_s"], "launches": launches}
    log(f"[nan-rollback] {json.dumps({k_: v for k_, v in summary.items() if k_ not in ('losses', 'reference')})}")
    return summary


def resnet_stream(n):
    """``n`` ResNet batches made afresh, one at a time, from SEED, as an
    image pipeline hands them over: uint8 pixels scaled to [-1, 1] in
    float32, NHWC, and int32 labels."""
    rng = np.random.default_rng(SEED)
    shape = (RESNET["batch"], RESNET["image_size"], RESNET["image_size"], 3)
    for _ in range(n):
        pixels = rng.integers(0, 256, shape, dtype=np.uint8)
        labels = rng.integers(0, RESNET["classes"], (RESNET["batch"],),
                              dtype=np.int32)
        images = pixels.astype(np.float32)
        images *= 1.0 / 127.5
        images -= 1.0
        yield {"images": images, "labels": labels}


def feed_session(torch, kind, depth):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import cnn
    if kind == "lm1b":
        return lm1b_ckpt_session(torch, prefetch_depth=depth)[1]
    model = cnn.build_model(RESNET["name"], num_classes=RESNET["classes"],
                            image_size=RESNET["image_size"])
    sess, *_ = pt.parallel_run(
        model, parallax_config=pt.Config(run_option="AR",
                                         prefetch_depth=depth),
        seed=SEED, device=DEVICE)
    return sess


def feed_run(torch, kind, mode, stream, example, units_of):
    """One session fed ``stream``: ``mode`` "sequential" (``run`` a batch
    at a time, its making timed as its data wait), "prefetch"
    (``run_iter`` at depth 2) or "placed" (``prefetch_to_device`` of
    ``place_batch`` into ``run_iter(placed=True)``). The first
    ``FEED["warm"]`` items go through the same loop untimed, so the
    staging ring's slots (and the sequential loop's pinned blocks) are
    allocated before the clock starts. Units/s over the wall time of the
    rest, step ms p50 (CUDA events), data-wait ms p50, and the losses of
    every step."""
    import itertools
    from parallax_tpu_torch.data import prefetch_to_device
    torch.cuda.empty_cache()
    sess = feed_session(torch, kind, FEED["depth"])
    sess.prepare(example)
    batch = int(next(iter(example.values())).shape[0])
    capture_train(torch, sess, batch)
    zero_lstm_counts()
    zero_flash_counts()
    losses, units, waits, events = [], 0.0, [], []

    def counted(it):
        nonlocal units
        for b in it:
            units += units_of(b)
            yield b

    def drive(items):
        """Every item of ``items`` through ``mode``'s loop; an event
        recorded after each step."""
        if mode == "sequential":
            it = counted(items)
            while True:
                tw = time.perf_counter()
                b = next(it, None)
                if b is None:
                    return
                waits.append((time.perf_counter() - tw) * 1e3)
                losses.append(sess.run("loss", feed_dict=b))
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
        feed = None
        if mode == "placed":
            feed = prefetch_to_device(counted(items), sess.place_batch,
                                      depth=FEED["depth"])
            results = sess.run_iter(feed, fetches="loss", placed=True)
        else:
            results = sess.run_iter(counted(items), fetches="loss")
        for loss in results:
            losses.append(loss)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        if feed is not None:
            feed.close()

    stream = iter(stream)
    drive(itertools.islice(stream, FEED["warm"]))
    torch.cuda.synchronize()
    warm_steps = len(losses)
    sess.metrics.histogram("session.data_wait_ms")._window.clear()
    del waits[:], events[:]
    units = 0.0
    events.append(torch.cuda.Event(enable_timing=True))
    events[0].record()
    t0 = time.perf_counter()
    drive(stream)
    losses = [float(x) for x in losses]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed = len(losses) - warm_steps
    if mode != "sequential":
        waits = list(sess.metrics.histogram("session.data_wait_ms")._window)
    step_ms = [x.elapsed_time(y) for x, y in zip(events, events[1:])]
    launches = lstm_counts()
    ring = len(sess.engine._stage_slots)
    sess.close()
    del sess
    torch.cuda.empty_cache()
    return {"mode": mode, "units_per_sec": units / wall, "wall_s": wall,
            "warm_steps": warm_steps, "steps": timed,
            "step_ms_p50": statistics.median(step_ms),
            "wall_ms_per_step": wall * 1e3 / timed,
            "data_wait_ms_p50": statistics.median(waits),
            "ring_slots": ring, "losses": losses, "launches": launches}


def phase_data_feed(torch):
    """ResNet-50 (B 256, 224 px) fed batches made afresh each step: the
    sequential loop against ``run_iter`` at prefetch depth 2 (the staging
    ring); the same pair fed 4 batches made ahead, cycled (the feed costs
    only its conversion, pinning and copy to the card: the sequential
    loop pins each 154 MB batch anew and copies it on the step's stream);
    then LM1B fed by a native ``TokenDataset``: the sequential loop
    against ``prefetch_to_device(..., sess.place_batch)`` into
    ``run_iter(placed=True)``. Losses bitwise equal in each pair; images/s
    and words/s, step ms p50 and data-wait ms p50 for each run."""
    import shutil
    import tempfile
    from parallax_tpu_torch.data import TokenDataset
    out = {}
    example = next(resnet_stream(1))
    for mode in ("sequential", "prefetch"):
        out[f"resnet_{mode}"] = feed_run(
            torch, "resnet", mode,
            resnet_stream(FEED["warm"] + FEED["resnet_steps"]),
            example, lambda b: float(len(b["labels"])))
    made = list(resnet_stream(4))
    for mode in ("sequential", "prefetch"):
        out[f"resnet_ahead_{mode}"] = feed_run(
            torch, "resnet", mode,
            (made[i % 4]
             for i in range(FEED["warm"] + FEED["ahead_steps"])), example,
            lambda b: float(len(b["labels"])))
    del made
    root = Path(tempfile.mkdtemp(prefix="parallax-data-feed-"))
    try:
        from parallax_tpu_torch.models import lm1b
        tokens = str(root / "tokens.bin")
        zipf_token_file(tokens, lm1b.LM1BConfig().vocab_size, 1 << 20)
        launches = {}
        for mode in ("sequential", "placed"):
            ds = TokenDataset(tokens, CKPT["batch"], CKPT["num_steps"],
                              seed=SEED)
            if ds.backend != "native":
                raise AssertionError(f"TokenDataset backend {ds.backend!r}")
            example = ds.next_batch()
            stream = (ds.next_batch()
                      for _ in range(FEED["warm"] + FEED["lm1b_steps"]))
            r = feed_run(torch, "lm1b", mode, stream, example,
                         lambda b: float(b["w"].sum()))
            ds.close()
            add_counts(launches, r["launches"])
            out[f"lm1b_{mode}"] = r
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for kind, other in (("resnet", "prefetch"), ("resnet_ahead", "prefetch"),
                        ("lm1b", "placed")):
        a, b = out[f"{kind}_sequential"], out[f"{kind}_{other}"]
        if a["losses"] != b["losses"]:
            raise AssertionError(f"{kind}: {other} losses {b['losses']} != "
                                 f"sequential {a['losses']}")
        if not all(map(math.isfinite, a["losses"])):
            raise AssertionError(f"{kind}: non-finite loss {a['losses']}")
    steps = 2 * (FEED["warm"] + FEED["lm1b_steps"])
    want = {"lstm_fwd": 0, "lstm_fwd_res": steps, "lstm_bwd": steps}
    if launches != want:
        raise AssertionError(f"data-feed LSTM launches {launches} != {want}")
    summary = {k: {k2: v2 for k2, v2 in v.items() if k2 != "losses"}
               for k, v in out.items()}
    summary["launches"] = launches
    for kind in ("resnet", "resnet_ahead"):
        summary[f"{kind}_prefetch_over_sequential"] = (
            out[f"{kind}_prefetch"]["units_per_sec"]
            / out[f"{kind}_sequential"]["units_per_sec"])
    summary["lm1b_placed_over_sequential"] = (
        out["lm1b_placed"]["units_per_sec"]
        / out["lm1b_sequential"]["units_per_sec"])
    log(f"[data-feed] {json.dumps(summary)}")
    return summary


def nmt_corpus(root, vocab_size):
    """``NMT_DATA["pairs"]`` sentence pairs of random words, each side's
    length drawn in [4, 64], and a vocab of ``vocab_size`` entries (the 4
    specials first), from SEED."""
    rng = np.random.default_rng(SEED)
    words = [f"w{i}" for i in range(vocab_size - 4)]
    (root / "vocab.txt").write_text(
        "\n".join(["<pad>", "<s>", "</s>", "<unk>"] + words) + "\n")
    lines = {"src": [], "tgt": []}
    for _ in range(NMT_DATA["pairs"]):
        for side in lines:
            n = int(rng.integers(NMT_DATA["min_len"],
                                 NMT_DATA["max_len"] + 1))
            lines[side].append(" ".join(
                words[i] for i in rng.integers(0, len(words), n)))
    for side, text in lines.items():
        (root / f"train.{side}").write_text("\n".join(text) + "\n")


def phase_nmt_data(torch):
    """NMT at its published widths fed by ``NMTBatchIterator`` (batch 64,
    buckets of 16 up to 64, ragged tails padded with zero-weight rows)
    over a corpus written from SEED, with ``shape_buckets=[64]`` declared
    and ``warmup()``. The declared buckets size the batch dimension only,
    so each length bucket is a signature of its own: one untimed step a
    bucket captures its graph, counted in ``engine.recompiles`` after the
    first, as the JAX package counts it. Then the epoch, timed: no
    capture and no recompile inside it, one graph a bucket, B4-B6
    launched in each bucket, losses finite."""
    import shutil
    import tempfile
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.data import nmt_data
    from parallax_tpu_torch.models import nmt
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="parallax-nmt-data-"))
    try:
        cfg = nmt.NMTConfig(use_pallas_attention=True, num_partitions=1,
                            max_len=NMT_DATA["max_len"], warmup_steps=10)
        nmt_corpus(root, cfg.vocab_size)
        vocab = nmt_data.Vocab.load(str(root / "vocab.txt"))
        pairs = nmt_data.load_parallel_corpus(
            str(root / "train.src"), str(root / "train.tgt"), vocab,
            cfg.max_len)
        it = nmt_data.NMTBatchIterator(
            pairs, batch_size=NMT_DATA["batch"], max_len=cfg.max_len,
            bucket_width=NMT_DATA["bucket_width"], seed=SEED,
            drop_remainder=False)
        batches = list(it.epoch(0))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    first = {}
    for b in batches:
        first.setdefault(b["src"].shape[1], b)
    sess, *_ = pt.parallel_run(
        nmt.build_model(cfg), parallax_config=pt.Config(
            run_option="HYBRID", shape_buckets=[NMT_DATA["batch"]]),
        seed=SEED, device=DEVICE)
    sess.prepare(batches[0])
    t0 = time.perf_counter()
    sess.warmup()
    for n in sorted(first):
        float(sess.run("loss", feed_dict=first[n]))
    warmup_s = time.perf_counter() - t0
    recompiles_warm = sess.metrics.counter("engine.recompiles").value
    captures = sess.metrics.histogram("engine.capture_seconds")
    captures_warm = captures.count
    zero_flash_counts()
    per_bucket = {n: dict.fromkeys(flash_counts(), 0) for n in first}
    losses, words = [], 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        before = flash_counts()
        losses.append(sess.run("loss", feed_dict=b))
        words += float(b["w"].sum())
        after = flash_counts()
        for name in after:
            per_bucket[b["src"].shape[1]][name] += after[name] - before[name]
    losses = [float(x) for x in losses]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recompiles = sess.metrics.counter("engine.recompiles").value
    captures_loop = captures.count - captures_warm
    launches = flash_counts()
    graphs_ = sum(g is not None for g in sess.engine._executables.values())
    sess.close()
    del sess
    torch.cuda.empty_cache()
    if recompiles_warm != len(first) - 1 or recompiles != recompiles_warm:
        raise AssertionError(f"engine.recompiles {recompiles_warm} after "
                             f"one step a bucket, {recompiles} after the "
                             f"epoch; want {len(first) - 1} both")
    if graphs_ != len(first) or captures_loop != 0:
        raise AssertionError(f"{graphs_} graphs for {len(first)} buckets, "
                             f"{captures_loop} captures in the timed loop")
    if sorted(first) != list(range(NMT_DATA["bucket_width"],
                                   NMT_DATA["max_len"] + 1,
                                   NMT_DATA["bucket_width"])):
        raise AssertionError(f"length buckets {sorted(first)}")
    idle = [n for n, c in per_bucket.items() if min(c.values()) <= 0]
    if idle:
        raise AssertionError(f"B4-B6 not launched in buckets {idle}: "
                             f"{per_bucket}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite NMT loss {losses}")
    summary = {"pairs": len(pairs), "batches": len(batches),
               "buckets": {str(n): sum(b["src"].shape[1] == n
                                       for b in batches) for n in first},
               "graphs": graphs_, "warmup_s": warmup_s,
               "captures_in_loop": captures_loop,
               "recompiles": recompiles,
               "target_words_per_sec": words / wall, "wall_s": wall,
               "first_loss": losses[0], "last_loss": losses[-1],
               "per_bucket_launches": {str(n): c
                                       for n, c in per_bucket.items()},
               "launches": launches}
    log(f"[nmt-data] {json.dumps(summary)}")
    return summary


# -- skip-thoughts, the LM1B full-softmax baseline, the pipeline ------------

# SkipThoughtsConfig() at its published widths (Kiros et al. 2015,
# uni-skip: vocab 20000, E 620, GRU hidden 2400, bf16) through parallel_run
# HYBRID, batch 64 of 30-token sentences (examples/skip_thoughts_driver.py's
# defaults): 3 eager steps of one session held bitwise to 3 captured steps
# of another, then 10 timed steps
SKIP_TRAIN = dict(batch=64, seq=30, steps=10, agree_steps=3, profile_steps=3)
SKIP_GROUPS = (
    ("fp32 output head products ([1920, 2400] x [2400, 20000], two "
     "decoders)", r"(?i)sgemm|nvjet_s|f32f32_f32f32|gemm_f32"),
    ("bf16 GEMMs (GRU gates and recurrences)",
     r"(?i)gemm|nvjet|xmma|cutlass|cublas"),
    ("Adam and the clip (multi-tensor)", r"(?i)multi_tensor|foreach"),
    ("log-softmax", r"(?i)softmax"),
    ("reductions", r"(?i)reduce"),
    ("elementwise (GRU gates)", r"(?i)elementwise|vectorized|unrolled"),
    ("copies, fills, gathers and scatters",
     r"(?i)copy|memcpy|memset|fill|cat|gather|index|scatter"),
)
# build_full_softmax_model(LM1BConfig(lstm_impl="kernel")) at LM1B's
# published widths (V 793470, E 512, H 2048, P 512), batch 128 x 20 as
# `train`: the fp32 logits are 2560 x 793470 x 4 B = 8.1 GB
LM1B_FULL = dict(warmup=2, steps=5, profile_steps=2)
LM1B_FULL_GROUPS = (
    ("full-softmax logits products (fp32 of bf16 operands, [2560, 512] x "
     "[512, 793470])", r"(?i)sgemm|nvjet_s|f32f32_f32f32|gemm_f32"),
    ("LSTM B2/B3", r"lstm_"),
    ("bf16 GEMMs", r"(?i)gemm|nvjet|xmma|cutlass|cublas"),
    ("logsumexp and softmax", r"(?i)softmax|logsumexp"),
    ("Adagrad and the clip (multi-tensor)", r"(?i)multi_tensor|foreach"),
    ("reductions", r"(?i)reduce"),
    ("elementwise", r"(?i)elementwise|vectorized|unrolled"),
    ("copies, fills and gathers", r"(?i)copy|memcpy|memset|fill|cat|gather|"
                                  r"index"),
)
# lc-pipe: (a) LongContextConfig(parallelism='pipeline',
# use_pallas_attention=True), GPipe and 1F1B, at lc-train's shape on one
# card (a ring of one stage: the rows in layer order), 3 captured steps each
# against lc-train's first 3 losses; (b) the pipeline functions themselves
# on a one-rank mesh (S 1, M 4) over the LC stage (the 6 blocks) at
# B 8 x T 8192, each schedule one captured step against the sequential
# application of the stage to the whole batch
LC_PIPE = dict(steps=3, micro=4, loss_tol=2e-3, grad_tol=2e-2)


def skip_model_flops(cfg, batch, seq):
    """Model FLOPs of one skip-thoughts step (forward x 3): the three GRUs'
    x- and h-side gate products and the decoders' h0 projections in bf16,
    the two decoders' output heads in fp32."""
    E, H, V = cfg.emb_dim, cfg.hidden_dim, cfg.padded_vocab
    tokens = batch * seq
    gru = 2 * tokens * E * 3 * H + 2 * tokens * H * 3 * H
    bf16 = 3 * (3 * gru + 2 * 2 * batch * H * H)
    return {"bf16_tflop": bf16 / 1e12,
            "fp32_tflop": 3 * 2 * 2 * tokens * H * V / 1e12}


def phase_skip_thoughts_train(torch, card):
    """Skip-thoughts through parallel_run HYBRID on one card, bf16:
    ``agree_steps`` eager steps of a fresh session against the same
    steps as replays of another session's captured step (losses and
    every state tensor bitwise equal); then ``steps`` timed steps
    (sentences a second, step ms p50 and p95 from CUDA events, peak
    memory, the model FLOPs' share of 989 TF/s), every loss finite and
    ``words`` 2 B T; ``emb`` alone classified sparse; then
    ``profile_groups`` by ``SKIP_GROUPS``."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.compile import graphs as graphs_lib
    from parallax_tpu_torch.core.engine import state_tensors
    from parallax_tpu_torch.models import skip_thoughts as st
    torch.cuda.empty_cache()
    cfg = st.SkipThoughtsConfig()
    B, T = SKIP_TRAIN["batch"], SKIP_TRAIN["seq"]
    steps, agree = SKIP_TRAIN["steps"], SKIP_TRAIN["agree_steps"]
    rng = np.random.default_rng(SEED)
    batches = [st.make_batch(rng, B, T, cfg.vocab_size) for _ in range(4)]

    def session():
        sess, *_ = pt.parallel_run(
            st.build_model(cfg), seed=SEED, device=DEVICE,
            parallax_config=pt.Config(run_option="HYBRID"))
        sess.prepare(batches[0])
        return sess

    eager = session()
    with graphs_lib.disable_capture():
        eager_losses = [float(eager.run("loss", feed_dict=batches[i]))
                        for i in range(agree)]
    eager_state = [t.detach().clone() for t in state_tensors(eager.state)]
    eager.close()
    del eager
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sess = session()
    sparse = sorted(p for p, v in sess.engine.plan.var_specs.items()
                    if v.is_sparse)
    if sparse != ["emb"]:
        raise AssertionError(f"skip-thoughts sparse variables {sparse}, "
                             f"want ['emb'] as in JAX")
    capture = capture_train(torch, sess, B)
    graph_losses = [float(sess.run("loss", feed_dict=batches[i]))
                    for i in range(agree)]
    same_state = all(torch.equal(a, b) for a, b in
                     zip(eager_state, state_tensors(sess.state)))
    del eager_state
    if graph_losses != eager_losses or not same_state:
        raise AssertionError(f"captured skip-thoughts steps {graph_losses} "
                             f"!= eager {eager_losses} (state bitwise "
                             f"equal: {same_state})")
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    t0 = time.perf_counter()
    outs = []
    feed = (batches[i % 4] for i in range(steps))
    for out in sess.run_iter(feed, fetches=["loss", "words"]):
        outs.append(out)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(o[0]) for o in outs]
    words = [float(o[1]) for o in outs]
    if not all(math.isfinite(x) for x in losses + graph_losses):
        raise AssertionError(f"non-finite skip-thoughts loss: {losses}")
    if words != [2.0 * B * T] * steps:
        raise AssertionError(f"skip-thoughts words {words} != {2 * B * T}")
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    p50 = statistics.median(step_ms)
    flops = skip_model_flops(cfg, B, T)
    step_flop = (flops["bf16_tflop"] + flops["fp32_tflop"]) * 1e12
    summary = {
        "card": card,
        "config": {"vocab": cfg.vocab_size, "emb": cfg.emb_dim,
                   "hidden": cfg.hidden_dim, "compute": "bfloat16",
                   "run_option": "HYBRID", "batch": B, "seq": T},
        "sentences_per_sec": steps * B / wall, "timed_steps": steps,
        "wall_s": wall, "step_ms_p50": p50, "step_ms_p95": p95(step_ms),
        "losses": graph_losses + losses, "eager_losses": eager_losses,
        "captured_equals_eager": True,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "model_flops": flops,
        "share_of_bf16_peak": steps / wall * step_flop
        / PEAK_OPS_PER_S["bfloat16"],
        "share_of_bf16_peak_at_p50": step_flop / (p50 * 1e-3)
        / PEAK_OPS_PER_S["bfloat16"],
        "capture": capture}
    summary["profile"] = prof = profile_groups(
        torch, sess, batches, SKIP_TRAIN["profile_steps"], SKIP_GROUPS,
        flash=())
    summary["timed_idle_share"] = 1.0 - prof["device_busy_ms_per_step"] \
        / (wall * 1e3 / steps)
    log(f"[skip-thoughts-train] {json.dumps(summary)}")
    sess.close()
    torch.cuda.empty_cache()
    return summary


def phase_lm1b_full(torch, card, train):
    """The LM1B full-softmax baseline through parallel_run HYBRID on one
    card (dense Adagrad after the clip, the LSTM on the sm90 kernels):
    ``sess.warmup`` captures the step, then ``warmup`` and ``steps``
    timed steps (words a second, step ms p50 and p95, peak memory); B2
    and B3 once a step, B1 none; every loss finite; ``emb`` sparse and
    the softmax tables dense; then ``profile_groups`` by
    ``LM1B_FULL_GROUPS`` (the head's share of busy), and the ratio of
    ``train``'s sampled-softmax words a second to this phase's at the
    same batch (the JAX bench's ``vs_baseline``)."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import lm1b
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = lm1b.LM1BConfig(lstm_impl="kernel")
    sess, *_ = pt.parallel_run(
        lm1b.build_full_softmax_model(cfg), seed=SEED, device=DEVICE,
        parallax_config=pt.Config(run_option="HYBRID"))
    batches = lm1b_batches(cfg)
    sess.prepare(batches[0])
    sparse = sorted(p for p, v in sess.engine.plan.var_specs.items()
                    if v.is_sparse)
    if sparse != ["emb"]:
        raise AssertionError(f"full-softmax sparse variables {sparse}, "
                             f"want ['emb'] (the softmax used densely)")
    capture = capture_train(torch, sess, TRAIN["batch"])
    zero_lstm_counts()
    losses = [float(x) for x in sess.run_iter(
        (batches[i % 4] for i in range(LM1B_FULL["warmup"])),
        fetches="loss")]
    stats = timed_steps(torch, sess, batches, LM1B_FULL["steps"],
                        lambda b: float(b["w"].sum()))
    losses.append(float(sess.run("loss", feed_dict=batches[0])))
    torch.cuda.synchronize()
    launches = lstm_counts()
    n = LM1B_FULL["warmup"] + LM1B_FULL["steps"] + 1
    want = {"lstm_fwd": 0, "lstm_fwd_res": n, "lstm_bwd": n}
    if launches != want:
        raise AssertionError(f"lm1b-full LSTM launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite lm1b-full loss: {losses}")
    summary = {
        "card": card,
        "config": {"vocab": cfg.vocab_size, "padded_vocab": cfg.padded_vocab,
                   "emb": cfg.emb_dim, "hidden": cfg.hidden_dim,
                   "proj": cfg.proj_dim, "keep_prob": cfg.keep_prob,
                   "compute": "bfloat16", "run_option": "HYBRID",
                   "batch": TRAIN["batch"], "num_steps": TRAIN["num_steps"]},
        "words_per_sec": stats["per_sec"],
        "step_ms_p50": stats["step_ms_p50"],
        "step_ms_p95": stats["step_ms_p95"], "timed_steps":
            LM1B_FULL["steps"], "losses": losses,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "launches_per_step": {
            k: v / n for k, v in launches.items()},
        "capture": capture,
        "sampled_over_full_words_per_sec":
            train["lm1b_words_per_sec_per_chip"] / stats["per_sec"]}
    summary["profile"] = prof = profile_groups(
        torch, sess, batches, LM1B_FULL["profile_steps"], LM1B_FULL_GROUPS,
        flash=(), lstm=("lstm_fwd_kernel_sm90", "lstm_bwd_kernel_sm90"))
    summary["head_share_of_busy"] = prof["busy_share_by_group"][
        LM1B_FULL_GROUPS[0][0]]
    log(f"[lm1b-full] {json.dumps(summary)}")
    sess.close()
    torch.cuda.empty_cache()
    return summary


def phase_lc_pipe(torch, card, lc_train):
    """(a) The long-context LM in pipeline mode, GPipe and 1F1B, through
    parallel_run on one card at lc-train's shape: ``sess.warmup``
    captures the step, then ``steps`` steps (tokens a second, p50, peak
    memory); B4, B5 and B6 6 times a step each; the losses within
    ``loss_tol`` relative of lc-train's on the same batches from the same
    weights. (b) ``ops.pipeline.pipeline_apply`` (with autograd) and
    ``pipeline_value_and_grad`` on a one-rank mesh, M 4, over the LC
    stage at B 8 x T 8192, each captured as one graph and replayed once:
    the loss within ``loss_tol`` and every gradient (the stage rows, the
    input, the head) within ``grad_tol`` of its peak of the sequential
    application's; the peak memory of the capture's eager call; B4, B5
    and B6 launches as the schedule implies (GPipe 4 x 6 each; 1F1B
    recomputes each forward in its backward tick: B4 8 x 6)."""
    from parallax_tpu_torch.compile import graphs as graphs_lib
    from parallax_tpu_torch.core import mesh as mesh_lib
    from parallax_tpu_torch.models import long_context as lc
    from parallax_tpu_torch.ops import pipeline as pp
    B, T, steps = LC_TRAIN["batch"], LC_TRAIN["seq"], LC_PIPE["steps"]
    summary = {"card": card, "sessions": {}, "ops": {}}
    launches_total = {}
    for sched in ("gpipe", "1f1b"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, sess = lc_session(torch, parallelism="pipeline",
                               pipeline_schedule=sched,
                               use_pallas_attention=True)
        batches = lc_batches(cfg, B, T)
        sess.prepare(batches[0])
        if sess.engine.batch_layout != "repl":
            raise AssertionError(f"lc-pipe batch layout "
                                 f"{sess.engine.batch_layout}")
        capture = capture_train(torch, sess, B)
        zero_flash_counts()
        torch.cuda.synchronize()
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()
        t0 = time.perf_counter()
        losses = []
        for loss in sess.run_iter(iter(batches[:steps]), fetches="loss"):
            losses.append(loss)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_counts()
        add_counts(launches_total, launches)
        if set(launches.values()) != {steps * cfg.num_layers}:
            raise AssertionError(f"lc-pipe {sched} flash launches "
                                 f"{launches}: want {cfg.num_layers} of "
                                 f"each a step")
        losses = [float(x) for x in losses]
        want = [float(x) for x in lc_train["losses"][:steps]]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
        if not (all(math.isfinite(x) for x in losses)
                and max(rel) <= LC_PIPE["loss_tol"]):
            raise AssertionError(f"lc-pipe {sched} losses {losses} vs "
                                 f"lc-train's {want}: {max(rel)} > "
                                 f"{LC_PIPE['loss_tol']}")
        step_ms = sorted(a.elapsed_time(b)
                         for a, b in zip(events, events[1:]))
        summary["sessions"][sched] = {
            "losses": losses, "lc_train_losses": want,
            "max_rel_diff": max(rel), "tol": LC_PIPE["loss_tol"],
            "tokens_per_sec": steps * B * T / wall,
            "step_ms_p50": statistics.median(step_ms),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "capture": capture}
        sess.close()
        del sess
    # (b) the schedules themselves
    torch.cuda.empty_cache()
    M = LC_PIPE["micro"]
    cfg = lc.LongContextConfig(parallelism="pipeline",
                               use_pallas_attention=True)
    L = cfg.num_layers
    params = lc.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    stages = lc._tree_map(lambda t: t[None].detach().requires_grad_(True),
                          params["blocks_stacked"])
    leaves = pp._leaves(stages)
    head_w = params["out_w"].detach().requires_grad_(True)
    head = {"out_w": head_w}
    ids = torch.as_tensor(lc_batches(cfg, B, T, 1)[0]["ids"],
                          device=DEVICE).long()
    with torch.no_grad():
        x0 = params["emb"][ids].to(cfg.compute_dtype) \
            + params["pos"][:T].to(cfg.compute_dtype)[None]
    x = x0.detach().requires_grad_(True)
    y = {"labels": torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], 1),
         "w": torch.ones((B, T), device=DEVICE)}
    y["w"][:, -1] = 0.0
    stage_fn = lc.make_stage_fn(cfg, L)
    mesh = mesh_lib.Mesh(torch.device(DEVICE))

    def mb_loss(h, out, yy):
        logits = out.float() @ h["out_w"]
        nll = -torch.log_softmax(logits.reshape(-1, logits.shape[-1]),
                                 dim=-1).gather(
            1, yy["labels"].reshape(-1, 1))[:, 0]
        wf = yy["w"].reshape(-1)
        return (nll * wf).sum() / wf.sum()

    wrt = leaves + [x, head_w]
    with torch.enable_grad():
        ref_loss = mb_loss(head, stage_fn(lc._tree_map(lambda t: t[0],
                                                       stages), x), y)
        ref = [g.detach() for g in torch.autograd.grad(ref_loss, wrt)]
    ref_loss = float(ref_loss.detach())

    def gpipe():
        with torch.enable_grad():
            out = pp.pipeline_apply(stage_fn, stages, x, mesh, M)
            loss = mb_loss(head, out, y)
            grads = torch.autograd.grad(loss, wrt)
        return {"loss": loss.detach(), "grads": list(grads)}

    def one_f_one_b():
        loss, (gs, gh, gx) = pp.pipeline_value_and_grad(
            stage_fn, mb_loss, stages, x, y, mesh, M, head_params=head)
        return {"loss": loss, "grads": pp._leaves(gs) + [gx, gh["out_w"]]}

    for name, body, fwd in (("gpipe", gpipe, M * L),
                            ("1f1b", one_f_one_b, 2 * M * L)):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        graph = graphs_lib.capture(body, DEVICE)
        capture_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        zero_flash_counts()
        outs = graph.replay()
        torch.cuda.synchronize()
        launches = flash_counts()
        add_counts(launches_total, launches)
        want = {"flash_attention_fwd": fwd, "flash_attention_dq": M * L,
                "flash_attention_dkv": M * L}
        if launches != want:
            raise AssertionError(f"lc-pipe {name} launches {launches} != "
                                 f"{want}")
        loss = float(outs["loss"])
        errs = []
        for g, r in zip(outs["grads"], ref):
            errs.append((g.float() - r.float()).abs().max().item()
                        / max(r.float().abs().max().item(), 1e-30))
        rel = abs(loss - ref_loss) / abs(ref_loss)
        summary["ops"][name] = {
            "loss": loss, "sequential_loss": ref_loss, "loss_rel_diff": rel,
            "max_grad_err_of_peak": max(errs),
            "grad_err_of_peak": {"stage_rows": max(errs[:-2]),
                                 "x": errs[-2], "head": errs[-1]},
            "peak_memory_gb": peak / 1e9, "capture_s": capture_s,
            "pool_bytes": pool_bytes(torch, [graph.graph]),
            "launches": launches}
        del graph, outs
        if not (rel <= LC_PIPE["loss_tol"]
                and max(errs) <= LC_PIPE["grad_tol"]):
            raise AssertionError(f"lc-pipe {name} against the sequential "
                                 f"stage: {summary['ops'][name]}")
    summary["launches"] = launches_total
    log(f"[lc-pipe] {json.dumps(summary)}")
    del params, stages, leaves, ref, x, x0
    torch.cuda.empty_cache()
    return summary


# -- the run ----------------------------------------------------------------


# the kernel-phase cases at the shapes the main paths launch each kernel
# at ("lc_serve" is moe-serve's decode step too)
# -- serve-mesh, warmup-bg, drivers: the last entry points ------------------

WARMUP_BG = dict(buckets=(64, 128), steps=12)
DRIVERS = dict(lm1b_steps=10, lm1b_log=5, lm1b_eval_batches=4, nmt_steps=6,
               nmt_log=3, nmt_eval_batches=2)


def one_rank_nccl(torch):
    """Rank 0 of a one-rank NCCL process group on chip 0 (its rendezvous
    a file under a new directory, returned)."""
    import tempfile
    rdv = Path(tempfile.mkdtemp(prefix="parallax_rdv_"))
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{rdv / 'store'}", rank=0, world_size=1)
    return rdv


def phase_serve_mesh(torch, cfg, params, requests, served, serve_summary,
                     oneshot_outs, oneshot):
    """``ServeSession`` over the mesh of a one-rank NCCL process group,
    the parameters placed by the engine's plan (``model=``): the serve
    phase's NMT decode program on its 256 requests, then the oneshot
    phase's translator on the same sources. Tokens and outputs bitwise
    those phases'; B4 and B7 as they count them; ``serve.recompiles``
    0."""
    import shutil
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.core import mesh as mesh_lib
    from parallax_tpu_torch.models import nmt
    from parallax_tpu_torch.ops import paged_attention as pa
    dist = torch.distributed
    rdv = one_rank_nccl(torch)
    try:
        mesh = mesh_lib.build_mesh(DEVICE)
        if not (dist.get_backend() == "nccl" and mesh.distributed
                and mesh.size == 1):
            raise AssertionError("serve-mesh: no one-rank NCCL mesh")
        model = nmt.build_model(cfg)
        L = cfg.num_layers
        torch.cuda.synchronize()
        zero_launches()
        prog = pt.NMTDecodeProgram(
            cfg, max_src_len=SERVE["max_src_len"], max_len=SERVE["max_len"],
            page_size=SERVE["page_size"], pool_pages=SERVE["pool_pages"],
            attn_impl="kernel", device=DEVICE)
        sess = pt.ServeSession(
            program=prog, params=params, model=model, mesh=mesh,
            config=pt.Config(serve_config=pt.ServeConfig(
                max_batch=SERVE["max_batch"], max_queue=SERVE["max_queue"])))
        placement = sess._plan.placements["emb"]
        t0 = time.perf_counter()
        try:
            reqs = [sess.submit({"src": src}, max_new_tokens=cap)
                    for src, cap in requests]
            outs = [r.result(timeout=900) for r in reqs]
            wall = time.perf_counter() - t0
        finally:
            sess.close()
        torch.cuda.synchronize()
        stats = sess.stats()
        launches = launch_counts()
        check_outputs(requests, outs, cfg.vocab_size)
        differ = [i for i, (a, b) in enumerate(zip(outs, served))
                  if not np.array_equal(a, b)]
        if differ:
            raise AssertionError(f"serve-mesh: tokens of requests "
                                 f"{differ[:8]} differ from the serve "
                                 f"phase's")
        want = {"flash_attention_fwd": (stats["serve.prefills"] + 2) * L,
                "paged_decode_attention":
                    (stats["serve.decode_steps"] + 1) * L}
        want_combine = want["paged_decode_attention"] * int(
            serve_summary["paged_plan"]["nsplit"] > 1)
        if launches != want or pa.launches_combine != want_combine:
            raise AssertionError(f"serve-mesh decode launches {launches}, "
                                 f"combine {pa.launches_combine} != {want}, "
                                 f"{want_combine}")
        if stats["serve.recompiles"] != 0 \
                or stats["serve.kv_pages_in_use"] != 0:
            raise AssertionError(f"serve-mesh decode: recompiles "
                                 f"{stats['serve.recompiles']}, pages in "
                                 f"use {stats['serve.kv_pages_in_use']}")
        tokens = int(sum(len(o) for o in outs))
        decode = {"requests": len(requests), "tokens": tokens,
                  "wall_s": wall, "tokens_per_sec": tokens / wall,
                  "serve_tokens_per_sec": serve_summary["tokens_per_sec"],
                  "step_ms_p50": stats["serve.step_ms"]["p50"],
                  "emb_placement": placement, "launches": launches,
                  "tokens_bitwise_serve": True}
        log(f"[serve-mesh] decode {json.dumps(decode)}")
        # the one-shot translator, its plan classified on a training batch
        zero_launches()
        feed = nmt.make_batch(np.random.default_rng(SEED),
                              ONESHOT["max_batch"],
                              max(ONESHOT["length_buckets"]),
                              max(ONESHOT["length_buckets"]), cfg.vocab_size)
        sess = oneshot_session(torch, cfg, params, session_kw=dict(
            model=model, mesh=mesh, plan_feed=feed))
        warm = launch_counts()
        try:
            t0 = time.perf_counter()
            reqs = [sess.submit({"src": src}) for src, _ in requests]
            outs = [r.result(timeout=900)["tokens"] for r in reqs]
            wall = time.perf_counter() - t0
        finally:
            sess.close()
        torch.cuda.synchronize()
        stats = sess.stats()
        launches = launch_counts()
        differ = [i for i, (a, b) in enumerate(zip(outs, oneshot_outs))
                  if not np.array_equal(a, b)]
        if differ:
            raise AssertionError(f"serve-mesh: one-shot outputs of "
                                 f"requests {differ[:8]} differ from the "
                                 f"oneshot phase's")
        sigs = len(ONESHOT["length_buckets"]) * len(ONESHOT["batch_buckets"])
        want = {"flash_attention_fwd": (stats["serve.batches"] + sigs) * L,
                "paged_decode_attention": 0}
        if launches != want or stats["serve.recompiles"] != 0 \
                or stats["serve.graph_captures"] != sigs:
            raise AssertionError(
                f"serve-mesh one-shot: launches {launches} != {want}, "
                f"recompiles {stats['serve.recompiles']}, graphs "
                f"{stats['serve.graph_captures']} (want {sigs})")
        one = {"requests": len(requests), "wall_s": wall,
               "requests_per_sec": len(requests) / wall,
               "oneshot_requests_per_sec": oneshot["requests_per_sec"],
               "batches": stats["serve.batches"],
               "warmup_launches": warm, "launches": launches,
               "outputs_bitwise_oneshot": True}
        log(f"[serve-mesh] oneshot {json.dumps(one)}")
        total = {k: decode["launches"][k] + launches[k] for k in launches}
        return {"world": mesh.size, "backend": dist.get_backend(),
                "decode": decode, "oneshot": one, "launches": total}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)


def warmup_bg_batches(cfg):
    """``WARMUP_BG["steps"]`` batches of the train phase's, every third
    cut to 64 rows (the smaller bucket)."""
    base = lm1b_batches(cfg)
    out = []
    for i in range(WARMUP_BG["steps"]):
        b = base[i % 4]
        out.append({k: v[:64] for k, v in b.items()} if i % 3 == 1 else b)
    return out


def phase_warmup_bg(torch):
    """``train``'s LM1B with ``shape_buckets=(64, 128)``: a session warmed
    in the foreground, then one whose steps are dispatched right after
    ``warmup(background=True)`` returns, on the same batches. Losses
    bitwise equal; each bucket captured once a session; the thread
    raised nothing; B2/B3 once a step plus once a capture."""
    from parallax_tpu_torch.ops import lstm
    runs = {}
    for background in (False, True):
        cfg, sess = lm1b_session(torch, config_kw={
            "shape_buckets": list(WARMUP_BG["buckets"])})
        batches = warmup_bg_batches(cfg)
        sess.prepare(batches[0])
        torch.cuda.synchronize()
        zero_lstm_counts()
        t0 = time.perf_counter()
        thread = sess.warmup(background=background)
        losses, overlapped = [], 0
        for b in batches:
            losses.append(sess.run("loss", feed_dict=b))
            if background and thread.is_alive():
                overlapped += 1
        if background:
            thread.join()
            if thread.error is not None:
                raise AssertionError(f"warmup-bg: the background warmup "
                                     f"raised {thread.error!r}")
        losses = [float(x) for x in losses]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng = sess.engine
        captures = sess.metrics_snapshot()["engine.capture_seconds"]["count"]
        graphs = [g for g in eng._executables.values() if g is not None]
        launches = lstm_counts()
        n = WARMUP_BG["steps"]
        want = {"lstm_fwd": 0, "lstm_fwd_res": n + 2, "lstm_bwd": n + 2}
        run = {"losses": losses, "captures": captures,
               "graphs": len(graphs), "warmup_seconds":
                   {str(k): v for k, v in eng.warmup_seconds.items()},
               "recompiles": sess.metrics.counter(
                   "engine.recompiles").value,
               "steps_before_warmup_done": overlapped, "wall_s": wall,
               "launches": launches}
        log(f"[warmup-bg] {'background' if background else 'foreground'} "
            f"{json.dumps({k: v for k, v in run.items() if k != 'losses'})}")
        if captures != 2 or len(graphs) != 2 or run["recompiles"] != 0:
            raise AssertionError(f"warmup-bg: {captures} captures, "
                                 f"{len(graphs)} graphs, {run['recompiles']} "
                                 f"recompiles (want 2, 2, 0)")
        if launches != want:
            raise AssertionError(f"warmup-bg LSTM launches {launches} != "
                                 f"{want}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"warmup-bg: non-finite loss {losses}")
        runs["background" if background else "foreground"] = run
        sess.close()
        del sess
        torch.cuda.empty_cache()
    fg, bg = runs["foreground"]["losses"], runs["background"]["losses"]
    if fg != bg:
        bad = [i for i, (a, b) in enumerate(zip(fg, bg)) if a != b]
        raise AssertionError(f"warmup-bg: losses differ from the "
                             f"foreground-warmed session's at steps "
                             f"{bad[:5]}")
    runs["losses_bitwise_equal"] = True
    runs["launches"] = {k: runs["foreground"]["launches"][k]
                        + runs["background"]["launches"][k]
                        for k in runs["foreground"]["launches"]}
    return runs


def phase_drivers(torch, lm1b_ckpt):
    """The port's drivers in-process through ``main(argv)`` at their
    default widths: ``lm1b_driver`` (B2/B3) and ``lm1b_eval`` on
    ``lm1b_ckpt`` (ckpt-resume's checkpoint of LM1BConfig(); B1), then
    ``nmt_driver`` (B4-B6, saving a checkpoint) and ``nmt_eval`` with
    beam 4 on it (B4)."""
    import shutil
    import tempfile
    from parallax_tpu_torch.examples import (lm1b_driver, lm1b_eval,
                                             nmt_driver, nmt_eval)
    from parallax_tpu_torch.models import nmt
    out = {}
    n = DRIVERS["lm1b_steps"]
    zero_lstm_counts()
    t0 = time.perf_counter()
    losses = lm1b_driver.main(
        ["--max_steps", str(n), "--log_frequency", str(DRIVERS["lm1b_log"]),
         "--lstm_impl", "pallas", "--partitions",
         str(TRAIN["num_partitions"])])
    torch.cuda.synchronize()
    out["lm1b_driver"] = {"losses": losses, "launches": lstm_counts(),
                          "wall_s": time.perf_counter() - t0}
    want = {"lstm_fwd": 0, "lstm_fwd_res": n + 1, "lstm_bwd": n + 1}
    if out["lm1b_driver"]["launches"] != want \
            or len(losses) != n // DRIVERS["lm1b_log"] \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"drivers: lm1b_driver {out['lm1b_driver']} "
                             f"(launches want {want})")
    zero_lstm_counts()
    t0 = time.perf_counter()
    ppl = lm1b_eval.main(
        ["--ckpt_dir", str(lm1b_ckpt), "--partitions",
         str(TRAIN["num_partitions"]), "--eval_batches",
         str(DRIVERS["lm1b_eval_batches"])])
    torch.cuda.synchronize()
    out["lm1b_eval"] = {"perplexity": ppl, "launches": lstm_counts(),
                        "wall_s": time.perf_counter() - t0}
    want = {"lstm_fwd": DRIVERS["lm1b_eval_batches"], "lstm_fwd_res": 0,
            "lstm_bwd": 0}
    if out["lm1b_eval"]["launches"] != want or not math.isfinite(ppl):
        raise AssertionError(f"drivers: lm1b_eval {out['lm1b_eval']} "
                             f"(launches want {want})")
    root = Path(tempfile.mkdtemp(prefix="parallax-drivers-"))
    try:
        n = DRIVERS["nmt_steps"]
        L = nmt.NMTConfig().num_layers
        zero_flash_counts()
        t0 = time.perf_counter()
        losses = nmt_driver.main(
            ["--pallas_attention", "--max_steps", str(n), "--log_frequency",
             str(DRIVERS["nmt_log"]), "--ckpt_dir", str(root),
             "--save_ckpt_steps", str(n)])
        torch.cuda.synchronize()
        out["nmt_driver"] = {"losses": losses, "launches": flash_counts(),
                             "wall_s": time.perf_counter() - t0}
        per = 3 * L * (n + 1)      # enc self, dec self, cross; + warm call
        want = dict.fromkeys(("flash_attention_fwd", "flash_attention_dq",
                              "flash_attention_dkv"), per)
        if out["nmt_driver"]["launches"] != want \
                or len(losses) != n // DRIVERS["nmt_log"] \
                or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"drivers: nmt_driver {out['nmt_driver']}"
                                 f" (launches want {want})")
        zero_flash_counts()
        t0 = time.perf_counter()
        bleu = nmt_eval.main(
            # the driver's positional table: max(src_len, tgt_len) = 64
            ["--ckpt_dir", str(root), "--max_len", "64",
             "--beam_width", "4", "--eval_batches",
             str(DRIVERS["nmt_eval_batches"]), "--pallas_attention"])
        torch.cuda.synchronize()
        out["nmt_eval"] = {"bleu": bleu, "launches": flash_counts(),
                           "wall_s": time.perf_counter() - t0}
        want = {"flash_attention_fwd": L * DRIVERS["nmt_eval_batches"],
                "flash_attention_dq": 0, "flash_attention_dkv": 0}
        if out["nmt_eval"]["launches"] != want or not math.isfinite(bleu):
            raise AssertionError(f"drivers: nmt_eval {out['nmt_eval']} "
                                 f"(launches want {want})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[drivers] {json.dumps(out)}")
    out["launches"] = {
        "lstm_fwd": out["lm1b_eval"]["launches"]["lstm_fwd"],
        "lstm_fwd_res": out["lm1b_driver"]["launches"]["lstm_fwd_res"],
        "lstm_bwd": out["lm1b_driver"]["launches"]["lstm_bwd"],
        **{k: out["nmt_driver"]["launches"][k]
           + out["nmt_eval"]["launches"][k]
           for k in out["nmt_driver"]["launches"]}}
    return out


MAIN_PATH_CASES = {
    "flash_attention_fwd": ["serve", "train_enc", "train_dec", "bert",
                            "lc_train", "moe_train", "nmt_beam", "oneshot",
                            "lc_pipe"],
    "flash_attention_dq": ["train_enc", "train_dec", "bert", "lc_train",
                           "moe_train", "lc_pipe"],
    "flash_attention_dkv": ["train_enc", "train_dec", "bert", "lc_train",
                            "moe_train", "lc_pipe"],
    "paged_decode_attention": ["serve", "serve_g3", "moe_serve",
                               "lc_serve"],
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
    main-path case's numbers. B4's launches are the NMT serving paths'
    (plain, speculative with chunked prefill, with the prefix cache,
    one-shot, the fleet, disaggregated, over the mesh), the
    NMT, BERT, long-context and MoE training paths', NMT beam search's and
    the NaN rollback's and NMT batching's, the NMT drivers' (training and
    beam eval), B5's and B6's the training paths' (those six, the NMT
    driver), B2's and B3's LM1B training's (``train``, ``dist-train``,
    ``obs-train``, ``tune-train``, ``profile-train``, ``tune-calibrated``,
    ``ckpt-resume``, ``data-feed``, ``warmup-bg``, the LM1B driver), B1's
    the train phase's held-out loss and ``lm1b_eval``'s, B7's the serving
    paths' (NMT plain, speculative, prefix, fleet, disaggregated and over
    the mesh, causal LM unchunked and chunked, MoE LM). An LSTM entry
    names the source of the route its case ran on."""
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
    agree = phase("agreement", phase_agreement, torch, params, cfg,
                  requests[:32])
    serve_spec = phase("serve-spec", phase_serve_spec, torch, cfg, params,
                       requests)
    serve_spec_agree = phase("serve-spec-agree", phase_serve_spec_agree,
                             torch, params, cfg,
                             requests[:SPEC["agree_requests"]])
    serve_prefix = phase("serve-prefix", phase_serve_prefix, torch, cfg,
                         params)
    oneshot, oneshot_outs = phase("oneshot", phase_oneshot, torch, cfg,
                                  params, requests)
    fleet = phase("fleet", phase_fleet, torch, cfg, params, requests,
                  serve_summary)
    disagg = phase("disagg", phase_disagg, torch, cfg, params, requests)
    serve_mesh = phase("serve-mesh", phase_serve_mesh, torch, cfg, params,
                       requests, served, serve_summary, oneshot_outs,
                       oneshot)
    del params, served, oneshot_outs
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
    layouts_train = phase("layouts-train", phase_layouts_train, torch,
                          train["losses"])
    train_agree = phase("train-agree", phase_train_agreement, torch)
    warmup_bg = phase("warmup-bg", phase_warmup_bg, torch)
    obs_train = phase("obs-train", phase_obs_train, torch)
    obs_overhead = phase("obs-overhead", phase_obs_overhead, torch)
    tune_train, tuned_sess, tuned_batches, nominal_terms = phase(
        "tune-train", phase_tune_train, torch)
    profile_train, cal_path = phase("profile-train", phase_profile_train,
                                    torch, tuned_sess, tuned_batches)
    del tuned_sess, tuned_batches
    tune_calibrated = phase("tune-calibrated", phase_tune_calibrated,
                            torch, cal_path, nominal_terms)
    skip_thoughts = phase("skip-thoughts-train", phase_skip_thoughts_train,
                          torch, card)
    lm1b_full = phase("lm1b-full", phase_lm1b_full, torch, card, train)
    nmt_train, nmt_profile = phase("nmt-train", phase_nmt_train, torch)
    nmt_agree = phase("nmt-train-agree", phase_nmt_train_agreement, torch)
    resnet_train, resnet_profile = phase("resnet-train", phase_resnet_train,
                                         torch)
    resnet_agree = phase("resnet-agree", phase_resnet_agree, torch)
    bert_train = phase("bert-train", phase_bert_train, torch, card)
    bert_agree = phase("bert-agree", phase_bert_agree, torch)
    lc_train = phase("lc-train", phase_lc_train, torch, card)
    lc_agree = phase("lc-agree", phase_lc_agree, torch)
    lc_pipe = phase("lc-pipe", phase_lc_pipe, torch, card, lc_train)
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
    lc_chunked = phase("lc-serve-chunked", phase_lc_serve_chunked, torch,
                       lc_cfg, lc_params, prompts[:LC_CHUNKED["requests"]],
                       lc_serve_summary)
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
    moe_b7 = phase("moe-serve-b7", moe_serve_b7, torch, moe_serve["served"])
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
    lm1b_serve = phase("lm1b-serve", phase_lm1b_serve, torch)
    kept = []
    try:
        ckpt_resume = phase("ckpt-resume", phase_ckpt_resume, torch, kept)
        drivers = phase("drivers", phase_drivers, torch, kept[0] / "ck")
    finally:
        import shutil
        for d in kept:
            shutil.rmtree(d, ignore_errors=True)
    nan_rollback = phase("nan-rollback", phase_nan_rollback, torch)
    data_feed = phase("data-feed", phase_data_feed, torch)
    nmt_data = phase("nmt-data", phase_nmt_data, torch)
    elastic_train = phase("elastic-train", phase_elastic_train, torch,
                          card)
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
            nmt_beam["launches"].items()) + list(
            serve_spec["launches"].items()) + list(
            serve_prefix["launches"].items()) + list(
            lc_chunked["launches"].items()) + list(
            oneshot["launches"].items()) + list(
            fleet["launches"].items()) + list(
            disagg["launches"].items()) + list(
            ckpt_resume["launches"].items()) + list(
            nan_rollback["launches"].items()) + list(
            data_feed["launches"].items()) + list(
            nmt_data["launches"].items()) + list(
            lm1b_full["launches"].items()) + list(
            lc_pipe["launches"].items()) + list(
            obs_train["launches"].items()) + list(
            tune_train["launches"].items()) + list(
            profile_train["launches"].items()) + list(
            tune_calibrated["launches"].items()) + list(
            layouts_train["launches"].items()) + list(
            elastic_train["launches"].items()) + list(
            serve_mesh["launches"].items()) + list(
            warmup_bg["launches"].items()) + list(
            drivers["launches"].items()):
        launches[name] = launches.get(name, 0) + n
    cases = results + lstm_results + [moe_b7]
    line = kernel_line(cases, launches)
    record = {"card": card, "kernels": line["kernels"],
              "cases": cases, "paged_splits": paged_splits,
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
              "serve_spec": serve_spec, "serve_spec_agreement":
              serve_spec_agree, "serve_prefix": serve_prefix,
              "lc_serve_chunked": lc_chunked, "lm1b_serve": lm1b_serve,
              "oneshot": oneshot, "fleet": fleet, "disagg": disagg,
              "ckpt_resume": ckpt_resume, "nan_rollback": nan_rollback,
              "data_feed": data_feed, "nmt_data": nmt_data,
              "skip_thoughts_train": skip_thoughts, "lm1b_full": lm1b_full,
              "lc_pipe": lc_pipe, "obs_train": obs_train,
              "obs_overhead": obs_overhead, "tune_train": tune_train,
              "profile_train": profile_train,
              "tune_calibrated": tune_calibrated,
              "layouts_train": layouts_train,
              "elastic_train": elastic_train, "serve_mesh": serve_mesh,
              "warmup_bg": warmup_bg, "drivers": drivers,
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
