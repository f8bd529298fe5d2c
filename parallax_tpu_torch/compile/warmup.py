"""AOT warmup: capture every declared bucket ahead of step 0
(``parallax_tpu.compile.warmup``).

For each declared batch-shape bucket the engine captures its step as a
CUDA graph (compile/graphs.py) before the first step, so step 0, the
first ragged tail and every other bucket replay a ready graph instead of
stopping the loop to capture one. The graphs are held by the engine and
replayed by batch signature (``Engine.step``); per-signature capture
wall time lands in the ``engine.compile_seconds`` histogram and in
``Engine.warmup_seconds`` (reported by
``ParallaxSession.compile_stats``).

A capture needs its inputs' shapes, not their values: each bucket gets
static input buffers of the example batch's shapes with the batch dim
re-sized (``compile.bucketing.bucket_shape``), zero-filled until a real
batch is copied in. The eager call before each capture runs a real step,
whose effect on the state the engine undoes bitwise. On the CPU nothing
is captured: the signatures are registered and the steps run eagerly.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.compile import bucketing
from parallax_tpu_torch.obs import trace


def aot_warmup(engine, state, batch_sizes: Optional[Sequence[int]] = None
               ) -> Dict[int, float]:
    """Capture the step for each bucket size; returns {size: seconds}.

    ``batch_sizes`` defaults to the engine's declared buckets
    (``Config.shape_buckets``). Sizes already captured are skipped, so
    warmup is idempotent and incremental. The signature is registered as
    expected, so warmed buckets never count into ``engine.recompiles``.
    """
    sizes = batch_sizes if batch_sizes is not None else engine._buckets
    if not sizes:
        raise ValueError(
            "warmup has no signatures to compile: declare "
            "Config.shape_buckets (or 'auto'), or pass explicit batch "
            "sizes")
    stats: Dict[int, float] = {}
    for b in sizes:
        b = int(b)
        sig = bucketing.batch_signature(engine._bucket_shapes(b))
        if engine._executables.get(sig) is not None or (
                sig in engine._executables and not engine._captures()):
            continue
        t0 = time.perf_counter()
        with trace.span("engine.warmup_compile", batch=b):
            engine._compile(state, sig)
        dt = time.perf_counter() - t0
        engine._traced_signatures.add(sig)
        engine.metrics.histogram("engine.compile_seconds").record(dt)
        stats[b] = dt
        parallax_log.info("warmup: captured step for batch bucket %d "
                          "in %.2fs", b, dt)
    engine.warmup_seconds.update(stats)
    return stats
