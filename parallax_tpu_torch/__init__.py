"""parallax_tpu_torch — the PyTorch and CUDA port of parallax_tpu.

It runs on NVIDIA H100s (Hopper, sm_90a). Ported slices:

* LM1B training: ``parallel_run(lm1b.build_model(cfg),
  parallax_config=Config(run_option="HYBRID", sparse_grad_mode="slices"))``
  classifies the parameters, routes the LSTM group through a global-norm
  clip and Adagrad and the tables through scatter-only slice Adagrad, and
  runs the LSTM recurrence in hand-written CUDA kernels: forward,
  forward with residuals and time-reversed backward (ops/lstm.py).
* NMT training through ``parallel_run(nmt.build_model(cfg))``, with the
  CUDA flash-attention forward and backward kernels.
* One-shot serving: ``ServeSession(infer_fn, params, example_feed=...)``
  micro-batches requests onto a declared (batch, length) signature set,
  each signature a CUDA graph captured ahead of traffic.
* NMT continuous-decode serving: ``ServeSession`` drives a
  ``ContinuousScheduler`` over an ``NMTDecodeProgram``, with a CUDA
  flash-attention forward (ops/flash_attention.py) and a CUDA
  paged-decode kernel (ops/paged_attention.py); chunked prefill,
  speculative decoding (a layer-skip draft, the paged kernel verifying
  k + 1 queries a slot) and the radix prefix cache, as in the JAX
  scheduler. ``LM1BDecodeProgram`` serves the LM1B LSTM (plain cells),
  and ``registered_adapters()`` lists the four serving adapters.
* The long-context causal LM: ``parallel_run(long_context.build_model(
  LongContextConfig()))`` trains with ring attention over the mesh's
  'shard' axis (one flash tile on one card), tensor parallelism with a
  vocab-parallel head, or data parallelism; ``CausalLMDecodeProgram``
  serves it through the paged-decode kernel, the prompt's K/V inserted
  through the page table.
* The switch-MoE LM: ``parallel_run(moe_lm.build_model(MoeLMConfig()))``
  trains with its experts split over the mesh's 'shard' axis (expert
  parallelism: an all-to-all dispatch and combine; on one card every
  expert runs on every token), the causal flash kernels with
  ``use_pallas_attention``; ``MoeLMDecodeProgram`` serves it through the
  paged-decode kernel.
* The serving fleet: ``ServeFleet`` (replicas behind a health-aware
  ``Router``, failover within the deadline, ``push_weights`` hot-swap —
  also from training through ``ParallaxSession.push_weights`` —, an
  autoscaler, ``FaultInjector`` for chaos) and ``DisaggFleet`` (a
  prefill pool and a decode pool joined by the npz wire format).
* NMT beam search (``nmt.beam_decode``) and corpus BLEU
  (``common.evaluation.corpus_bleu``).
* The training loop's input pipeline and persistence: ``data/`` (the
  native token loader ``TokenDataset``, ``Prefetcher`` and
  ``prefetch_to_device``, NMT vocab and bucketed batching) and ``ckpt/``
  (the JAX package's checkpoint format, async saves, exact and
  resharded resume, NaN rollback, the SIGTERM save), driven through
  ``ParallaxSession.run_iter``, ``place_batch`` and
  ``Config(ckpt_config=..., recovery_config=...)``.
* Observability around training and serving (``obs/``): the step
  timeline and MFU, anomaly detection, the flight recorder, the event
  journal, the goodput ledger, alerting, the Prometheus exporter
  (``ServeFleet.start_exporter``), the health and memory watches and the
  numerics observatory, whose drift sentinels run the LSTM (B2/B3) and
  paged-decode (B7) kernels against their plain versions
  (``ParallaxSession.run_drift_sentinels``).
* Dense CNN training: ``parallel_run(cnn.build_model("resnet50_v1.5"),
  parallax_config=Config(run_option="AR"))`` and the rest of the CNN zoo,
  a stateful model (BatchNorm statistics) with momentum SGD; no TPU
  kernel lies on this path. ``simple`` is the linear-regression smoke.
* Skip-thoughts (``skip_thoughts.build_model(SkipThoughtsConfig())``: a
  GRU encoder and two GRU decoders) and the LM1B full-softmax baseline
  (``lm1b.build_full_softmax_model``).
* Planning and profiling: ``Config(tune_config=TuneConfig())`` searches
  mesh shapes and run options with the cost model and measured trials
  (``tune/``; ``ParallaxSession.plan``, ``tune_summary``), the
  reference's partition search and ``get_partitioner`` (``parallel/``),
  and ``torch.profiler`` windows (``profile_steps``, ``ProfileConfig``)
  parsed into per-op attribution (``obs/xprof.py``: ``profile_summary``,
  ``write_calibration``).

The training paths run over N ranks too (one process a card, the JAX
package's ``('repl', 'shard')`` mesh over ``torch.distributed``: dense
gradients all-reduced, sparse tables row-sharded and looked up through
all-gather and reduce-scatter, BatchNorm statistics over the global
batch; ``parallel_run(resource_info="localhost:0,1,...")`` starts the
ranks). Pipeline parallelism (``ops/pipeline.py``: GPipe, 1F1B,
interleaved) runs the long-context LM's stages over the mesh's pipeline
axis (``core.mesh.build_mesh(shape=(dp, tp, pp))``, or 'shard').

On the card every train step and every serving decode step is a replay
of a CUDA graph captured ahead of step 0 (``compile/``: bucketing,
warmup, caches; ``ParallaxSession.warmup``, ``compile.disable_capture``).
The kernels are built from ``csrc/`` at first use. The JAX package
``parallax_tpu`` is the reference; this package imports neither it nor
JAX.
"""

from parallax_tpu_torch.common.config import (AnomalyConfig,
                                              CheckPointConfig, Config,
                                              ParallaxConfig, ProfileConfig,
                                              RecoveryConfig, ServeConfig,
                                              TuneConfig)
from parallax_tpu_torch.common.lib import parallax_log as log
from parallax_tpu_torch.core.engine import Model, TrainState
from parallax_tpu_torch.models import (cnn, lm1b, long_context, moe_lm,
                                      nmt, simple, skip_thoughts)
from parallax_tpu_torch.parallel.partitions import get_partitioner
from parallax_tpu_torch.runner import parallel_run
from parallax_tpu_torch.serve import (AdapterSpec, CausalLMDecodeProgram,
                                      DisaggFleet, FaultInjector,
                                      FleetConfig, HealthPolicy,
                                      LM1BDecodeProgram, MoeLMDecodeProgram,
                                      NMTDecodeProgram, Router, ServeFleet,
                                      ServeSession, register_adapter,
                                      registered_adapters)
from parallax_tpu_torch.session import (Fetch, ParallaxSession, StepHandle,
                                        materialize)
from parallax_tpu_torch import tune

__version__ = "0.1.0"

__all__ = ["get_partitioner", "parallel_run", "log", "Config",
           "ParallaxConfig", "ServeConfig", "CheckPointConfig",
           "RecoveryConfig", "AnomalyConfig", "ProfileConfig", "TuneConfig",
           "Model", "TrainState",
           "ParallaxSession", "Fetch", "StepHandle", "materialize",
           "ServeSession", "NMTDecodeProgram", "CausalLMDecodeProgram",
           "MoeLMDecodeProgram", "LM1BDecodeProgram", "AdapterSpec",
           "register_adapter", "registered_adapters", "ServeFleet",
           "FleetConfig", "DisaggFleet", "FaultInjector", "Router",
           "HealthPolicy", "cnn", "lm1b", "long_context", "moe_lm", "nmt",
           "simple", "skip_thoughts", "tune"]
