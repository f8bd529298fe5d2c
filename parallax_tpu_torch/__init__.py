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
* NMT continuous-decode serving: ``ServeSession`` drives a
  ``ContinuousScheduler`` over an ``NMTDecodeProgram``, with a CUDA
  flash-attention forward (ops/flash_attention.py) and a CUDA
  paged-decode kernel (ops/paged_attention.py).
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
* NMT beam search (``nmt.beam_decode``) and corpus BLEU
  (``common.evaluation.corpus_bleu``).
* Dense CNN training: ``parallel_run(cnn.build_model("resnet50_v1.5"),
  parallax_config=Config(run_option="AR"))`` and the rest of the CNN zoo,
  a stateful model (BatchNorm statistics) with momentum SGD; no TPU
  kernel lies on this path. ``simple`` is the linear-regression smoke.

The stateless training paths run over N ranks too (one process a card,
the JAX package's ``('repl', 'shard')`` mesh over ``torch.distributed``:
dense gradients all-reduced, sparse tables row-sharded and looked up
through all-gather and reduce-scatter; ``parallel_run(resource_info=
"localhost:0,1,...")`` starts the ranks).

On the card every train step and every serving decode step is a replay
of a CUDA graph captured ahead of step 0 (``compile/``: bucketing,
warmup, caches; ``ParallaxSession.warmup``, ``compile.disable_capture``).
The kernels are built from ``csrc/`` at first use. The JAX package
``parallax_tpu`` is the reference; this package imports neither it nor
JAX.
"""

from parallax_tpu_torch.common.config import (Config, ParallaxConfig,
                                              ServeConfig)
from parallax_tpu_torch.common.lib import parallax_log as log
from parallax_tpu_torch.core.engine import Model, TrainState
from parallax_tpu_torch.models import (cnn, lm1b, long_context, moe_lm,
                                      nmt, simple)
from parallax_tpu_torch.runner import parallel_run
from parallax_tpu_torch.serve import (CausalLMDecodeProgram,
                                      MoeLMDecodeProgram, NMTDecodeProgram,
                                      ServeSession)
from parallax_tpu_torch.session import Fetch, ParallaxSession, materialize

__version__ = "0.1.0"

__all__ = ["parallel_run", "log", "Config", "ParallaxConfig", "ServeConfig",
           "Model", "TrainState", "ParallaxSession", "Fetch", "materialize",
           "ServeSession", "NMTDecodeProgram", "CausalLMDecodeProgram",
           "MoeLMDecodeProgram", "cnn", "lm1b", "long_context", "moe_lm",
           "nmt", "simple"]
