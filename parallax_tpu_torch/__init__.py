"""parallax_tpu_torch — the PyTorch and CUDA port of parallax_tpu.

It runs on one NVIDIA H100 (Hopper, sm_90a). This package holds the
NMT continuous-decode serving path: ``ServeSession`` drives a
``ContinuousScheduler`` over an ``NMTDecodeProgram``. The encoder's
attention runs in a hand-written CUDA flash-attention forward kernel
(ops/flash_attention.py). The paged self-attention of every decode step
runs in a hand-written CUDA paged-decode kernel (ops/paged_attention.py).
Both kernels are built from ``csrc/`` at first use. The JAX package
``parallax_tpu`` is the reference; this package imports neither it nor
JAX.
"""

from parallax_tpu_torch.common.config import (Config, ParallaxConfig,
                                              ServeConfig)
from parallax_tpu_torch.common.lib import parallax_log as log
from parallax_tpu_torch.models import nmt
from parallax_tpu_torch.serve import NMTDecodeProgram, ServeSession

__version__ = "0.1.0"

__all__ = ["ServeSession", "ServeConfig", "Config", "ParallaxConfig",
           "NMTDecodeProgram", "nmt", "log"]
