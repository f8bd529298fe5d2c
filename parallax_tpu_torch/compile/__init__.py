"""The compile-ahead engine: batch-shape bucketing (``bucketing``), CUDA
graph capture of the step (``graphs``), warmup ahead of step 0
(``warmup``) and the engine and kernel-build caches (``cache``)."""

from parallax_tpu_torch.compile.graphs import capture_enabled, \
    disable_capture

__all__ = ["capture_enabled", "disable_capture"]
