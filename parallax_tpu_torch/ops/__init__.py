"""Operators of the port: embedding helpers and the slices-mode capture,
sampled softmax, scatter-only Adagrad, and the CUDA kernels beside their
plain PyTorch versions (``flash_attention``, ``paged_attention``,
``lstm``)."""
