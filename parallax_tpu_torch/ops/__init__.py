"""Operators of the port: the collectives and global batch reductions,
embedding lookups (plain, and sharded over the mesh) and the
slices-mode capture, sampled softmax, the sparse optimizers, and the
CUDA kernels beside their plain PyTorch versions (``flash_attention``,
``paged_attention``, ``lstm``)."""
