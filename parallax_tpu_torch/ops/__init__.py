"""Operators of the port: the collectives and global batch reductions,
embedding lookups (plain, and sharded over the mesh) and the
slices-mode capture, sampled softmax, the sparse optimizers, the
switch MoE with its expert-parallel dispatch (``moe``), the top-k
that breaks ties as ``lax.top_k`` does (``topk``), and the
CUDA kernels beside their plain PyTorch versions (``flash_attention``,
``paged_attention``, ``lstm``)."""
