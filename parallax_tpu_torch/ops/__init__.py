"""Operators of the serving slice: the dense embedding helpers and the
two attention kernels (``flash_attention``, ``paged_attention``), each
a CUDA kernel beside its plain PyTorch version."""
