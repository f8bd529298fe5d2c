"""Embedding helpers, dense path (``parallax_tpu.ops.embedding``'s
vocab padding, padded-logit mask and replicated lookup)."""

from __future__ import annotations

import torch


def pad_vocab(vocab_size: int, multiple: int) -> int:
    """Round vocab up so rows split evenly over ``multiple`` shards."""
    return -(-vocab_size // multiple) * multiple


def padded_vocab_for(vocab_size: int, num_partitions: int = 1) -> int:
    """Shared padding policy for model configs: pad so the table splits
    evenly over ``num_partitions``. Unlike the JAX package, which falls
    back to the visible device count, the partition count is explicit
    here (None means 1)."""
    return pad_vocab(vocab_size, max(num_partitions or 1, 1))


def mask_padded_logits(logits: torch.Tensor,
                       vocab_size: int) -> torch.Tensor:
    """Push the phantom classes introduced by vocab padding to -1e9 so
    they never win an argmax or receive probability mass (last-dim
    layout [..., padded_vocab])."""
    padded = logits.shape[-1]
    if padded == vocab_size:
        return logits
    mask = torch.zeros((padded,), dtype=logits.dtype,
                       device=logits.device)
    mask[vocab_size:] = -1e9
    return logits + mask


def embedding_lookup(table: torch.Tensor,
                     ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [V, D] at integer ``ids``: a plain gather (the
    replicated layout, where every replica holds the whole table)."""
    return table[ids]
