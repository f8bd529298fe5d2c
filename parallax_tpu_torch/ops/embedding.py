"""Embedding helpers (``parallax_tpu.ops.embedding``'s vocab padding,
padded-logit mask and lookup) and the slices-mode capture.

``SliceCapture`` is the counterpart of the JAX package's (ops/
embedding.py:63): while one is active, a lookup of a registered table
reads the rows from the table with no gradient path back to it and
hands them on as a fresh leaf tensor, recording ``(path, ids, rows)``.
The gradient of the loss with respect to ``rows`` is then exactly the
IndexedSlices pair ``(ids, per-occurrence row gradients)`` — what
``F.embedding(ids, table, sparse=True)`` would give as an uncoalesced
COO gradient, without the COO tensor and without a [V, D] gradient.
The engine applies it scatter-only (ops/sparse_optim.py). One card
holds the whole table, so there is no row exchange.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional

import torch
import torch.nn.functional as F


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


class SliceCapture:
    """Per-step state of the engine's "slices" sparse-gradient mode:
    ``table_paths`` maps ``id(table tensor)`` to its parameter path;
    ``captured`` collects ``(path, ids, rows)`` per lookup, in order."""

    def __init__(self, table_paths: Dict[int, str]):
        self.table_paths = dict(table_paths)
        self.captured = []

    def path_of(self, table) -> Optional[str]:
        return self.table_paths.get(id(table))


_CAPTURE: contextvars.ContextVar = contextvars.ContextVar(
    "parallax_slice_capture", default=None)


@contextlib.contextmanager
def slice_capture_scope(capture: SliceCapture):
    """Make ``capture`` the active slice capture for lookups inside."""
    token = _CAPTURE.set(capture)
    try:
        yield capture
    finally:
        _CAPTURE.reset(token)


def embedding_lookup(table: torch.Tensor,
                     ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [V, D] at integer ``ids``: a plain gather (the
    replicated layout, where every replica holds the whole table). A
    table registered with the active ``SliceCapture`` gets its rows as a
    leaf whose gradient is the step's slice for that lookup."""
    capture = _CAPTURE.get()
    path = capture.path_of(table) if capture is not None else None
    if path is None:
        return F.embedding(ids, table)
    rows = F.embedding(ids, table.detach()).requires_grad_()
    capture.captured.append((path, ids, rows))
    return rows
