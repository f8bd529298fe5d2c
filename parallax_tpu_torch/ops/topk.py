"""Top-k with ``lax.top_k``'s tie rule, shared by the MoE router and NMT
beam search: ``torch.topk`` does not promise which of equal values it
keeps, and both paths are held to JAX's picks."""

from __future__ import annotations

import torch


def top_k_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` on the last dim: the ``k`` largest values in
    descending order and their indices, equal values in index order (a
    stable sort), so ties go to the lowest index as JAX's do."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


__all__ = ["top_k_stable"]
