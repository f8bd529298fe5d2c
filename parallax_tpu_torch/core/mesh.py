"""The device mesh of one card.

The JAX package lays its devices out as a ``('repl', 'shard')`` mesh,
with a third ``'pipe'`` axis for pipeline plans (core/mesh.py). The port
runs one process on one card, so its mesh is a record of that one card
with every axis of size 1: ``num_shards == 1``, which is what
``build_plan`` reads. ``torch.distributed`` meshes come with the
multi-rank slice.
"""

from __future__ import annotations

import dataclasses

import torch

AXIS_REPL = "repl"
AXIS_SHARD = "shard"
AXIS_PIPE = "pipe"
BATCH_AXES = (AXIS_REPL, AXIS_SHARD)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One card: ``shape`` maps each axis name to its size (all 1)."""

    device: torch.device

    @property
    def shape(self):
        return {AXIS_REPL: 1, AXIS_SHARD: 1}


def build_mesh(device) -> Mesh:
    return Mesh(torch.device(device))


def num_shards(mesh: Mesh) -> int:
    return mesh.shape[AXIS_SHARD]
