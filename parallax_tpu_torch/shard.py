"""Input-data sharding (``parallax_tpu/shard.py``; reference
common/shard.py).

``shard(dataset)`` keeps the elements whose index ``i`` has
``i % num_shards == shard_id``, with ``num_shards`` the rank count and
``shard_id`` this rank, installed by ``parallel_run``;
``create_num_shards_and_shard_id()`` returns the pair for file-level
sharding. One process has one shard.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple, TypeVar

T = TypeVar("T")

_num_shards: int = 1
_shard_id: int = 0


def _install(num_shards: int, shard_id: int) -> None:
    """Called by ``parallel_run`` with (rank count, rank)."""
    global _num_shards, _shard_id
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
    _num_shards, _shard_id = num_shards, shard_id


def create_num_shards_and_shard_id() -> Tuple[int, int]:
    """(num_shards, shard_id) for file-level sharding (reference
    shard.py:26-54)."""
    return _num_shards, _shard_id


def shard(dataset: Iterable[T], num_shards: Optional[int] = None,
          shard_id: Optional[int] = None) -> Iterator[T]:
    """Yield only this rank's elements: index % num_shards == shard_id
    (reference shard.py:69-87)."""
    n = _num_shards if num_shards is None else num_shards
    s = _shard_id if shard_id is None else shard_id
    for i, elem in enumerate(dataset):
        if i % n == s:
            yield elem
