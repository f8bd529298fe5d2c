"""The shard-axis width search (``parallax_tpu/parallel/``)."""

from parallax_tpu_torch.parallel.partitions import (PartitionSearch,
                                                    get_partitioner)

__all__ = ["PartitionSearch", "get_partitioner"]
