"""The input pipeline: the native token loader, bounded prefetch and NMT
batching (``parallax_tpu/data``)."""

from parallax_tpu_torch.compile.bucketing import bucket_batch
from parallax_tpu_torch.data.loader import (TokenDataset, prefetch_to_device,
                                            write_token_file)
from parallax_tpu_torch.data.prefetch import Prefetcher

__all__ = ["TokenDataset", "write_token_file", "prefetch_to_device",
           "Prefetcher", "bucket_batch"]
