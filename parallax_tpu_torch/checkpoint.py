"""The checkpoint names at the package root (``parallax_tpu/
checkpoint.py``): the subsystem lives in ``parallax_tpu_torch.ckpt``."""

from parallax_tpu_torch.ckpt.hook import CheckpointHook
from parallax_tpu_torch.ckpt.resume import restore_train_state
from parallax_tpu_torch.ckpt.store import (CheckpointCorrupt,
                                           CheckpointStore,
                                           CheckpointTreeMismatch)

__all__ = ["CheckpointHook", "restore_train_state", "CheckpointStore",
           "CheckpointCorrupt", "CheckpointTreeMismatch"]
