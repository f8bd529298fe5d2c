"""Checkpoints and recovery for training (``parallax_tpu/ckpt``).

* ``store``: atomic, verifiable checkpoints in the JAX package's on-disk
  format: per-rank shard files with per-shard checksums, the manifest
  committed last, fallback across torn and corrupt steps, retention.
* ``snapshot``: the state as leaves named as the JAX package names them,
  each a global array with this rank's pieces; host snapshots copied
  back in place.
* ``hook``: ``CheckpointHook``, the step and seconds cadence, async
  saves, restore with fallback, the final save on preemption.
* ``resume``: ``restore_train_state`` for eval flows and resharded
  restores.
* ``recovery``: NaN rollback to an in-memory last-good snapshot, bounded
  retries, the batch skipped.

``parallax_tpu_torch.checkpoint`` re-exports the public names.
"""

from parallax_tpu_torch.ckpt.hook import CheckpointHook
from parallax_tpu_torch.ckpt.recovery import (RecoveryPolicy,
                                              RecoverySurrender,
                                              host_snapshot,
                                              restore_snapshot)
from parallax_tpu_torch.ckpt.resume import restore_train_state
from parallax_tpu_torch.ckpt.store import (CheckpointCorrupt,
                                           CheckpointStore,
                                           CheckpointTreeMismatch)

__all__ = [
    "CheckpointHook", "CheckpointStore", "CheckpointCorrupt",
    "CheckpointTreeMismatch", "RecoveryPolicy", "RecoverySurrender",
    "restore_train_state", "host_snapshot", "restore_snapshot",
]
