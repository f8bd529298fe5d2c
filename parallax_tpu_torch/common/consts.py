"""Framework-wide constants (the subset of ``parallax_tpu.common.consts``
the ported slices read)."""

# --- run-option dispatch (reference consts.py:18-22) -----------------------
RUN_AR = "AR"          # dense all-reduce            (reference: MPI/Horovod)
RUN_SHARD = "SHARD"    # row-sharded parameters      (reference: PS)
RUN_HYBRID = "HYBRID"  # per-variable routing        (reference: HYBRID)
LEGACY_RUN_ALIASES = {"MPI": RUN_AR, "PS": RUN_SHARD, "HYBRID": RUN_HYBRID}

# --- logging ---------------------------------------------------------------
PARALLAX_LOG_LEVEL = "PARALLAX_LOG_LEVEL"
