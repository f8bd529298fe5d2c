"""Framework-wide constants (the subset of ``parallax_tpu.common.consts``
the ported slices read)."""

# --- run-option dispatch (reference consts.py:18-22) -----------------------
RUN_AR = "AR"          # dense all-reduce            (reference: MPI/Horovod)
RUN_SHARD = "SHARD"    # row-sharded parameters      (reference: PS)
RUN_HYBRID = "HYBRID"  # per-variable routing        (reference: HYBRID)
LEGACY_RUN_ALIASES = {"MPI": RUN_AR, "PS": RUN_SHARD, "HYBRID": RUN_HYBRID}

# --- logging ---------------------------------------------------------------
PARALLAX_LOG_LEVEL = "PARALLAX_LOG_LEVEL"

# --- multi-rank launch (reference consts.py; the launcher injects these
# into every worker it starts) -----------------------------------------------
PARALLAX_RUN_OPTION = "PARALLAX_RUN_OPTION"        # "WORKER" on workers
PARALLAX_RESOURCE_INFO = "PARALLAX_RESOURCE_INFO"  # serialized hosts
PARALLAX_RANK = "PARALLAX_RANK"
PARALLAX_WORLD_SIZE = "PARALLAX_WORLD_SIZE"
PARALLAX_LOCAL_CHIP = "PARALLAX_LOCAL_CHIP"
# torch.distributed init_method: file://<path> or tcp://localhost:<port>
PARALLAX_RENDEZVOUS = "PARALLAX_RENDEZVOUS"
# seconds a rank waits for its peers (init and every collective)
PARALLAX_DIST_TIMEOUT = "PARALLAX_DIST_TIMEOUT"
DIST_TIMEOUT_DEFAULT_S = 600
