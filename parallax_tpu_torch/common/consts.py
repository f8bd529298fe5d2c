"""Framework-wide constants (the subset of ``parallax_tpu.common.consts``
the serving slice reads)."""

# --- logging ---------------------------------------------------------------
PARALLAX_LOG_LEVEL = "PARALLAX_LOG_LEVEL"
