"""Configuration: ``ServeConfig``, ``PSConfig``, ``CommunicationConfig``,
``CheckPointConfig``, ``RecoveryConfig``, ``ProfileConfig``,
``TuneConfig`` and the top-level ``Config``.

Copies of ``parallax_tpu.common.config``'s ``ServeConfig``,
``CheckPointConfig``, ``RecoveryConfig``, ``ProfileConfig`` and
``TuneConfig`` (same fields, same validation), and of ``PSConfig``,
``CommunicationConfig`` and ``ParallaxConfig`` reduced to the fields
serving and training read, so code that builds a JAX-package config
builds this one with the same keywords.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Union

from parallax_tpu_torch.common import consts


@dataclasses.dataclass
class ServeConfig:
    """Online-serving knobs.

    * ``max_batch``: the largest one-shot device batch, and the slot
      count of the continuous-decode scheduler.
    * ``max_wait_ms``: batch-formation deadline of the one-shot
      micro-batcher — a partial batch dispatches once its oldest
      request has waited this long (the continuous scheduler does not
      read it).
    * ``max_queue``: admission bound. A submit beyond this many waiting
      requests is SHED (``ServeOverloaded`` raised to the caller,
      ``serve.shed`` counted).
    * ``default_deadline_ms``: per-request latency budget when the
      caller doesn't pass one. A request whose deadline expires before
      it completes is dropped (``DeadlineExceeded`` on its future,
      ``serve.timeouts`` counted). None = no deadline.
    * ``batch_buckets`` / ``length_buckets``: the one-shot mode's
      signature set — formed batches pad onto a batch bucket (default
      powers of two up to ``max_batch``), ragged feeds onto a length
      bucket; each (batch, length) pair is captured ahead of serving
      (not read by continuous decode).
    * ``drain_timeout_s``: ``close()`` stops admission and serves the
      already-accepted queue to completion, up to this long; whatever
      is still queued after it is failed with ``ServeClosed``.
    * ``prefix_cache`` / ``prefix_cache_max_pages`` /
      ``prefix_cache_max_entries``: prefix-aware KV reuse
      (serve/prefixcache.py): finished sequences' pages and prefill
      state cached under their exact key, bounded by pages and entries.
    * ``tenant_quotas`` / ``default_tenant_quota``: per-tenant
      admission quotas — a tenant's admitted-but-unfinished requests
      are capped at its quota, shed with ``TenantQuotaExceeded``.
    * ``slo_classes``: named service classes, ``{name: {"priority":
      int, "deadline_ms": float | None}}``; ``submit(slo_class=...)``
      inherits the class deadline and the queue serves lower priority
      ranks first (FIFO within a class).
    """

    max_batch: int = 8
    max_wait_ms: float = 5.0
    max_queue: int = 128
    default_deadline_ms: Optional[float] = None
    batch_buckets: Optional[Sequence[int]] = None
    length_buckets: Optional[Sequence[int]] = None
    drain_timeout_s: float = 30.0
    prefix_cache: bool = False
    prefix_cache_max_pages: Optional[int] = None
    prefix_cache_max_entries: Optional[int] = None
    tenant_quotas: Optional[Dict[Any, int]] = None
    default_tenant_quota: Optional[int] = None
    slo_classes: Optional[Dict[str, Dict[str, Any]]] = None

    def __post_init__(self):
        if int(self.max_batch) < 1:
            raise ValueError(
                f"serve max_batch must be >= 1, got {self.max_batch}")
        if float(self.max_wait_ms) < 0:
            raise ValueError(
                f"serve max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if int(self.max_queue) < 1:
            raise ValueError(
                f"serve max_queue must be >= 1, got {self.max_queue}")
        if self.default_deadline_ms is not None \
                and float(self.default_deadline_ms) <= 0:
            raise ValueError(
                f"serve default_deadline_ms must be > 0, got "
                f"{self.default_deadline_ms}")
        for name in ("batch_buckets", "length_buckets"):
            v = getattr(self, name)
            if v is None:
                continue
            v = tuple(sorted({int(b) for b in v}))
            if not v or any(b < 1 for b in v):
                raise ValueError(
                    f"serve {name} must be positive sizes, got "
                    f"{getattr(self, name)!r}")
            setattr(self, name, v)
        if self.batch_buckets is not None \
                and self.batch_buckets[-1] < int(self.max_batch):
            raise ValueError(
                f"serve batch_buckets {self.batch_buckets} do not cover "
                f"max_batch={self.max_batch}; the largest bucket must "
                f"fit a full batch")
        for name in ("prefix_cache_max_pages",
                     "prefix_cache_max_entries"):
            v = getattr(self, name)
            if v is not None and int(v) < 0:
                raise ValueError(
                    f"serve {name} must be >= 0, got {v}")
        for name, q in (self.tenant_quotas or {}).items():
            if int(q) < 1:
                raise ValueError(
                    f"serve tenant quota for {name!r} must be >= 1, "
                    f"got {q}")
        if self.default_tenant_quota is not None \
                and int(self.default_tenant_quota) < 1:
            raise ValueError(
                f"serve default_tenant_quota must be >= 1, got "
                f"{self.default_tenant_quota}")
        for name, cls in (self.slo_classes or {}).items():
            if not isinstance(cls, dict) or "priority" not in cls:
                raise ValueError(
                    f"serve slo_classes[{name!r}] must be a dict with "
                    f"a 'priority' key, got {cls!r}")
            ddl = cls.get("deadline_ms")
            if ddl is not None and float(ddl) <= 0:
                raise ValueError(
                    f"serve slo_classes[{name!r}] deadline_ms must be "
                    f"> 0 or None, got {ddl}")

    def resolve_slo_class(self, name: Optional[str]):
        """``(priority_rank, class_deadline_ms)`` for an SLO class
        name (rank 0 / no deadline for None); unknown names are
        refused loudly."""
        if name is None:
            return 0, None
        classes = self.slo_classes or {}
        if name not in classes:
            raise ValueError(
                f"unknown slo_class {name!r}; declared: "
                f"{sorted(classes) or '(none)'}")
        cls = classes[name]
        ddl = cls.get("deadline_ms")
        return int(cls["priority"]), (float(ddl) if ddl is not None
                                      else None)

    def resolved_batch_buckets(self) -> tuple:
        """Declared buckets, or doubling sizes 1,2,4,... up to (and
        including) ``max_batch``."""
        if self.batch_buckets is not None:
            return tuple(self.batch_buckets)
        out, b = [], 1
        while b < int(self.max_batch):
            out.append(b)
            b *= 2
        out.append(int(self.max_batch))
        return tuple(out)


@dataclasses.dataclass
class PSConfig:
    """Row-sharded (reference: parameter-server) path options
    (reference config.py:21-49).

    * ``replicate_variables``: True keeps dense variables replicated on
      every rank; False row-shards every dense variable whose leading
      dim divides the shard axis (HYBRID), all-gathered for use and its
      gradient reduce-scattered (core/engine.py).
    * ``local_aggregation``: the two-stage sparse combine: each rank
      sums its duplicate ids into unique slots before the cross-shard
      exchange (ops/embedding.py ``_dedup_capacity``). Exact.
    * ``dedup_capacity``: a declared unique-id slot count (int, or a
      dict keyed by parameter path or table-shape tuple) below the exact
      bound. Never lossy: a step on which some rank has more distinct
      ids than that takes the uncompressed exchange (a mesh-uniform
      choice). Such a lookup needs one host read of the decision a step,
      so its steps run eagerly.
    * ``cross_replica_sparse``: how a row-sharded table's gradient
      merges over the 'repl' axis: None picks by bytes, True gathers the
      deduplicated (ids, rows) over the whole mesh, False all-reduces
      the [rows/shard, dim] shard gradient over 'repl'.
    """

    replicate_variables: bool = True
    local_aggregation: bool = True
    dedup_capacity: Union[int, Dict[Any, int], None] = None
    cross_replica_sparse: Optional[bool] = None


@dataclasses.dataclass
class CommunicationConfig:
    """Bundle of per-path comm options (reference config.py:72-81)."""

    ps_config: PSConfig = dataclasses.field(default_factory=PSConfig)


@dataclasses.dataclass
class CheckPointConfig:
    """Checkpointing (reference config.py:84-99): save every
    ``save_ckpt_steps`` steps and/or every ``save_ckpt_secs`` seconds
    into ``ckpt_dir``, in the JAX package's on-disk format (ckpt/store.py:
    per-rank shard files with per-shard checksums, the manifest committed
    last).

    * ``async_save``: the save copies the state to the host (the only
      cost on the dispatch thread) and a writer thread serializes and
      commits it; at most one save is in flight (the next save and
      ``close()`` join it first, the wait measured as
      ``ckpt.async_wait_seconds``). False: fully synchronous saves.
    * ``max_to_keep``: keep the newest N complete checkpoints (and drop
      torn directories older than the newest complete one); None keeps
      everything.
    """

    ckpt_dir: Optional[str] = None
    save_ckpt_steps: Optional[int] = None
    save_ckpt_secs: Optional[float] = None
    async_save: bool = False
    max_to_keep: Optional[int] = 5

    def __post_init__(self):
        if self.save_ckpt_steps is not None \
                and int(self.save_ckpt_steps) < 1:
            raise ValueError(
                f"save_ckpt_steps must be >= 1, got "
                f"{self.save_ckpt_steps}")
        if self.save_ckpt_secs is not None \
                and float(self.save_ckpt_secs) <= 0:
            raise ValueError(
                f"save_ckpt_secs must be > 0, got "
                f"{self.save_ckpt_secs}")
        if self.max_to_keep is not None and int(self.max_to_keep) < 1:
            raise ValueError(
                f"max_to_keep must be >= 1 (or None to keep "
                f"everything), got {self.max_to_keep}")
        if not isinstance(self.async_save, bool):
            raise ValueError(
                f"async_save must be a bool, got "
                f"{self.async_save!r} — a truthy string here usually "
                f"means a config plumbing bug")


@dataclasses.dataclass
class RecoveryConfig:
    """NaN/divergence auto-recovery (ckpt/recovery.py).

    * ``enabled``: turn the policy on; ``Config.monitor_health`` is
      turned on with it (the policy reads the step's ``loss_finite`` and
      ``grad_norm``), and the dispatch thread reads them each step.
    * ``snapshot_every_steps``: cadence of the in-memory last-good
      snapshot (a host copy of the state).
    * ``max_retries``: consecutive non-finite steps tolerated (each one
      rolls back and skips its batch) before ``RecoverySurrender``.
    """

    enabled: bool = False
    snapshot_every_steps: int = 25
    max_retries: int = 3

    def __post_init__(self):
        if int(self.snapshot_every_steps) < 1:
            raise ValueError(
                f"snapshot_every_steps must be >= 1, got "
                f"{self.snapshot_every_steps}")
        if int(self.max_retries) < 1:
            raise ValueError(
                f"max_retries must be >= 1, got {self.max_retries}")


@dataclasses.dataclass
class ProfileConfig:
    """Step-bracketed profiling (reference config.py:101-117): a
    ``torch.profiler`` trace of the configured steps (``profile_steps``,
    or the ``profile_range`` (begin, end)) written under ``profile_dir``
    (profiler.py). ``profile_worker`` selects the one rank that captures,
    so N ranks do not write N traces."""

    profile_dir: Optional[str] = None
    profile_steps: Optional[Sequence[int]] = None
    profile_range: Optional[Sequence[int]] = None  # (begin, end) step range
    profile_worker: Optional[int] = None


@dataclasses.dataclass
class TuneConfig:
    """The mesh auto-tuner's knobs (``parallax_tpu_torch.tune``): the
    cost-model search over ``(dp x tp)`` mesh shapes crossed with run
    options. ``Config(tune_config=TuneConfig())`` routes the session's
    planning through ``tune.search.MeshSearch``; ``tune_config=None``
    (default) keeps the 1-D ``PartitionSearch``.

    * ``enabled``: master switch.
    * ``top_k``: how many cost-model-shortlisted plans pay a measured
      trial; the rest are priced only.
    * ``run_options``: the run-option axis (default AR, SHARD and
      HYBRID; legacy MPI/PS aliases accepted).
    * ``min_tp`` / ``max_tp``: bounds on the shard-axis width.
    * ``max_pp``: cap on the pipeline-stage axis; 1 keeps the search
      two-dimensional, and above 1 it opens only for a model that
      declares ``Model.pipeline_info``.
    * ``trial_steps`` / ``trial_warmup``: steps a trial runs; its time
      is the median over steps ``[trial_warmup, trial_steps)``.
    * ``peak_flops`` / ``hbm_gbps`` / ``ici_gbps``: the cost model's
      per-card constants (FLOP/s, GB/s). Unset, they are the H100 SXM's
      published rates: 989.4 TF/s bf16 dense, 3.35 TB/s of HBM3 and
      900 GB/s of NVLink 4. ``ici_gbps`` keeps the JAX package's name;
      here it is the NVLink rate between the cards.
    * ``hbm_budget_gb`` / ``hbm_headroom``: the OOM preflight
      (``obs/memwatch.py``): a shortlisted plan whose captured step needs
      more than budget x headroom is refused before its trial, and the
      refusal recorded. Unset, the budget is the card's memory
      (``torch.cuda.mem_get_info``); on the CPU there is none and the
      preflight is skipped.
    """

    enabled: bool = True
    top_k: int = 3
    run_options: Optional[Sequence[str]] = None
    min_tp: int = 1
    max_tp: Optional[int] = None
    max_pp: int = 1
    trial_steps: int = 12
    trial_warmup: int = 4
    peak_flops: Optional[float] = None
    hbm_gbps: Optional[float] = None
    ici_gbps: Optional[float] = None
    hbm_budget_gb: Optional[float] = None
    hbm_headroom: float = 0.9

    def __post_init__(self):
        if int(self.top_k) < 1:
            raise ValueError(
                f"tune top_k must be >= 1, got {self.top_k}")
        if self.run_options is not None:
            opts = tuple(normalize_run_option(o)
                         for o in self.run_options)
            if not opts:
                raise ValueError(
                    "tune run_options must name at least one of "
                    "AR/SHARD/HYBRID (or be None for all three)")
            # deduped, order kept (the order breaks score ties)
            self.run_options = tuple(dict.fromkeys(opts))
        if int(self.min_tp) < 1:
            raise ValueError(
                f"tune min_tp must be >= 1, got {self.min_tp}")
        if self.max_tp is not None and int(self.max_tp) < int(self.min_tp):
            raise ValueError(
                f"tune max_tp ({self.max_tp}) must be >= min_tp "
                f"({self.min_tp})")
        if int(self.max_pp) < 1:
            raise ValueError(
                f"tune max_pp must be >= 1, got {self.max_pp}")
        if int(self.trial_warmup) < 0:
            raise ValueError(
                f"tune trial_warmup must be >= 0, got "
                f"{self.trial_warmup}")
        if int(self.trial_steps) <= int(self.trial_warmup):
            raise ValueError(
                f"tune trial_steps ({self.trial_steps}) must exceed "
                f"trial_warmup ({self.trial_warmup}); the measured "
                f"window would be empty")
        for name in ("peak_flops", "hbm_gbps", "ici_gbps",
                     "hbm_budget_gb"):
            v = getattr(self, name)
            if v is not None and float(v) <= 0:
                raise ValueError(
                    f"tune {name} must be > 0 when set, got {v}")
        if not (0.0 < float(self.hbm_headroom) <= 1.0):
            raise ValueError(
                f"tune hbm_headroom must be in (0, 1], got "
                f"{self.hbm_headroom}")


@dataclasses.dataclass
class AnomalyConfig:
    """Knobs of the online anomaly detectors (``obs/anomaly.py``; the
    JAX package's ``AnomalyConfig``, field for field).

    A *spike* is one observation far above the rolling baseline
    (robust median/MAD test); a *shift* is a sustained level change —
    the change-point case a single-outlier test misses (a step-time
    regression, not a blip). Both count into ``anomaly.*`` and trigger
    a flight-recorder dump when ``flight_dir`` is configured.

    * ``enabled``: master switch (the obs kill switch also disables).
    * ``window``: rolling baseline sample count per signal.
    * ``min_samples``: observations before detection arms — compiles
      and warmup steps land in the baseline, never fire it.
    * ``spike_mads``: a spike must exceed the median by this many
      (scaled) MADs…
    * ``spike_min_ratio``: …AND by this multiplicative ratio (keeps a
      near-constant signal, MAD ~ 0, from firing on microscopic
      jitter).
    * ``shift_window`` / ``shift_ratio``: a shift fires when the mean
      of the last ``shift_window`` observations exceeds ``shift_ratio``
      × the older window's median; the detector then rebaselines.
    * ``cooldown``: observations before the same signal may fire again.
    """

    enabled: bool = True
    window: int = 64
    min_samples: int = 16
    spike_mads: float = 8.0
    spike_min_ratio: float = 2.0
    shift_window: int = 8
    shift_ratio: float = 1.5
    cooldown: int = 32

    def __post_init__(self):
        if int(self.window) < 2:
            raise ValueError(
                f"anomaly window must be >= 2, got {self.window}")
        if int(self.min_samples) < 2:
            raise ValueError(
                f"anomaly min_samples must be >= 2, got "
                f"{self.min_samples}")
        # arming requires min_samples observations IN the window, and
        # the shift test needs shift_window more on top — a config
        # violating either would be a silent no-op detector
        if int(self.window) < int(self.min_samples):
            raise ValueError(
                f"anomaly window ({self.window}) must be >= "
                f"min_samples ({self.min_samples}); detection would "
                f"never arm")
        if int(self.window) < int(self.min_samples) \
                + max(2, int(self.shift_window)):
            raise ValueError(
                f"anomaly window ({self.window}) must be >= "
                f"min_samples + shift_window "
                f"({self.min_samples} + {self.shift_window}); the "
                f"shift (change-point) detector would never arm")
        for name in ("spike_mads", "spike_min_ratio", "shift_ratio"):
            if float(getattr(self, name)) <= 0:
                raise ValueError(
                    f"anomaly {name} must be > 0, got "
                    f"{getattr(self, name)}")


@dataclasses.dataclass
class ParallaxConfig:
    """Top-level config, reduced to what serving and training read.

    * ``run_option``: 'AR' | 'SHARD' | 'HYBRID' (legacy aliases 'MPI' |
      'PS' | 'HYBRID' accepted). HYBRID routes each variable by its
      class: dense -> replicated, sparse -> row-sharded (one shard on
      one card).
    * ``sparse_grad_mode``: 'dense' (table grads are dense [V, D]
      tensors through the model's optimizer) or 'slices' (tables in
      ``Model.slice_updaters`` get their per-occurrence row grads
      applied scatter-only, outside the optimizer and its clip).
    * ``average_sparse``: average duplicate row updates by occurrence
      count instead of summing them.
    * ``sync`` / ``resource_info``: set by ``parallel_run`` through the
      reference-style setters. ``sync=False`` runs bounded-staleness
      delayed gradients: each step applies the gradients computed
      ``staleness`` steps earlier (core/engine.py).
    * ``staleness``: that k (>= 1); above 1 only with ``sync=False``.
    * ``communication_config``: its ``ps_config`` (``PSConfig``).
    * ``shape_buckets``: ascending batch sizes every feed batch is
      padded up to (the smallest bucket that fits), or ``"auto"`` (the
      first batch's size). Each bucket is one signature, so one captured
      CUDA graph of the step (compile/). None: no bucketing; every new
      batch shape is captured on first sight and counted in
      ``engine.recompiles``.
    * ``bucket_mask_feed``: the per-example weight feed bucketing masks:
      an existing feed of this name has its padded rows zeroed; when it
      is absent a ``[bucket]`` float32 mask (1 real, 0 padding) is added
      under this name on every batch (compile/bucketing.py).
    * ``compilation_cache_dir``: where the CUDA kernels are built and
      kept (compile/cache.py ``enable_persistent_cache``): a relaunch
      with the same sources loads them instead of running nvcc.
      Process-wide. None leaves the default build directory.
    * ``prefetch_depth``: how many converted and placed batches
      ``run_iter`` and ``data.prefetch_to_device`` may hold ahead of the
      step that consumes them (>= 1).
    * ``eager_fetch``: ``run()`` returns host values instead of lazy
      ``Fetch`` handles.
    * ``ckpt_config`` (``CheckPointConfig``), ``recovery_config``
      (``RecoveryConfig``; enabling it turns ``monitor_health`` on).
    * ``monitor_health``: the step also outputs ``grad_norm`` (the
      global norm of the dense gradients and the slice tables' row
      gradients) and ``loss_finite``.
    * ``handle_preemption``: on SIGTERM, save one checkpoint of the
      current state before the process ends (installed from the main
      thread, and only with a ``ckpt_dir``).
    * ``search_partitions``: with ``PARALLAX_MIN_PARTITIONS`` set (and
      no ``num_partitions``), search the shard-axis width
      (parallel/partitions.py).
    * ``profile_config`` (``ProfileConfig``): step-bracketed traces
      (profiler.py); ``profile_steps(n)`` arms one on demand.
    * ``tune_config`` (``TuneConfig``): plan through the mesh auto-tuner
      (tune/); None keeps the 1-D partition search.
    * ``calibration_path``: a calibration file (tune/calibrate.py) the
      cost model loads in place of its nominal exchange rates;
      ``write_calibration()`` writes it from a profiled window.

    Observability (``obs/``; the JAX package's fields, same names and
    defaults):

    * ``trace_path``: Chrome trace-event JSON of the host spans, written
      at session close; ``trace_buffer_events``: the span ring's
      capacity (grow-only: the collector is process-wide).
    * ``metrics_path``: a JSONL file a background thread appends one
      ``metrics_snapshot()`` to every ``metrics_interval_s`` seconds
      (and once at close), rotated at ``metrics_max_bytes``.
    * ``log_level`` / ``log_json``: the PARALLAX logger's level and a
      one-JSON-object-per-line format (``common.lib.configure_logging``).
    * ``numerics_interval``: every N steps the step also computes the
      per-layer stats tree (``obs/numwatch.py``) and outputs it as
      ``numerics``; on the card a second CUDA graph of the step per
      signature does so, chosen by the host. 0 (default): off, no second
      graph, no extra output. > 0 turns ``monitor_health`` on.
    * ``numerics_drift_interval``: every N steps the session runs the
      kernel drift sentinels (B2/B3 and B7 against their plain
      versions); 0 (default): only on ``run_drift_sentinels()``.
    * ``flight_dir`` / ``flight_steps``: where the flight recorder dumps
      its incident artifacts (None: no automatic dumps) and how many
      steps of timeline rows it keeps.
    * ``anomaly_config`` (``AnomalyConfig``): the spike and shift
      detectors over step time, loss and gradient norm.
    * ``journal_path`` / ``journal_capacity`` / ``journal_max_bytes``:
      the event journal's JSONL file (None: the in-memory ring only),
      its ring and its rotation bound.
    * ``alert_interval_s`` / ``alert_rules`` / ``goodput_floor``: the
      alert engine's evaluation cadence, rules armed next to the
      built-in ones, and the goodput-floor rule's threshold.
    """

    run_option: str = consts.RUN_HYBRID
    sparse_grad_mode: str = "dense"
    average_sparse: bool = False
    serve_config: ServeConfig = dataclasses.field(
        default_factory=ServeConfig)
    # injected by parallel_run (reference config.py:168-179)
    sync: bool = True
    resource_info: Any = None
    staleness: int = 1
    communication_config: CommunicationConfig = dataclasses.field(
        default_factory=CommunicationConfig)
    # -- compile-ahead engine (compile/) ---------------------------------
    shape_buckets: Union[None, str, Sequence[int]] = None
    bucket_mask_feed: str = "w"
    compilation_cache_dir: Optional[str] = None
    # -- the feed pipeline and the run's persistence (data/, ckpt/) ------
    prefetch_depth: int = 2
    eager_fetch: bool = False
    ckpt_config: CheckPointConfig = dataclasses.field(
        default_factory=CheckPointConfig)
    recovery_config: RecoveryConfig = dataclasses.field(
        default_factory=RecoveryConfig)
    handle_preemption: bool = True
    monitor_health: bool = False
    # -- planning and profiling (parallel/, tune/, profiler.py) ----------
    search_partitions: bool = True
    profile_config: ProfileConfig = dataclasses.field(
        default_factory=ProfileConfig)
    tune_config: Optional[TuneConfig] = None
    calibration_path: Optional[str] = None
    # -- observability (obs/) ---------------------------------------------
    trace_path: Optional[str] = None
    trace_buffer_events: int = 65536
    metrics_path: Optional[str] = None
    metrics_interval_s: float = 10.0
    metrics_max_bytes: Optional[int] = None
    log_level: Optional[str] = None
    log_json: bool = False
    numerics_interval: int = 0
    numerics_drift_interval: int = 0
    flight_dir: Optional[str] = None
    flight_steps: int = 256
    anomaly_config: AnomalyConfig = dataclasses.field(
        default_factory=AnomalyConfig)
    journal_path: Optional[str] = None
    journal_capacity: int = 512
    journal_max_bytes: Optional[int] = None
    alert_interval_s: float = 30.0
    alert_rules: Sequence[Any] = ()
    goodput_floor: float = 0.5

    def __post_init__(self):
        self.run_option = normalize_run_option(self.run_option)
        if self.recovery_config.enabled and not self.monitor_health:
            # the policy reads the in-graph loss_finite/grad_norm outputs
            self.monitor_health = True
        if int(self.numerics_interval) < 0:
            raise ValueError(
                f"numerics_interval must be >= 0, got "
                f"{self.numerics_interval}")
        if int(self.numerics_drift_interval) < 0:
            raise ValueError(
                f"numerics_drift_interval must be >= 0, got "
                f"{self.numerics_drift_interval}")
        if self.numerics_interval > 0 and not self.monitor_health:
            # provenance keys off the loss_finite trip
            self.monitor_health = True
        if float(self.metrics_interval_s) <= 0:
            raise ValueError(
                f"metrics_interval_s must be > 0, got "
                f"{self.metrics_interval_s}")
        if self.metrics_max_bytes is not None \
                and int(self.metrics_max_bytes) <= 0:
            raise ValueError(
                f"metrics_max_bytes must be > 0 or None, got "
                f"{self.metrics_max_bytes}")
        if int(self.trace_buffer_events) < 1:
            raise ValueError(
                f"trace_buffer_events must be >= 1, got "
                f"{self.trace_buffer_events}")
        if int(self.flight_steps) < 1:
            raise ValueError(
                f"flight_steps must be >= 1, got {self.flight_steps}")
        if int(self.journal_capacity) < 1:
            raise ValueError(
                f"journal_capacity must be >= 1, got "
                f"{self.journal_capacity}")
        if self.journal_max_bytes is not None \
                and int(self.journal_max_bytes) <= 0:
            raise ValueError(
                f"journal_max_bytes must be > 0 or None, got "
                f"{self.journal_max_bytes}")
        if float(self.alert_interval_s) <= 0:
            raise ValueError(
                f"alert_interval_s must be > 0, got "
                f"{self.alert_interval_s}")
        if not (0.0 <= float(self.goodput_floor) <= 1.0):
            raise ValueError(
                f"goodput_floor must be in [0, 1], got "
                f"{self.goodput_floor}")
        if int(self.prefetch_depth) < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.sparse_grad_mode not in ("dense", "slices"):
            raise ValueError(
                f"sparse_grad_mode must be 'dense' or 'slices', got "
                f"{self.sparse_grad_mode!r}")
        if self.shape_buckets is not None:
            # one validation rule, owned by compile/bucketing.py; 'auto'
            # stays the string and resolves against the first batch
            from parallax_tpu_torch.compile.bucketing import \
                resolve_buckets
            resolved = resolve_buckets(self.shape_buckets, 1)
            if not isinstance(self.shape_buckets, str):
                self.shape_buckets = resolved
        if not self.bucket_mask_feed:
            raise ValueError("bucket_mask_feed must be a feed name")
        if int(self.staleness) < 1:
            raise ValueError(
                f"staleness must be >= 1, got {self.staleness}")
        if self.tune_config is not None \
                and not isinstance(self.tune_config, TuneConfig):
            raise ValueError(
                f"tune_config must be a TuneConfig (or None), got "
                f"{type(self.tune_config).__name__} — a plain dict "
                f"here would silently skip the knob validation")

    # Reference-style setters (kept so ported driver code works unchanged).
    def set_sync(self, sync: bool) -> None:
        self.sync = sync

    def set_resource_info(self, resource_info) -> None:
        self.resource_info = resource_info


def normalize_run_option(run_option: str) -> str:
    opt = (run_option or consts.RUN_HYBRID).upper()
    opt = consts.LEGACY_RUN_ALIASES.get(opt, opt)
    if opt not in (consts.RUN_AR, consts.RUN_SHARD, consts.RUN_HYBRID):
        raise ValueError(
            f"unknown run_option {run_option!r}; expected one of "
            f"AR/SHARD/HYBRID (or legacy MPI/PS/HYBRID)")
    return opt


# The reference exports `Config` as an alias of ParallaxConfig.
Config = ParallaxConfig
