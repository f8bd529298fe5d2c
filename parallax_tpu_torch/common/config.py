"""Configuration: ``ServeConfig``, ``PSConfig``, ``CommunicationConfig``
and the top-level ``Config``.

Copies of ``parallax_tpu.common.config``'s ``ServeConfig`` (same
fields, same validation), and of ``PSConfig``, ``CommunicationConfig``
and ``ParallaxConfig`` reduced to the fields serving and training read,
so code that builds a JAX-package config builds this one with the same
keywords.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Union

from parallax_tpu_torch.common import consts


@dataclasses.dataclass
class ServeConfig:
    """Online-serving knobs.

    * ``max_batch``: the slot count of the continuous-decode scheduler.
    * ``max_wait_ms``: batch-formation deadline of the one-shot
      micro-batcher (kept for config compatibility; the continuous
      scheduler does not read it).
    * ``max_queue``: admission bound. A submit beyond this many waiting
      requests is SHED (``ServeOverloaded`` raised to the caller,
      ``serve.shed`` counted).
    * ``default_deadline_ms``: per-request latency budget when the
      caller doesn't pass one. A request whose deadline expires before
      it completes is dropped (``DeadlineExceeded`` on its future,
      ``serve.timeouts`` counted). None = no deadline.
    * ``batch_buckets`` / ``length_buckets``: the one-shot mode's
      signature set (validated, not read by continuous decode).
    * ``drain_timeout_s``: ``close()`` stops admission and serves the
      already-accepted queue to completion, up to this long; whatever
      is still queued after it is failed with ``ServeClosed``.
    * ``prefix_cache`` / ``prefix_cache_max_pages`` /
      ``prefix_cache_max_entries``: prefix-aware KV reuse. Not ported
      yet: the continuous scheduler refuses ``prefix_cache=True``.
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

    def __post_init__(self):
        self.run_option = normalize_run_option(self.run_option)
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
