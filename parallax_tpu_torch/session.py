"""ParallaxSession — the user-facing training loop object (a subset of
``parallax_tpu/session.py``).

``run(fetches, feed_dict)`` executes one train step and returns the
requested named outputs. Feed contract (reference
session_context.py:205-233): each feed value is one array covering the
whole local batch, or a list of ``num_replicas_per_worker`` (one)
per-replica arrays, concatenated on dim 0. On several ranks each rank
feeds its own share of the global batch, rank ``r * shard + s`` the
share of the JAX mesh's device ``(r, s)`` (the JAX multi-process
contract, engine.py:844-860); where the model's ``batch_specs`` put the
batch on 'repl' alone (the tensor-parallel models), each rank feeds its
repl row's share, ``r``'s of ``repl`` equal shares, alike on every rank
of its shard group (JAX's ``_feed_process_scale``); every rank must run
every step. Fetch
contract: names among {"loss", "global_step"} and the model's metric
names; a single name returns one value, a list returns a list, None
returns a dict. A model whose loss and metrics reduce over the batch
with ``ops.collectives.global_sum`` (the ported models) fetches the
global values, the same on every rank. ``gather_params()`` reads the
parameters with every row-sharded and tensor-parallel leaf whole, in the
JAX package's global layout (the counterpart of
``np.asarray(sess.state.params[...])``).

Fetches are lazy: ``run()`` returns ``Fetch`` handles whose value stays
on the card until first read, so the host does not wait for a step
before issuing the next one (``Config.eager_fetch`` returns host values;
``run_async()`` returns a ``StepHandle``). ``run_iter()`` drives a batch
iterator through a ``data.Prefetcher`` at ``Config.prefetch_depth``:
``place_batch`` converts, buckets and stages batch t+1 on a background
thread while step t runs (``Engine.stage``: a ring of pinned host and
device slots, the copy to the card on a side stream, each step copying
its slot into the graph's static inputs on its own stream).
``run_iter(placed=True)`` takes batches another pipeline placed with
``place_batch`` (``data.prefetch_to_device``), and ``skip=`` (or
``"auto"``, the restored ``data_cursor``) fast-forwards the stream.

Checkpoints and recovery (``Config.ckpt_config``, ``recovery_config``,
``handle_preemption``): the engine build restores the newest verified
checkpoint into the state, in place, with the data cursor and host step
of its extras; each step may save (``ckpt.CheckpointHook``, sync or
async); a non-finite loss or gradient norm rolls the state back to the
last in-memory snapshot and skips the batch (``set_rollback_hook``); a
SIGTERM saves once more before the process ends (``on_preemption``).
The checkpoint is the JAX package's format and names, so either package
resumes the other's run. The extras carry the JAX key set and format:
the data cursor, the anomaly detectors' baselines, the health
accounting and the goodput account (``ops``); a restore feeds them back,
across packages too.

Observability (``obs/``, the JAX session's monitors): always on, the
step timeline (``timeline``: wall time per step split into data wait,
conversion, H2D, dispatch, fetch block and the device residual, MFU
against ``step_flops()``), the anomaly detectors (``anomaly``), the
flight recorder (``flight``, ``dump_flight``; automatic dumps with
``Config.flight_dir``) and the memory watch (``memwatch``); with the obs
layer on, the event journal (``journal``), the goodput ledger
(``ledger``, ``ops_account``) and the alert engine (``alerts``). Opt in:
``Config.monitor_health`` (``health``: non-finite loss and gradient
norm, read from pinned copies behind CUDA events, never blocking the
dispatch thread), ``numerics_interval`` (``numerics``: the per-layer
stats of a second graph per signature, NaN provenance in the rollback
artifact; ``run_drift_sentinels``), ``metrics_path`` (a JSONL sink
thread) and ``trace_path`` (the Chrome trace, written at close).
``aggregate_host_steps`` names a straggler across ranks.

Planning (``parallax_tpu/session.py:522-685, 1837-1960``): every engine
is built for a ``tune.costmodel.Plan`` (mesh shape and run options) on
its own mesh (``build_mesh(shape=plan.mesh_shape())``, built once per
shape on every rank in one order) and kept in the engine cache under the
whole plan and the bucketed batch signature. ``Config(tune_config=
TuneConfig(...))`` plans through ``tune.MeshSearch``: the base engine's
counts price the plan space, the OOM preflight screens the shortlist
(its captured step's pool bytes against the card's memory), and the
``top_k`` plans each run ``trial_steps`` blocking steps; between them the
state is resharded in place onto the next plan's layout (every leaf
assembled whole over the old mesh, then cut for the new one), each
trial's median time is averaged over the ranks before the decision, so
every rank takes the same one, and the losing engines are pruned.
``plan``, ``tune_summary()`` and the flight recorder's ``tune`` section
hold the decision. Without a tuner, ``PARALLAX_MIN_PARTITIONS`` and
``Config.search_partitions`` run the reference's 1-D partition search
(``parallel.PartitionSearch``, the mean of steps ``[50, 100)`` a
candidate).

Profiling (``profiler.ProfileHook``, ``obs/xprof.py``):
``profile_steps(n)`` arms a ``torch.profiler`` window of the next n
steps (deferred past a step that captures a graph; on the card after
one warm-up step; the steps run as the loop runs them, where the JAX
session blocks each, and the hook synchronizes before it stops, so the
trace holds every kernel they launched), and ``profile_summary()``
parses it into
the per-op / per-collective attribution, with each kernel joined to the
source scope it ran under (``Engine.scope_index``); a window on the card
whose trace holds no device kernel raises. ``write_calibration()``
compares the settled search's predicted terms with that attribution and
writes the calibration file a later search loads
(``Config.calibration_path``).

Compile-ahead (``parallax_tpu/session.py:1713-1797``): ``warmup()``
captures the step's CUDA graph for every declared
``Config.shape_buckets`` bucket before step 0, and ``compile_stats()``
reports the buckets, the capture seconds and the cache counters. With
buckets declared every feed is padded onto its bucket before it is
copied to the card. On the card, feeds are copied from pinned host
memory into the engine's static input buffers, which the step's graph
reads.

Ported: ``run``, ``run_async``, ``run_iter``, ``place_batch``,
``prepare``, ``Fetch``, ``StepHandle``, ``state`` (with its
``model_state`` for a stateful model), ``engine``, ``evaluate``,
``warmup``, ``compile_stats``, ``gather_params``,
``sparse_wire_bytes_per_step``, ``data_cursor``, ``set_rollback_hook``,
``on_preemption``, ``close``, ``metrics_snapshot``, ``steps_per_sec``,
``step_flops``, ``dump_flight``, ``aggregate_host_steps``,
``ops_account``, ``run_drift_sentinels``, ``plan``, ``tune_summary``,
``profile_steps``, ``profile_summary``, ``write_calibration`` and the
serving handoff (``serve``, ``push_weights``).
"""

from __future__ import annotations

import math
import operator
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from parallax_tpu_torch.ckpt import snapshot as snap_lib
from parallax_tpu_torch.ckpt.hook import CheckpointHook
from parallax_tpu_torch.ckpt.recovery import (RecoveryPolicy,
                                              RecoverySurrender)
from parallax_tpu_torch.common import consts
from parallax_tpu_torch.common.config import ParallaxConfig
from parallax_tpu_torch.common.lib import (configure_logging, parallax_log,
                                           resolve_device)
from parallax_tpu_torch.compile import bucketing, cache as compile_cache
from parallax_tpu_torch.core import engine as engine_lib, mesh as mesh_lib
from parallax_tpu_torch.data.prefetch import Prefetcher, skip_items
from parallax_tpu_torch.obs import _state as obs_state
from parallax_tpu_torch.obs import aggregate as aggregate_lib
from parallax_tpu_torch.obs import memwatch as memwatch_lib
from parallax_tpu_torch.obs import numwatch as numwatch_lib
from parallax_tpu_torch.obs import trace, xprof
from parallax_tpu_torch.obs.alerts import AlertEngine, builtin_rules
from parallax_tpu_torch.obs.anomaly import AnomalyMonitor
from parallax_tpu_torch.obs.flightrec import FlightRecorder
from parallax_tpu_torch.obs.goodput import GoodputLedger
from parallax_tpu_torch.obs.health import (HealthMonitor,
                                           device_memory_stats, host_fields)
from parallax_tpu_torch.obs.journal import EventJournal
from parallax_tpu_torch.obs.metrics import (JsonlSink, MetricsRegistry,
                                            PipelineStats)
from parallax_tpu_torch.obs.timeline import StepTimeline
from parallax_tpu_torch.ops import collectives
from parallax_tpu_torch.parallel.partitions import PartitionSearch
from parallax_tpu_torch.profiler import ProfileHook
from parallax_tpu_torch.tune import calibrate as calibrate_lib, \
    costmodel as tune_costmodel
from parallax_tpu_torch.tune.costmodel import Plan
from parallax_tpu_torch.tune.search import MeshSearch


def _to_host(v):
    if isinstance(v, numwatch_lib.StatsTree):
        return v.host()
    if isinstance(v, torch.Tensor):
        arr = v.detach().cpu().numpy()
    else:
        arr = np.asarray(v)
    return arr.item() if arr.ndim == 0 else arr


class Fetch:
    """Lazy handle to one fetched value: the value stays on the card
    until the first read. Any read — ``result()``, ``float()``,
    ``int()``, ``np.asarray()``, arithmetic, comparison, formatting —
    copies it to the host once and caches it; ``shape`` and ``done()``
    never block. On first read it equals what an eager fetch returns
    (a Python scalar for 0-d outputs, an ndarray otherwise)."""

    __slots__ = ("_raw", "_host", "_done", "_ready", "_shape", "_on_block")

    def __init__(self, value, ready=None, on_block=None):
        self._raw = value
        self._host = None
        self._done = False
        self._ready = ready
        # fn(seconds): the first read's wait, attributed back to the
        # step that produced the value (obs/timeline.py)
        self._on_block = on_block
        self._shape = tuple(np.shape(value)) if not isinstance(
            value, torch.Tensor) else tuple(value.shape)

    def result(self):
        """The host value (blocks until the card has it), cached."""
        if not self._done:
            t0 = time.perf_counter()
            self._host = _to_host(self._raw)
            self._done = True
            self._raw = None
            self._ready = None
            if self._on_block is not None:
                self._on_block(time.perf_counter() - t0)
                self._on_block = None
        return self._host

    def done(self) -> bool:
        """Non-blocking: True when the value is ready on the card (or
        already on the host)."""
        if self._done or self._ready is None:
            return True
        return bool(self._ready())

    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self) -> int:
        return len(self._shape)

    def item(self):
        return np.asarray(self.result()).item()

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.result(), dtype=dtype)

    def __float__(self):
        return float(self.result())

    def __int__(self):
        return int(self.result())

    def __index__(self):
        return operator.index(self.result())

    def __bool__(self):
        return bool(self.result())

    def __format__(self, spec):
        return format(self.result(), spec)

    def __repr__(self):
        return f"Fetch({self._host!r})" if self._done else \
            "Fetch(<pending>)"

    __hash__ = None

    def _binop(op, swap=False):  # noqa: N805 — descriptor factory
        def fn(self, other):
            if isinstance(other, Fetch):
                other = other.result()
            a = self.result()
            return op(other, a) if swap else op(a, other)
        fn.__name__ = ("__r" if swap else "__") + op.__name__ + "__"
        return fn

    __lt__ = _binop(operator.lt)
    __le__ = _binop(operator.le)
    __gt__ = _binop(operator.gt)
    __ge__ = _binop(operator.ge)
    __eq__ = _binop(operator.eq)
    __ne__ = _binop(operator.ne)
    __add__ = _binop(operator.add)
    __radd__ = _binop(operator.add, swap=True)
    __sub__ = _binop(operator.sub)
    __rsub__ = _binop(operator.sub, swap=True)
    __mul__ = _binop(operator.mul)
    __rmul__ = _binop(operator.mul, swap=True)
    __truediv__ = _binop(operator.truediv)
    __rtruediv__ = _binop(operator.truediv, swap=True)
    del _binop

    def __neg__(self):
        return -self.result()

    def __abs__(self):
        return abs(self.result())


def _feed_nbytes(batch) -> int:
    """A feed's host bytes: the volume the step copies to the card."""
    return sum(int(v.numel() * v.element_size()) if isinstance(
        v, torch.Tensor) else int(getattr(v, "nbytes", 0))
        for v in batch.values())


def _whole_leaf(leaf: snap_lib.Leaf, world) -> torch.Tensor:
    """A state leaf as its whole global array (``_reshard_state``): a
    replicated one as it is held, a split one summed over ``world`` from
    zeros its extents' first holders wrote their parts into."""
    value = leaf.value
    if not isinstance(value, torch.Tensor):
        return torch.from_numpy(np.array(value))
    if leaf.perm is not None:
        value = value.permute(leaf.perm)
    full = [(tuple((0, int(d)) for d in leaf.shape),
             (slice(None),) * len(leaf.shape))]
    if [(e, tuple(i)) for e, i in leaf.pieces] == full \
            and tuple(value.shape) == tuple(leaf.shape):
        return value
    whole = torch.zeros(leaf.shape, dtype=value.dtype, device=value.device)
    if leaf.writes:
        for extent, index in leaf.pieces:
            whole[tuple(slice(a, b) for a, b in extent)] = value[index]
    if world is not None and world.size > 1:
        collectives.all_reduce_(whole, world)
    return whole


def materialize(value):
    """Resolve every ``Fetch`` inside a run() result to its host value."""
    if isinstance(value, Fetch):
        return value.result()
    if isinstance(value, dict):
        return {k: materialize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(materialize(v) for v in value)
    return value


class StepHandle:
    """Returned by ``run_async()``: the step is already dispatched;
    ``result()`` blocks until every fetched value is on the host and
    returns exactly what a blocking ``run()`` would have."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def done(self) -> bool:
        """Non-blocking readiness of every fetch in the result."""
        def ready(v):
            if isinstance(v, Fetch):
                return v.done()
            if isinstance(v, dict):
                return all(ready(x) for x in v.values())
            if isinstance(v, (list, tuple)):
                return all(ready(x) for x in v)
            return True
        return ready(self._value)

    def result(self):
        return materialize(self._value)


class ParallaxSession:
    """One rank's share of training a model. Built by ``parallel_run``;
    the base plan's mesh is built with the session (every rank
    together), the engine (plan, optimizer grouping, step) from the first
    batch."""

    def __init__(self, model: engine_lib.Model, config: ParallaxConfig,
                 num_workers: int = 1, worker_id: int = 0,
                 num_replicas_per_worker: int = 1, seed: int = 0,
                 device="cuda", num_partitions: Optional[int] = None,
                 partition_search: Optional[PartitionSearch] = None):
        self._model = model
        self._config = config
        self.num_workers = num_workers
        self.worker_id = worker_id
        self.num_replicas_per_worker = num_replicas_per_worker
        self._seed = int(seed)
        self._device = resolve_device(device)
        self._num_partitions = num_partitions
        # meshes by shape, each built once on every rank in one order
        # (their process groups are created collectively)
        base = mesh_lib.build_mesh(self._device,
                                   num_partitions=num_partitions)
        self._base_mesh = base
        self._meshes = {(base.repl, base.shard): base}
        self._world = base.size
        # -- planning (parallel/, tune/) ---------------------------------
        # the whole configuration the live engine was built for; every
        # engine-cache key derives from it
        self._plan: Optional[Plan] = None
        self._tune_result: Optional[Dict[str, Any]] = None
        self._search = partition_search
        tc = config.tune_config
        if partition_search is None and tc is not None and tc.enabled:
            # the cost model prices the (dp x tp) x run_option space off
            # the base engine and only top_k plans pay measured trials;
            # PartitionSearch stays the tune_config=None path
            self._search = MeshSearch(self._world, tc,
                                      self._default_plan())
        self._step_times: List[float] = []
        self._last_example_batch = None
        # -- profiling (profiler.py, obs/xprof.py): each stopped window is
        # a pending trace, parsed at the first profile_summary() read
        self._profile = ProfileHook(config.profile_config, worker_id,
                                    self._device)
        self._profile.set_on_stop(self._on_profile_stop)
        self._profile_pending: Optional[tuple] = None
        self._profile_attrib: Optional[Dict[str, Any]] = None
        # -- observability (obs/): one registry for the whole runtime ----
        configure_logging(config.log_level, config.log_json)
        # grow-only: the collector is process-wide
        if config.trace_buffer_events > trace.get_collector().capacity:
            trace.get_collector().set_capacity(config.trace_buffer_events)
        self.metrics = MetricsRegistry()
        self.pipeline_stats = PipelineStats(self.metrics)
        self._steps = self.metrics.counter("session.steps")
        self._wait_ms = self.metrics.histogram("session.data_wait_ms")
        self._engine: Optional[engine_lib.Engine] = None
        self._state: Optional[engine_lib.TrainState] = None
        self._closed = False
        # place_batch may build the engine from a prefetch thread
        self._build_lock = threading.Lock()
        self._prefetcher: Optional[Prefetcher] = None
        # batches consumed, a NaN rollback's skipped ones included: the
        # input position the checkpoint commits (apart from the step)
        self._data_cursor = 0
        # built engines keyed by (plan, bucketed example signature)
        self._engine_cache = compile_cache.EngineCache(self.metrics)
        if config.compilation_cache_dir:
            compile_cache.enable_persistent_cache(
                config.compilation_cache_dir)
        # -- training forensics (obs/timeline, anomaly, flightrec) -------
        # per-step wall-time attribution ring (also the flight
        # recorder's step log)
        self.timeline = StepTimeline(self.metrics,
                                     capacity=config.flight_steps)
        # thread-local pre-dispatch phase scratch (data wait, feed
        # conversion, placement) measured on the dispatching thread
        self._phase = threading.local()
        self.anomaly = AnomalyMonitor(self.metrics, config.anomaly_config,
                                      on_event=self._on_anomaly)
        self._last_host_report: Optional[Dict] = None
        self._flops_resolved = False
        self._last_dispatch_end: Optional[float] = None
        # -- ops observatory (obs/journal, goodput, alerts) ---------------
        # structural killswitch: with PARALLAX_OBS=0 none of the three
        # exists
        import os as _os
        run_epoch = _os.environ.get("PARALLAX_RUN_EPOCH")
        self.journal = (EventJournal(
            capacity=config.journal_capacity, path=config.journal_path,
            max_bytes=config.journal_max_bytes, registry=self.metrics)
            if obs_state.enabled else None)
        self.ledger = (GoodputLedger(
            self.metrics, journal=self.journal,
            run_epoch=float(run_epoch) if run_epoch else None)
            if obs_state.enabled else None)
        # -- checkpoints and recovery (ckpt/) ------------------------------
        self._ckpt = CheckpointHook(config.ckpt_config, worker_id,
                                    registry=self.metrics,
                                    journal=self.journal)
        self._rollback_hooks: List[Any] = []
        self._recovery = (RecoveryPolicy(
            config.recovery_config, registry=self.metrics,
            on_rollback=self._fire_rollback_hooks)
            if config.recovery_config.enabled else None)
        self.flight = FlightRecorder(
            flight_dir=config.flight_dir, registry=self.metrics,
            journal=self.journal,
            providers={
                "progress": lambda: {"host_step": self._host_step()},
                "steps": self.timeline.rows,
                "goodput": self._goodput_for_dump,
                "anomalies": lambda: self.anomaly.events(),
                "health": self._health_for_dump,
                "host_report": lambda: self._last_host_report,
                "metrics": self.metrics_snapshot,
                "device_memory": device_memory_stats,
                "config": self._config_summary,
                "ckpt": self._ckpt.stats,
                "recovery": (self._recovery.stats
                             if self._recovery is not None
                             else lambda: None),
                "tune": lambda: self._tune_result,
                "profile": self._profile_for_dump,
            })
        # -- the memory watch (obs/memwatch): a live ring sampled after
        # each dispatch, per-card gauges, the oom_risk incident
        self.memwatch = memwatch_lib.MemWatch(
            self.metrics, flight=self.flight, capacity=config.flight_steps)
        self.flight.add_provider("memwatch", self.memwatch.stats)
        if self.journal is not None:
            # every incident artifact embeds its own causal history
            self.flight.add_provider(
                "journal_tail", lambda: self.journal.tail(64))
        if self.ledger is not None:
            self.flight.add_provider(
                "ops", lambda: self.ledger.account(self.timeline))
        self.alerts = (AlertEngine(
            self.metrics,
            rules=(builtin_rules(config.goodput_floor)
                   + tuple(config.alert_rules)),
            journal=self.journal, flight=self.flight,
            interval_s=config.alert_interval_s)
            if obs_state.enabled else None)
        if self.alerts is not None:
            self.flight.add_provider("alerts", self.alerts.summary)
        self._register_profile_gauges()
        self.health = (HealthMonitor(
            self.metrics, on_nonfinite=self._on_nonfinite,
            on_reading=self._on_health_reading)
            if config.monitor_health else None)
        # -- numerics observatory (obs/numwatch): constructed only when
        # enabled AND obs is on, matching the engine's build-time gate
        self.numerics = (numwatch_lib.NumericsMonitor(
            self.metrics, config.numerics_interval, anomaly=self.anomaly)
            if config.numerics_interval > 0 and obs_state.enabled
            else None)
        # the last dispatched step's inputs, kept one step for NaN
        # provenance
        self._numerics_last_batch: Optional[tuple] = None
        # where a forced trip tree took its pre-step parameters from
        self._forced_basis: Optional[Dict] = None
        self._drift_sentinels: Optional[List] = None
        self._drift_results: Optional[List[Dict]] = None
        if self.numerics is not None:
            self.flight.add_provider("numerics", self._numerics_for_dump)
        self._metrics_sink = (
            JsonlSink(self.metrics, config.metrics_path,
                      config.metrics_interval_s,
                      snapshot_fn=self.metrics_snapshot,
                      max_bytes=config.metrics_max_bytes)
            if config.metrics_path else None)
        self._sigterm_installed = False
        self._prev_sigterm = None
        self._install_preemption_handler()

    # -- feeds and fetches ------------------------------------------------

    def _host_feed(self, feed_dict: Dict[str, Any]) -> Dict[str, Any]:
        """The feed as one host array (or tensor) per name."""
        batch = {}
        for name, value in feed_dict.items():
            if isinstance(value, (list, tuple)):
                if len(value) != self.num_replicas_per_worker:
                    raise ValueError(
                        f"feed {name!r}: got a list of {len(value)} arrays "
                        f"but num_replicas_per_worker="
                        f"{self.num_replicas_per_worker} (reference "
                        f"contract: one array per local replica)")
                value = np.concatenate([np.asarray(v) for v in value],
                                       axis=0)
            # float64 runs as float32, as the JAX session's jitted step
            # runs it with x64 off (parallax_tpu/session.py:1944-1958);
            # integer feeds keep their dtype (torch indexes with int64)
            if isinstance(value, torch.Tensor):
                if value.dtype == torch.float64:
                    value = value.float()
            else:
                value = np.asarray(value)
                if value.dtype == np.float64:
                    value = value.astype(np.float32)
            batch[name] = value
        # a replan builds the next engine from the last feed
        self._last_example_batch = batch
        return batch

    def _convert_feed(self, feed_dict: Dict[str, Any],
                      static: bool = True):
        """The feed bucketed and on the card (in the step's static input
        buffers when ``static`` and steps replay graphs). The conversion
        and the placement are this thread's pre-dispatch phases of the
        next step (obs/timeline.py)."""
        t0 = time.perf_counter()
        host = self._host_feed(feed_dict)
        self._ensure_engine(host)
        t1 = time.perf_counter()
        placed = self._engine.place(host, static=static)
        if static:
            self.pipeline_stats.record_h2d(_feed_nbytes(host))
            self._phase.convert_s = t1 - t0
            self._phase.h2d_s = time.perf_counter() - t1
        return placed

    def _ensure_engine(self, batch) -> None:
        if self._closed:
            raise RuntimeError("ParallaxSession is closed")
        if self._engine is not None:
            return
        with self._build_lock:
            if self._engine is not None:
                return
            self._build_engine(batch, self._num_partitions)
            # restore inside the lock: a thread that lost the race must
            # not run on the state before the restore
            if self._ckpt.restore(self._state_leaves()) is not None:
                self._apply_restored_extras()
            else:
                self._data_cursor = self._state.step
            if self._recovery is not None:
                # a NaN on the first steps already has a rollback target
                self._recovery.maybe_snapshot(self._state.step,
                                              self._state_leaves(),
                                              force=True)

    def _state_leaves(self) -> List[snap_lib.Leaf]:
        """The state's checkpoint leaves (live tensors, JAX's names)."""
        return snap_lib.state_leaves(self._state, self._engine)

    def _apply_restored_extras(self) -> None:
        """The exact-resume closure beyond the state (its step and seed
        came with its leaves): the data cursor, the detectors'
        baselines, the health accounting and the goodput account."""
        extras = self._ckpt.restored_extras
        self._data_cursor = int(extras.get("data_cursor", self._state.step))
        info = self._ckpt.last_restore_info or {}
        self.anomaly.restore_snapshot(extras.get("anomaly"))
        if self.health is not None:
            self.health.restore_snapshot(extras.get("health"))
        if self.ledger is not None:
            # the previous attempt's account; the restore's wall books
            # as restore_replay and the gap since its save as
            # eviction_downtime
            self.ledger.restore_snapshot(
                extras.get("ops"),
                restore_s=self._ckpt.last_restore_seconds or 0.0)
        parallax_log.info("restored checkpoint at step %d (data cursor %d)",
                          self._state.step, self._data_cursor)
        if info.get("fallbacks") or info.get("torn_steps"):
            parallax_log.warning("checkpoint restore fell back: %s", info)
            if self.journal is not None:
                self.journal.emit("ckpt", "torn_fallback",
                                  severity="warning", **dict(info))
            self.flight.trigger("ckpt_torn", dict(info))
        if self.journal is not None:
            self.journal.emit(
                "ckpt", "restored", severity="info",
                step=self._state.step, data_cursor=self._data_cursor,
                restore_s=round(self._ckpt.last_restore_seconds or 0.0, 4))
        self.flight.trigger(
            "resume", {"step": self._state.step,
                       "data_cursor": self._data_cursor,
                       "restore": dict(info)})

    @property
    def mesh(self) -> mesh_lib.Mesh:
        """The live engine's mesh (the base plan's before the first
        build)."""
        return self._engine.mesh if self._engine is not None \
            else self._base_mesh

    def _mesh_for(self, shape) -> mesh_lib.Mesh:
        """The mesh of ``shape``, built once: every rank reaches each
        build in the same order (the base plan, then the search's
        candidates in its order), as its process groups need."""
        key = tuple(int(d) for d in shape)
        mesh = self._meshes.get(key)
        if mesh is None:
            mesh = mesh_lib.build_mesh(self._device, shape=key)
            self._meshes[key] = mesh
        return mesh

    def _default_plan(self, num_partitions: Optional[int] = None) -> Plan:
        """The config's own configuration as a Plan: ``num_partitions``
        (snapped to a divisor of the rank count, as ``build_mesh`` snaps
        it) is the shard-axis width."""
        n = self._world
        tp = mesh_lib.snap_to_divisor(
            num_partitions if num_partitions else n, n)
        ps = self._config.communication_config.ps_config
        return Plan(dp=n // tp, tp=tp, run_option=self._config.run_option,
                    sync=self._config.sync,
                    local_aggregation=ps.local_aggregation)

    def _engine_config(self, plan: Plan) -> ParallaxConfig:
        """The config a ``plan``'s engine builds with: the session config
        with the plan's run options (the same object when they match)."""
        import dataclasses as _dc
        cfg = self._config
        ps = cfg.communication_config.ps_config
        if (plan.run_option == cfg.run_option and plan.sync == cfg.sync
                and plan.local_aggregation == ps.local_aggregation):
            return cfg
        comm = _dc.replace(
            cfg.communication_config,
            ps_config=_dc.replace(ps,
                                  local_aggregation=plan.local_aggregation))
        return _dc.replace(cfg, run_option=plan.run_option,
                           sync=plan.sync, communication_config=comm)

    def _build_engine(self, example_batch, plan_or_partitions=None) -> None:
        """Build (or take from the cache) the engine of a plan, or of
        the default plan at ``plan_or_partitions`` shard columns, and move
        the state onto it. Under a mesh search the first build prices the
        plan space off this engine and switches to the shortlist's first
        candidate (the base engine stays cached)."""
        example = self._bucketed_example(example_batch)
        if isinstance(plan_or_partitions, Plan):
            plan = plan_or_partitions.validate_for(self._world)
        else:
            plan = self._default_plan(plan_or_partitions)
        old = self._engine
        engine = self._engine_for_plan(plan, example)
        self._engine = engine
        self._plan = plan
        if isinstance(self._search, MeshSearch) \
                and not self._search.started:
            # the whole plan space priced off this engine's meta-tensor
            # counts; a calibration file replaces the nominal exchange
            # rates, and the OOM preflight screens the shortlist before
            # any candidate pays a trial
            cal = calibrate_lib.ratios(calibrate_lib.load(
                self._config.calibration_path))
            self._search.set_preflight(
                lambda p: self._preflight_peak(p, example))
            first = self._search.begin(tune_costmodel.inputs_from_engine(
                engine, self._config.tune_config, calibration=cal))
            if first.cache_key() != plan.cache_key():
                parallax_log.info(
                    "mesh search: first trial %s (base plan %s kept "
                    "cached)", first.describe(), plan.describe())
                self._build_engine(example_batch, first)
                return
        if self._state is None:
            # a preflight captured this engine on a fresh state, left
            # bitwise as init_state made it: keep it and its graphs
            self._state = engine._captured_state \
                if engine._captured_state is not None \
                else engine.init_state(self._seed)
        elif engine is not old:
            # the reference relaunches the cluster (partitions.py:74-138);
            # here the live state moves onto the new plan's layout
            self._state = self._reshard_state(
                self._state, old, engine, into=engine._captured_state)
            if self._recovery is not None:
                # the last-good snapshot holds the old layout's tensors
                self._recovery.maybe_snapshot(self._state.step,
                                              self._state_leaves(),
                                              force=True)

    def _engine_for_plan(self, plan: Plan, example) -> engine_lib.Engine:
        """Get or build the engine of one plan: the cache key is the
        whole plan plus the bucketed example's signature, so a replan
        back onto a measured candidate is a lookup (its captured graphs
        kept). Shared by the build path and the OOM preflight."""
        key = plan.cache_key() + (
            bucketing.batch_signature(engine_lib._to_meta(example)),)
        engine = self._engine_cache.get(key)
        if engine is None:
            engine = engine_lib.Engine(
                self._model, self._mesh_for(plan.mesh_shape()),
                self._engine_config(plan), example, metrics=self.metrics)
            self._engine_cache.put(key, engine)
        return engine

    def _preflight_peak(self, plan: Plan, example) -> Optional[int]:
        """The OOM preflight's probe: the captured step's pool bytes of
        ``plan`` (``memwatch.compiled_step_memory``). Builds the
        candidate's engine through the cache and captures its step on a
        fresh state (the capture leaves it bitwise as ``init_state``
        made it), which its trial then reuses. None where steps are not
        captured (the CPU): the plan passes, refusal needs evidence."""
        engine = self._engine_for_plan(plan, example)
        if not engine._captures():
            return None
        state = engine._captured_state
        if state is None:
            state = engine.init_state(self._seed)
        engine._compile(state, bucketing.batch_signature(
            engine_lib._to_meta(engine.bucket(example))))
        m = memwatch_lib.compiled_step_memory(engine)
        return int(m["peak_bytes"]) if m else None

    def _reshard_state(self, state, old, new, into=None):
        """``state`` (laid out for engine ``old``) on engine ``new``'s
        layout: every leaf of the state (parameters, optimizer slots,
        slice and pending state, model state, the step and the seed, by
        the checkpoint's names) assembled whole over the old mesh — a
        split leaf by each extent's first holder writing its part into
        zeros and a sum over the ranks — then each rank's part of it
        copied into ``into`` (a state of ``new``'s layout, in place, so
        graphs captured on it stay valid) or into a fresh one.
        Collective: every rank calls it."""
        target = into if into is not None else new.init_state(self._seed)
        want = {leaf.name: leaf
                for leaf in snap_lib.state_leaves(target, new)}
        world = old.mesh.world
        with torch.no_grad():
            for leaf in snap_lib.state_leaves(state, old):
                dst = want.pop(leaf.name, None)
                if dst is None:
                    raise ValueError(
                        f"replan: state leaf {leaf.name!r} has no place "
                        f"on plan {self._plan.describe()}")
                dst.assign(_whole_leaf(leaf, world))
        if want:
            raise ValueError(f"replan: state leaves {sorted(want)} of plan "
                             f"{self._plan.describe()} have no source")
        return target

    def _bucketed_example(self, example_batch):
        """The example batch as the engine will see it: bucketed when
        ``Config.shape_buckets`` is declared (buckets from the live
        engine when there is one, so 'auto' stays pinned to the first
        batch)."""
        cfg = self._config
        if cfg.shape_buckets is None:
            return example_batch
        buckets = self._engine._buckets if self._engine is not None \
            else None
        if buckets is None:
            lead = bucketing._leading_dim(example_batch)
            buckets = bucketing.resolve_buckets(cfg.shape_buckets,
                                                lead if lead else 1)
        return bucketing.bucket_batch(example_batch, buckets,
                                      cfg.bucket_mask_feed)[0]

    def _ready_fn(self):
        if self._device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event.query

    def _convert_fetch(self, fetches, outputs, lazy: bool = True,
                       step: Optional[int] = None):
        ready = self._ready_fn()
        on_block = None
        if lazy and step is not None:
            def on_block(seconds, _step=step):
                self.timeline.add_fetch_block(_step, seconds)

        def one(name):
            if name not in outputs:
                raise KeyError(f"fetch {name!r} unknown; available: "
                               f"{sorted(outputs)}")
            f = Fetch(outputs[name], ready, on_block)
            return f if lazy else f.result()

        if fetches is None:
            return {k: one(k) for k in outputs}
        if isinstance(fetches, str):
            return one(fetches)
        return [one(f) for f in fetches]

    # -- running ----------------------------------------------------------

    def _run_step(self, fetches, batch, force_lazy: bool = False):
        """Dispatch one step on a placed batch; shared by run, run_async
        and run_iter. Around the engine's step: the timeline row, the
        ledger, the detectors, the memory sample, the numerics sample,
        recovery, the health readings, the checkpoint and the alert
        poll (the JAX session's per-step block)."""
        step = self._state.step
        # this thread's pre-dispatch phases (run_iter's wait, the feed
        # conversion and placement run()/run_async() paid)
        ph = self._phase
        data_wait_s = getattr(ph, "data_wait_s", 0.0)
        convert_s = getattr(ph, "convert_s", 0.0)
        h2d_pre_s = getattr(ph, "h2d_s", 0.0)
        ph.data_wait_s = ph.convert_s = ph.h2d_s = 0.0
        # a window never opens on a step that captures a graph: it is
        # deferred to the next step (profiler.py)
        self._profile.before_step(step, self._engine.step_captures(
            self._state, batch))
        t0 = time.perf_counter()
        gap = (None if self._last_dispatch_end is None
               else t0 - self._last_dispatch_end)
        blocked_s = 0.0
        # a search trial's time must cover the device's work: it blocks
        # on its outputs (a profiled step need not: the profile hook
        # synchronizes before it stops)
        blocking = (self._search is not None
                    or (self._config.eager_fetch and not force_lazy))
        lazy = not blocking
        try:
            with trace.span("session.dispatch", step=step):
                self._state, outputs = self._engine.step(self._state, batch)
                if not lazy:
                    tb = time.perf_counter()
                    outputs = {k: (v if k == "numerics" else _to_host(v))
                               for k, v in outputs.items()}
                    blocked_s = time.perf_counter() - tb
                    self.pipeline_stats.record_blocked(blocked_s)
        except Exception as e:
            # post-mortem without rerunning; the exception propagates
            self.flight.trigger(
                f"exception:{type(e).__name__}",
                {"step": step, "error": f"{type(e).__name__}: {e}"})
            raise
        now = time.perf_counter()
        dt = now - t0
        self._last_dispatch_end = now
        self._steps.inc()
        self.pipeline_stats.record_dispatch(gap, dt)
        # wall = dispatch end to dispatch end; the first step has no
        # previous dispatch, so its wall is its own measured pre-phases
        # plus its dispatch
        wall_s = (gap if gap is not None
                  else data_wait_s + convert_s + h2d_pre_s) + dt
        row = self.timeline.record_step(
            step, t0, wall_s, data_wait_s=data_wait_s,
            convert_s=convert_s, h2d_s=0.0, dispatch_s=dt,
            fetch_block_s=blocked_s, h2d_pre_s=h2d_pre_s)
        if self.ledger is not None:
            self.ledger.on_step(row)
        self.anomaly.observe("step_time_ms", step, wall_s * 1e3)
        # the allocator's counters after the dispatch (never inside a
        # capture: the step has returned)
        self.memwatch.sample(step)
        self._profile.after_step(step)
        self._data_cursor += 1
        # recovery reads this step's health scalars (blocking, the
        # documented recovery trade)
        kind = self._trip_kind(outputs) if self._recovery is not None \
            else None
        if self.numerics is not None:
            self._numerics_last_batch = (step, self._engine.last_inputs)
            nm = outputs.get("numerics")
            if kind is not None and nm is not None and float(
                    nm.get(numwatch_lib.SAMPLED_KEY, 0.0)) < 0.5:
                # the JAX step forces the sample on a trip; here the
                # trip step's stats are computed after it. Guarded:
                # forensics must never break the recovery they decorate
                try:
                    outputs["numerics"] = self._forced_numerics()
                except Exception as e:
                    parallax_log.warning(
                        "numerics: the trip step's stats failed: %s", e)
            self.numerics.observe(step, outputs.get("numerics"))
            di = self._config.numerics_drift_interval
            if di and step and step % di == 0:
                self._run_drift_sentinels_guarded(step)
        if self._recovery is not None:
            self._maybe_recover(step, outputs, kind)
        if self.health is not None:
            # lazy: pinned copies behind an event; only completed ones
            # are read, so the dispatch thread never blocks on them
            self.health.observe(step, *host_fields(
                outputs.get("loss_finite"), outputs.get("grad_norm"),
                outputs.get("loss")))
        t_ck = time.perf_counter()
        if self._ckpt.maybe_save(self._state.step, self._state_leaves,
                                 extras_fn=self._ckpt_extras):
            if self.ledger is not None:
                # the save's wall lands inside the next step's dispatch
                # gap too: carved out of productive, not counted twice
                self.ledger.note_badput(
                    "ckpt_stall", time.perf_counter() - t_ck,
                    carve_from_productive=True)
        if self.alerts is not None:
            self.alerts.poll()
        if self._search is not None:
            self._record_search_time(dt)
        return self._convert_fetch(fetches, outputs, lazy=lazy, step=step)

    def prepare(self, feed_dict: Dict[str, Any]) -> int:
        """Build the engine and the state from an example batch (and
        restore a configured checkpoint into it) without running a step;
        returns the global step (0 on a fresh run, the restored step on a
        resumed one)."""
        self._ensure_engine(self._host_feed(feed_dict))
        return int(self._state.step)

    def run(self, fetches: Union[None, str, Sequence[str]] = None,
            feed_dict: Optional[Dict[str, Any]] = None):
        if feed_dict is None:
            raise ValueError(
                "ParallaxSession.run requires feed_dict (the batch)")
        return self._run_step(fetches, self._convert_feed(feed_dict))

    def run_async(self, fetches: Union[None, str, Sequence[str]] = None,
                  feed_dict: Optional[Dict[str, Any]] = None) -> StepHandle:
        """``run()`` with the future made explicit: dispatches one step and
        returns a ``StepHandle`` at once; ``handle.result()`` blocks until
        the fetches are on the host and returns what ``run()`` would.
        Ignores ``eager_fetch``."""
        if feed_dict is None:
            raise ValueError(
                "ParallaxSession.run_async requires feed_dict (the batch)")
        return StepHandle(self._run_step(
            fetches, self._convert_feed(feed_dict), force_lazy=True))

    def place_batch(self, feed_dict: Dict[str, Any]):
        """Convert one feed dict (per-replica lists, bucketing) and stage
        it on the card: everything ``run()`` does before the step, without
        the step. Safe from a background thread; builds the engine on
        first use. Feed the result to ``run_iter(..., placed=True)``.
        On the card the batch takes a slot of the engine's staging ring,
        pinned host and device buffers that stay allocated for reuse: the
        ring grows to the most placed batches held unstepped at once."""
        host = self._host_feed(feed_dict)
        self._ensure_engine(host)
        self.pipeline_stats.record_h2d(_feed_nbytes(host))
        return self._engine.stage(host)

    def run_iter(self, batches: Iterable[Dict[str, Any]],
                 fetches: Union[None, str, Sequence[str]] = None,
                 placed: bool = False, skip: Union[int, str] = 0):
        """Pipelined training loop: yields one ``run()`` result per feed
        dict of ``batches``, in order, with the conversion, bucketing and
        staging of batch t+1 on a background thread (depth
        ``Config.prefetch_depth``) while step t runs; the same losses, bit
        for bit, as the sequential loop. Exceptions from the iterator or
        the prefetch thread surface at the step that would have consumed
        the failed batch; closing the generator (or ``close()``) stops the
        thread.

        ``placed=True`` treats each item as already placed by
        ``place_batch`` (``data.prefetch_to_device(batches,
        session.place_batch)``). ``skip`` fast-forwards that many items
        before the first step: rebuild the same stream and pass
        ``skip=session.data_cursor`` (or ``"auto"``, which reads the
        restored cursor after ``prepare()``) to resume a run exactly."""
        if skip == "auto":
            if self._engine is None:
                # the cursor is known only after the checkpoint restore
                raise ValueError(
                    "run_iter(skip='auto') before the engine exists: the "
                    "restored data cursor is only known after the "
                    "checkpoint restore — call prepare(example_feed) "
                    "first (or pass an explicit skip count)")
            skip = self._data_cursor
        if placed and self._search is not None:
            # a replan would move the state to engines the placed
            # batches were not staged for
            raise ValueError(
                "run_iter(placed=True) cannot run while an auto-search "
                "(partition or mesh) is live: a replan would invalidate "
                "already-placed batches. Finish the search first (or "
                "disable search_partitions / tune_config).")
        it = iter(batches)
        if int(skip):
            # synchronous: a bad cursor raises at the call site
            it = skip_items(it, int(skip))
        return self._run_iter_gen(it, fetches, placed)

    def _next_timed(self, it):
        """``next(it)``, the wait recorded as the step's data wait
        (``session.data_wait_ms``); StopIteration propagates."""
        t0 = time.perf_counter()
        with trace.span("session.data_wait"):
            item = next(it)
        wait = time.perf_counter() - t0
        self._wait_ms.record(wait * 1e3)
        self._phase.data_wait_s = wait
        return item

    def _run_iter_gen(self, it, fetches, placed):
        if placed:
            while True:
                try:
                    batch = self._next_timed(it)
                except StopIteration:
                    return
                if self._engine is None:
                    raise ValueError(
                        "run_iter(placed=True) got a batch but no engine "
                        "exists: place batches via session.place_batch "
                        "(which builds it) or call prepare(example_feed) "
                        "first")
                yield self._run_step(fetches, batch)
        # sequential while a search may replan (staged batches belong to
        # the engine that staged them)
        while self._search is not None:
            try:
                feed = next(it)
            except StopIteration:
                return
            yield self._run_step(fetches, self._convert_feed(feed))
        prefetcher = Prefetcher(it, self.place_batch,
                                depth=int(self._config.prefetch_depth),
                                name="parallax-feed-prefetch")
        self._prefetcher = prefetcher
        try:
            while True:
                try:
                    batch = self._next_timed(prefetcher)
                except StopIteration:
                    break
                yield self._run_step(fetches, batch)
        finally:
            prefetcher.close()
            if self._prefetcher is prefetcher:
                self._prefetcher = None

    def evaluate(self, feed_dict: Dict[str, Any], fetches="loss"):
        """A held-out loss (and metrics) on ``feed_dict``: the forward
        with no gradient and no update."""
        batch = self._convert_feed(feed_dict, static=False)
        loss, metrics = self._engine.evaluate(self._state, batch)
        return self._convert_fetch(fetches, {"loss": loss, **metrics})

    # -- compile-ahead engine (compile/) ----------------------------------

    def warmup(self, feed_dict: Optional[Dict[str, Any]] = None,
               batch_sizes: Optional[Sequence[int]] = None,
               background: bool = False) -> Dict[int, float]:
        """Capture the step's graph for every declared batch bucket
        (``Config.shape_buckets``), or explicit ``batch_sizes``, ahead of
        step 0, so the first step of each bucket replays a ready graph.
        The state is left bitwise as it was. Returns {batch_size:
        seconds}. On the CPU there is nothing to capture: the signatures
        are registered and the steps run eagerly.

        ``feed_dict``: an example feed to build the engine from when it
        does not exist yet (``prepare(feed_dict)`` first).
        ``background=True`` is refused: a capture from a second thread
        would race the training stream for the card (the capture's own
        eager step and the graph's pool share the device with the steps
        the loop dispatches meanwhile)."""
        if background:
            raise NotImplementedError(
                "warmup(background=True) is not ported: capturing the "
                "step's CUDA graph on a second thread would race the "
                "training loop on the card; warm up before the loop")
        if feed_dict is not None:
            self.prepare(feed_dict)
        if self._engine is None:
            raise ValueError(
                "warmup needs an engine: pass feed_dict (or call "
                "prepare(example_feed)) first")
        t0 = time.perf_counter()
        with trace.span("session.warmup"):
            stats = self._engine.warmup(self._state, batch_sizes)
        if self.ledger is not None:
            # captures ahead of step 0 are the compile/warmup badput
            self.ledger.note_badput("compile_warmup",
                                    time.perf_counter() - t0)
        # the step's FLOPs (MFU in the timeline) and the graphs' pool
        # bytes are known from here on
        self._ensure_flops()
        self.memwatch.capture_compiled(self._engine)
        return stats

    def compile_stats(self) -> Dict[str, Any]:
        """JSON-ready compile/caching report, with the JAX session's keys:
        declared bucket sizes, per-bucket warmup seconds, and the
        executable (captured graph) and engine cache hit and miss
        counters. An engine whose steps run eagerly because a declared
        ``dedup_capacity`` guards a lookup adds ``eager_steps``, which
        says why (the JAX package has no such case: its guard is a
        ``lax.cond`` inside the compiled step)."""
        eng = self._engine
        stats = {
            "shape_buckets": (list(eng._buckets)
                              if eng is not None and eng._buckets
                              else None),
            "warmup_compile_seconds": (
                {str(k): round(v, 3)
                 for k, v in sorted(eng.warmup_seconds.items())}
                if eng is not None else {}),
            "executable_cache": {
                "hits": self.metrics.counter(
                    "engine.executable_cache.hits").value,
                "misses": self.metrics.counter(
                    "engine.executable_cache.misses").value,
            },
            "engine_cache": {
                "hits": self.metrics.counter(
                    "session.engine_cache.hits").value,
                "misses": self.metrics.counter(
                    "session.engine_cache.misses").value,
            },
        }
        if eng is not None and eng._numerics:
            # the numerics observatory's second graph a signature
            stats["numerics_graphs"] = {
                "captures": len(eng.captured_graphs(numerics=True)),
                # by batch size, as warmup_compile_seconds
                "capture_seconds": {
                    str(sig[0][1][0]): round(v, 3)
                    for sig, v in eng.numerics_capture_seconds.items()},
            }
        if eng is not None and eng._guarded:
            stats["eager_steps"] = (
                f"dedup_capacity guards the lookups of {eng._guarded}: "
                f"each step reads the overflow flag on the host")
        return stats

    def gather_params(self):
        """The parameter tree with every row-sharded and tensor-parallel
        leaf gathered whole in the JAX layout, on this rank's device (a
        collective: every rank calls it)."""
        if self._engine is None:
            raise ValueError("gather_params needs a built engine: run a "
                             "step or prepare(example_feed) first")
        return self._engine.gather_params(self._state)

    def sparse_wire_bytes_per_step(self) -> Dict[str, Any]:
        """The engine's wire-byte accounting of the last traced step
        (``Engine.sparse_wire_bytes_per_step``)."""
        if self._engine is None:
            raise RuntimeError("sparse_wire_bytes_per_step() called before "
                               "any step was traced; run a step first")
        return self._engine.sparse_wire_bytes_per_step()

    # -- online serving (serve/) ------------------------------------------

    def serve(self, infer_fn=None, program=None, **kw):
        """Put the trained parameters behind a request queue: a
        :class:`~parallax_tpu_torch.serve.session.ServeSession` on this
        session's device, sharing its metrics registry (``serve.*``
        next to ``session.*``), serving ``gather_params()`` (copied on
        the device into the serve session's own leaves). Pass
        ``infer_fn(params, batch)`` for one-shot inference (plus
        ``example_feed=``) or ``program=`` for continuous decode;
        remaining kwargs forward to ``ServeSession``. Serving knobs come
        from this session's ``Config.serve_config``. Requires a built
        engine (``prepare(example_feed)`` or any step first)."""
        from parallax_tpu_torch.serve import ServeSession
        if self._engine is None:
            raise ValueError(
                "serve() needs a built engine: call "
                "prepare(example_feed) (or run a step) first")
        kw.setdefault("device", self._device)
        kw.setdefault("flight", self.flight)
        return ServeSession(infer_fn, self.gather_params(),
                            program=program, config=self._config,
                            metrics=self.metrics, **kw)

    def push_weights(self, fleet) -> dict:
        """Train -> serve continuous deployment: hot-swap this session's
        trained parameters into every replica of a
        :class:`~parallax_tpu_torch.serve.fleet.ServeFleet`. The fleet
        rotates replicas out one at a time (drain -> swap -> re-admit),
        so traffic keeps flowing, and each swap copies into the replica's
        own leaves in place, so nothing is captured again. Returns the
        per-replica outcome map."""
        if self._engine is None:
            raise ValueError(
                "push_weights() needs a built engine: call "
                "prepare(example_feed) (or run a step) first")
        return fleet.push_weights(self.gather_params())

    # -- planning (parallel/, tune/) --------------------------------------

    @property
    def plan(self) -> Optional[Plan]:
        """The whole configuration the live engine was built for (mesh
        shape and run options), or None before the engine exists."""
        return self._plan

    def tune_summary(self) -> Optional[Dict[str, Any]]:
        """The mesh auto-tuner's decision record once the search has
        settled (candidates enumerated and pruned, each trial's
        predicted and measured ms, the winner's ratio, the cost basis:
        ``tune.MeshSearch.summary``), else None. Also the flight
        recorder's ``tune`` section."""
        return self._tune_result

    def _record_search_time(self, dt: float) -> None:
        """One step of the live trial: at the end of its window, its
        time (the median of the trial window under ``MeshSearch``, the
        mean of steps ``[50, 100)`` under ``PartitionSearch``, averaged
        over the ranks so every rank decides alike) goes to the search,
        and the session replans onto the next candidate or the
        winner."""
        self._step_times.append(dt)
        mesh_search = isinstance(self._search, MeshSearch)
        if mesh_search:
            warm, test = (self._search.trial_warmup,
                          self._search.trial_steps)
        else:
            warm = consts.NUM_ITERATIONS_FOR_WARMUP
            test = consts.NUM_ITERATIONS_FOR_TEST
        if len(self._step_times) < test:
            return
        if mesh_search:
            # the median: a trial window is short, and one host stall in
            # it would misrank near-tied plans
            mean_t = float(np.median(self._step_times[warm:test]))
        else:
            mean_t = float(np.mean(self._step_times[warm:test]))
        self._step_times = []
        world = self.mesh.world
        if world is not None and world.size > 1:
            # every rank must take the same replan (the reference's
            # get_average_execution_time, lib.py:211-256)
            t = torch.tensor([mean_t], dtype=torch.float64,
                             device=self._device)
            collectives.all_reduce_(t, world)
            mean_t = float(t[0]) / world.size
        if mesh_search:
            nxt = self._search.report(self._plan, mean_t)
        else:
            nxt = self._search.report(self._engine.mesh.shard, mean_t)
        if nxt is not None:
            parallax_log.info(
                "auto-search: trying %s",
                nxt.describe() if isinstance(nxt, Plan) else f"p={nxt}")
            self._build_engine_from_live(nxt)
            return
        if mesh_search:
            best = self._search.best_plan()
            self._tune_result = self._search.summary()
            parallax_log.info("mesh search done: winner %s (%s)",
                              best.describe(),
                              self._tune_result.get("winner"))
            if self.journal is not None:
                r = self._tune_result
                self.journal.emit(
                    "tune", "decision", winner=r.get("winner"),
                    trials_measured=r.get("trials_measured"),
                    pruned_oom=r.get("pruned_oom"),
                    cost_basis=r.get("cost_basis"))
                for refusal in (r.get("oom_refusals") or ()):
                    self.journal.emit(
                        "tune", "oom_refusal", severity="warning",
                        **{k: refusal[k] for k in list(refusal)[:6]})
            self.flight.trigger("tune_decision", self._tune_result)
            settled = best.cache_key() == self._plan.cache_key()
        else:
            best = self._search.best_partitions()
            parallax_log.info(
                "partition search done: best num_partitions=%d", best)
            settled = best == self._engine.mesh.shard
        self._search = None
        if not settled:
            # the winner was built, captured and measured as a candidate:
            # a cache hit
            self._build_engine_from_live(best)
        # the losing candidates' engines (and their graphs) are
        # unreachable by any replan now
        dropped = self._engine_cache.prune(keep=self._engine)
        if dropped:
            parallax_log.info("auto-search: dropped %d losing candidate "
                              "engine(s) from the cache", dropped)

    def _build_engine_from_live(self, plan_or_partitions) -> None:
        p = plan_or_partitions
        label = p.describe() if isinstance(p, Plan) else p
        with trace.span("partition.replan", plan=label):
            self._build_engine(self._last_example_batch, p)

    # -- profiling (profiler.py, obs/xprof.py) ----------------------------

    def profile_steps(self, n: int,
                      outdir: Optional[str] = None) -> Optional[str]:
        """Arm a ``torch.profiler`` window over the next ``n`` steps;
        returns the capture directory (None on a rank the
        ``ProfileConfig.profile_worker`` gating excludes). A step that
        captures a graph defers the window by one step; on the card the
        window's first step warms the tracing up and the n after it are
        traced (profiler.py). The window's steps run as the loop runs
        them (the JAX session blocks each); the hook synchronizes before
        it stops, so the trace holds all they launched. Once the window
        closes, ``profile_summary()`` parses it. ``outdir``
        defaults under ``profile_dir`` when configured, else a fresh
        temporary directory."""
        import os as _os
        import tempfile
        # gated and validated before a directory is made: an excluded
        # rank (or a second call mid-capture) must not leak one
        if not self._profile.worker_enabled:
            return None
        if self._profile.capture_busy:
            raise RuntimeError(
                "a profile capture is already armed/in flight; wait "
                "for it to finish before requesting another window")
        if int(n) < 1:
            raise ValueError(
                f"profile window must cover >= 1 step, got {n}")
        step = self._host_step()
        if outdir is None:
            base = self._config.profile_config.profile_dir
            if base:
                outdir = _os.path.join(base, f"window_step{step}")
            else:
                outdir = tempfile.mkdtemp(prefix="parallax-xprof-")
        ok = self._profile.request_window(step, n, outdir)
        return outdir if ok else None

    def _on_profile_stop(self, trace_dir: str, steps: int) -> None:
        """ProfileHook callback (dispatch thread): note the pending
        capture; the parse happens at the first profile_summary()."""
        self._profile_pending = (trace_dir, int(steps))
        parallax_log.info(
            "profile window complete: %d step(s) captured in %s "
            "(profile_summary() parses it)", steps, trace_dir)

    def profile_summary(self) -> Optional[Dict[str, Any]]:
        """The latest window's measured attribution (``obs.xprof.
        Attribution.as_dict()``: category shares, collectives, top ops
        with their scope and dense-sparse split, the residual and the
        coverage), parsing a pending trace first. Each kernel is joined
        to its source scope through ``Engine.scope_index`` (an eager
        window carries its scopes itself). None before any window
        completed; a trace that cannot be read gives ``{"error": ...}``.
        On the card a trace with no device kernel raises: an empty
        attribution is no result."""
        pending, self._profile_pending = self._profile_pending, None
        if pending is None:
            return self._profile_attrib
        path, steps = pending
        try:
            doc, tpath = xprof.load_trace(path)
        except (OSError, ValueError) as e:
            parallax_log.warning("profile trace unreadable: %s", e)
            self._profile_attrib = {
                "error": f"{type(e).__name__}: {e}", "source": path}
            return self._profile_attrib
        if self._device.type == "cuda" and not xprof.kernel_counts(doc):
            raise RuntimeError(
                f"the profile trace {tpath} holds no device kernel: the "
                f"profiler did not see the card (its {steps} step(s) "
                f"are unattributed)")
        idx = self._engine.scope_index() if self._engine is not None \
            else None
        if idx is None:
            idx = xprof.build_scope_index(doc)
        attrib = xprof.attribute(doc, steps=steps, scope_index=idx,
                                 source=tpath)
        self._profile_attrib = attrib.as_dict()
        self._emit_profile_lanes(attrib)
        parallax_log.info(
            "profile attribution: %.1f%% of %.2fms device wall "
            "attributed (residual %.2fms) over %d op event(s)",
            100.0 * (attrib.coverage or 0.0), attrib.wall_ms,
            attrib.residual_ms, attrib.events)
        return self._profile_attrib

    def _emit_profile_lanes(self, attrib) -> None:
        """Chrome-lane summary of the parsed window: one span per
        category (its self time) plus the residual lane."""
        t0 = time.perf_counter()
        for cat, row in attrib.by_category.items():
            trace.record_span("profile." + cat, t0,
                              t0 + row["self_ms"] / 1e3,
                              share=row["share"], events=row["events"])
        trace.record_span("profile.residual", t0,
                          t0 + attrib.residual_ms / 1e3,
                          coverage=attrib.coverage)

    def _register_profile_gauges(self) -> None:
        """Lazy ``profile.*`` gauges over the latest parsed attribution:
        read at snapshot time, never a parse themselves."""
        def top(key):
            a = self._profile_attrib
            return a.get(key) if isinstance(a, dict) else None

        def share(cat):
            a = self._profile_attrib
            if not isinstance(a, dict):
                return None
            row = (a.get("by_category") or {}).get(cat)
            return row.get("share") if row else None

        g = self.metrics.gauge
        g("profile.attribution_coverage").set_fn(lambda: top("coverage"))
        g("profile.residual_ms").set_fn(lambda: top("residual_ms"))
        g("profile.step_wall_ms").set_fn(lambda: top("step_wall_ms"))
        g("profile.steps").set_fn(lambda: top("steps"))
        for cat in xprof.CATEGORIES:
            g(f"profile.share.{cat}").set_fn(lambda c=cat: share(c))

    def _profile_for_dump(self) -> Optional[Dict[str, Any]]:
        """Flight section: the parsed attribution, or a pointer to the
        pending trace (a dump does not parse one mid-incident)."""
        if self._profile_attrib is not None:
            return self._profile_attrib
        if self._profile_pending is not None:
            return {"pending_trace": self._profile_pending[0],
                    "steps": self._profile_pending[1],
                    "note": "unparsed; profile_summary() parses it"}
        return None

    def write_calibration(self, path: Optional[str] = None) -> str:
        """Compare the settled mesh search's per-term predictions for the
        winner with the measured per-op aggregates of the latest profile
        window, and write the per-term ``predicted_over_measured`` ratios
        (tune/calibrate.py) to ``path`` (default
        ``Config.calibration_path``), naming the device they were
        measured on. The next search loads them in place of the nominal
        constants. Needs both a settled search and a parsed window;
        refuses otherwise."""
        path = path or self._config.calibration_path
        if not path:
            raise ValueError(
                "write_calibration needs a path: pass one or set "
                "Config.calibration_path")
        attrib = self.profile_summary()
        if not attrib or attrib.get("error") \
                or not attrib.get("by_category"):
            raise ValueError(
                "write_calibration needs a parsed profile window: "
                "arm session.profile_steps(n), run those steps, then "
                "retry (last attribution: %r)"
                % (attrib.get("error") if attrib else None))
        tune = self._tune_result
        if not tune or not tune.get("winner"):
            raise ValueError(
                "write_calibration needs a settled mesh search "
                "(Config.tune_config): the calibration compares the "
                "winner's predicted terms against the measured ones")
        entry = next((e for e in tune.get("scored", [])
                      if e.get("plan") == tune["winner"]["plan"]), None)
        if entry is None or not entry.get("terms_ms"):
            raise ValueError(
                "tune decision record carries no per-term breakdown "
                "for the winner; cannot calibrate")
        terms_s = {k: float(v) / 1e3 for k, v in entry["terms_ms"].items()}
        predicted = calibrate_lib.predicted_terms_from_cost(terms_s)
        # a search that loaded a calibration scored calibrated terms:
        # the stored ratios come back out, so the new record compares the
        # nominal prediction with the measured world (else generations
        # would swing between nominal and calibrated)
        applied = entry.get("calibration") or {}
        for term in calibrate_lib.TERMS:
            r = applied.get(term)
            if r:
                predicted[term] *= float(r)
        measured = calibrate_lib.measured_terms_from_attribution(
            attrib, self._world)
        if measured is None:
            raise ValueError(
                "profile window carried no usable device ops; "
                "cannot calibrate")
        kind = torch.cuda.get_device_name(self._device) \
            if self._device.type == "cuda" else "cpu"
        record = calibrate_lib.build_record(
            predicted, measured,
            basis=f"{tune.get('cost_basis', 'nominal')} on {kind}",
            meta={"plan": tune["winner"]["plan"],
                  "platform": "gpu" if self._device.type == "cuda"
                  else "cpu",
                  "device": kind,
                  "num_devices": self._world,
                  "steps_profiled": attrib.get("steps"),
                  "coverage": attrib.get("coverage")})
        return calibrate_lib.save(path, record)

    # -- checkpoints and recovery (ckpt/) ---------------------------------

    @property
    def data_cursor(self) -> int:
        """Batches consumed so far (a NaN rollback's skipped ones
        included): the input position the checkpoint commits. After a
        restore, skip this many items of the rebuilt stream
        (``run_iter(..., skip=sess.data_cursor)``)."""
        return self._data_cursor

    def _ckpt_extras(self) -> Dict[str, Any]:
        """The exact-resume closure beyond the state, committed in the
        manifest under the JAX session's keys."""
        return {
            "data_cursor": self._data_cursor,
            "host_step": self._state.step,
            "anomaly": self.anomaly.snapshot(),
            "health": (self.health.snapshot()
                       if self.health is not None else None),
            "recovery": (self._recovery.stats()
                         if self._recovery is not None else None),
            # cumulative goodput/badput totals: a resumed run reports
            # the account across attempts (obs/goodput.py)
            "ops": (self.ledger.snapshot()
                    if self.ledger is not None else None),
        }

    def set_rollback_hook(self, fn) -> None:
        """Register ``fn(consecutive_retries)`` to run on every NaN
        rollback (for example to scale the learning rate down)."""
        self._rollback_hooks.append(fn)

    def _fire_rollback_hooks(self, retries: int) -> None:
        for fn in self._rollback_hooks:
            try:
                fn(retries)
            except Exception as e:
                parallax_log.warning("rollback hook failed: %s", e)

    @staticmethod
    def _trip_kind(outputs) -> Optional[str]:
        """'loss' or 'grad' when this step's health outputs are
        non-finite, else None (reads them: blocks on the step)."""
        lf, gn = outputs.get("loss_finite"), outputs.get("grad_norm")
        if lf is not None and not bool(lf):
            return "loss"
        if gn is not None and not math.isfinite(float(gn)):
            return "grad"
        return None

    def _forced_numerics(self):
        """The trip step's stats tree when its step was not sampled:
        its gradients, the poisoned post-step parameters and the
        recovery snapshot as the pre-step ones (``Engine.
        trip_numerics``). Computed before the rollback."""
        snap = self._recovery.snapshot
        snap.wait()
        before = {name[len("params/"):]: v for name, v in snap.host.items()
                  if name.startswith("params/")}
        tree = self._engine.trip_numerics(self._state, before)
        self._forced_basis = {"params_before": "recovery snapshot",
                              "snapshot_step": snap.step}
        return tree

    def _maybe_recover(self, step: int, outputs, kind: Optional[str]
                       ) -> bool:
        """Act on this step's health (``kind`` from ``_trip_kind``): on a
        non-finite loss or gradient norm leave the ``nonfinite_rollback``
        artifact (with the NaN provenance when the numerics observatory
        is on), then copy the last-good snapshot back into the state
        (the batch is skipped: the data cursor keeps advancing). Raises
        ``RecoverySurrender`` after ``max_retries`` consecutive
        failures. Returns True when it rolled back."""
        if kind is None:
            self._recovery.note_good_step()
            self._recovery.maybe_snapshot(self._state.step,
                                          self._state_leaves())
            return False
        detail = {"step": step, "kind": kind,
                  "snapshot_step": self._recovery.snapshot_step,
                  "data_cursor": self._data_cursor}
        if self.numerics is not None:
            # before the rollback: the state is still the poisoned
            # post-step tree and the engine's inputs are the offending
            # batch. Guarded: forensics must never break the recovery
            try:
                detail["provenance"] = self._numerics_provenance(
                    step, kind, outputs)
                basis = self._forced_basis
                if basis is not None:
                    detail["trip_stats_basis"] = basis
                    self._forced_basis = None
                self.numerics.poll(block=True)
                detail["stats_trail"] = self.numerics.trail_tail(16)
            except Exception as e:
                detail["provenance_error"] = f"{type(e).__name__}: {e}"
        if self.journal is not None:
            self.journal.emit(
                "recovery", "nonfinite_rollback", severity="error",
                step=step, kind=kind,
                snapshot_step=self._recovery.snapshot_step,
                data_cursor=self._data_cursor)
        self.flight.trigger("nonfinite_rollback", detail)
        try:
            snap_step = self._recovery.rollback(step, kind)
        except RecoverySurrender as e:
            if self.journal is not None:
                self.journal.emit(
                    "recovery", "surrender", severity="error",
                    step=step, kind=kind,
                    rollbacks=self._recovery.total_rollbacks)
            self.flight.trigger(
                "recovery_surrender",
                {"step": step, "kind": kind, "error": str(e),
                 "rollbacks": self._recovery.total_rollbacks})
            raise
        if self.ledger is not None:
            # the rewound steps trained nothing: their measured step
            # time moves into the rollback_discarded badput class
            discarded_s = self.ledger.on_rollback(snap_step)
            if self.journal is not None:
                self.journal.emit(
                    "ops", "rollback_discarded", severity="warning",
                    to_step=snap_step, discarded_s=round(discarded_s, 4))
        return True

    def on_preemption(self, signum: Optional[int] = None) -> None:
        """The eviction path (SIGTERM by default): one final synchronous
        checkpoint of the current state. Best effort: never raises."""
        if self._closed:
            # a closed session's handler may survive in a newer session's
            # chain: it passes the signal on without saving stale state
            return
        try:
            step = self._host_step()
            if self.journal is not None:
                self.journal.emit(
                    "preempt", "sigterm", severity="warning",
                    signal=signum, step=step,
                    data_cursor=self._data_cursor)
            self.flight.trigger(
                "preemption", {"signal": signum, "step": step,
                               "data_cursor": self._data_cursor})
        except Exception:
            pass
        if self._ckpt.enabled and self._state is not None:
            self._ckpt.save_now(self._state.step, self._state_leaves(),
                                extras=self._ckpt_extras(),
                                reason="preemption")

    def _install_preemption_handler(self) -> None:
        """SIGTERM -> on_preemption, then the previous disposition;
        installed only when something would be saved (``ckpt_dir``) and
        only from the main thread (the signal module's restriction)."""
        import signal
        if not self._config.handle_preemption or not (
                self._config.flight_dir or self._ckpt.enabled):
            return
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            # the exact object, so uninstall can ask "is it still mine?"
            self._sigterm_handler = self._handle_preemption
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               self._sigterm_handler)
            self._sigterm_installed = True
        except (ValueError, OSError):
            self._sigterm_installed = False

    def _handle_preemption(self, signum, frame) -> None:
        import os
        import signal
        # the handler interrupts the main thread anywhere, possibly inside
        # a lock it holds: the save runs on a helper thread with a bounded
        # join (a save cut short is left torn, which restore skips)
        t = threading.Thread(target=self.on_preemption, args=(signum,),
                             name="parallax-preemption", daemon=True)
        t.start()
        t.join(timeout=30.0)
        if t.is_alive():
            parallax_log.error("preemption save did not finish within 30s; "
                               "terminating without it")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev is signal.SIG_IGN:
            # the application ignored SIGTERM: the save does not turn it
            # into the process's end
            return
        else:
            # the default disposition: restore it and deliver again, so the
            # process ends with the standard SIGTERM status
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    def _uninstall_preemption_handler(self) -> None:
        if not self._sigterm_installed:
            return
        import signal
        try:
            # only when the live handler is still ours
            if signal.getsignal(signal.SIGTERM) is self._sigterm_handler:
                signal.signal(signal.SIGTERM,
                              self._prev_sigterm
                              if self._prev_sigterm is not None
                              else signal.SIG_DFL)
        except (ValueError, OSError, TypeError):
            pass
        self._sigterm_installed = False

    @property
    def state(self) -> Optional[engine_lib.TrainState]:
        return self._state

    @property
    def engine(self) -> Optional[engine_lib.Engine]:
        return self._engine

    def _host_step(self) -> int:
        return int(self._state.step) if self._state is not None else 0

    @property
    def steps_per_sec(self) -> Optional[float]:
        """Rolling dispatch throughput over the last <=20 steps; in the
        registry as the ``pipeline.steps_per_sec`` gauge."""
        return self.pipeline_stats.steps_per_sec()

    def metrics_snapshot(self) -> Dict:
        """One JSON-ready dict of every runtime metric (steps, dispatch
        and pipeline stats, engine builds and recompiles, the timeline,
        anomaly, health, numerics, ops and alert gauges) with the polled
        values refreshed first: on the card its memory in use and peak
        (``memory.bytes_in_use``, ``memory.peak_bytes_in_use`` and
        per card ``memory.cuda:<i>.*``). Safe from a monitoring thread
        while training runs."""
        for dev, stats in device_memory_stats().items():
            for key in ("bytes_in_use", "peak_bytes_in_use"):
                self.metrics.gauge(f"memory.{dev}.{key}").set(stats[key])
        if self.health is not None:
            try:
                self.health.poll()
            except Exception:
                pass
        if self.numerics is not None:
            try:
                self.numerics.poll()
            except Exception:
                pass
        snap = self.metrics.snapshot()
        if self._device.type == "cuda":
            snap["memory.bytes_in_use"] = torch.cuda.memory_allocated(
                self._device)
            snap["memory.peak_bytes_in_use"] = \
                torch.cuda.max_memory_allocated(self._device)
        return snap

    # -- training forensics (obs/) ----------------------------------------

    def step_flops(self, cheap_only: bool = True) -> Optional[float]:
        """This rank's FLOPs of one step (``Engine.count_step_flops``:
        the step's matmuls counted once per signature on meta tensors),
        or None before the engine exists or for a model whose step does
        not run on meta tensors. The count is cheap either way;
        ``cheap_only`` is the JAX session's signature."""
        if self._engine is None:
            return None
        return self._engine.count_step_flops()

    def _ensure_flops(self) -> None:
        """Attach the step's FLOPs and the card's peak to the timeline
        once, so per-step MFU appears in rows, goodput and dumps. Null
        stays null (the CPU, a card without a known peak)."""
        if self._flops_resolved or self._engine is None:
            return
        flops = self.step_flops()
        if flops is None:
            return
        from parallax_tpu_torch.common import flops as flops_lib
        kind = torch.cuda.get_device_name(self._device) \
            if self._device.type == "cuda" else ""
        peak = flops_lib.device_peak_flops(self._device.type, kind)
        self.timeline.set_flops(flops, peak)
        self._flops_resolved = True

    def _goodput_for_dump(self) -> Dict:
        self._ensure_flops()
        return self.timeline.goodput()

    def _health_for_dump(self) -> Optional[Dict]:
        """Non-blocking health section: a flight dump must never hang
        on a wedged device draining pending readings."""
        if self.health is None:
            return None
        h = self.health
        return {
            "healthy": h.healthy,
            "first_nonfinite_step": h.first_nonfinite_step,
            "readings": h.recent_readings(),
        }

    def _config_summary(self) -> Dict:
        import dataclasses as _dc
        cfg = self._config
        return {
            "run_option": cfg.run_option,
            "sparse_grad_mode": cfg.sparse_grad_mode,
            "sync": cfg.sync,
            "shape_buckets": (list(cfg.shape_buckets)
                              if isinstance(cfg.shape_buckets,
                                            (list, tuple))
                              else cfg.shape_buckets),
            "prefetch_depth": cfg.prefetch_depth,
            "eager_fetch": cfg.eager_fetch,
            "monitor_health": cfg.monitor_health,
            "numerics_interval": cfg.numerics_interval,
            "numerics_drift_interval": cfg.numerics_drift_interval,
            "flight_dir": cfg.flight_dir,
            "flight_steps": cfg.flight_steps,
            "anomaly": _dc.asdict(cfg.anomaly_config),
            "num_workers": self.num_workers,
            "worker_id": self.worker_id,
        }

    def dump_flight(self, path: Optional[str] = None,
                    reason: str = "manual") -> str:
        """Write a flight-recorder post-mortem artifact NOW and return
        its path; works without ``Config.flight_dir`` (``path``
        defaults into it when set, else the working directory)."""
        return self.flight.dump(reason, path=path)

    def aggregate_host_steps(self, factor: float = 1.25) -> Dict:
        """COLLECTIVE (every rank of the default process group calls
        it): gather every rank's recent step-time stats
        (``torch.distributed.all_gather_object``; a process without a
        group reports only itself) and return the per-rank table with
        any straggler NAMED (``obs/aggregate.py``). The report lands in
        later flight dumps; a named straggler also counts into
        ``anomaly.stragglers`` and triggers a dump."""
        report = aggregate_lib.aggregate_host_step_times(
            self.timeline.local_stats(), factor=factor)
        self._last_host_report = report
        line = aggregate_lib.straggler_summary(report)
        if line is not None:
            self.metrics.counter("anomaly.stragglers").inc(
                len(report["stragglers"]))
            parallax_log.warning("%s", line)
            self.flight.trigger("straggler",
                                {"summary": line, "report": report})
        return report

    def ops_account(self) -> Optional[Dict[str, Any]]:
        """The run-lifetime goodput/badput account (obs/goodput.py):
        productive step time against named badput classes, summing to
        wall clock, cumulative across restarts. None when the obs layer
        is off (no ledger)."""
        if self.ledger is None:
            return None
        return self.ledger.account(self.timeline)

    def _on_anomaly(self, event) -> None:
        """AnomalyMonitor callback: log, journal and flight-dump."""
        parallax_log.warning(
            "anomaly: %s %s at step %d — value %.4g vs baseline %.4g "
            "(%.2fx)", event.signal, event.kind, event.step, event.value,
            event.baseline, event.ratio)
        if self.health is not None:
            # numerics trends and loss/grad spikes weigh more than a
            # step-time blip in the instability score
            self.health.record_instability_event(
                0.5 if event.signal.startswith(("numerics.", "loss",
                                                "grad_norm")) else 0.25)
        if self.journal is not None:
            # before the flight trigger, so the dump's journal_tail
            # already shows this event
            self.journal.emit(
                "anomaly", event.kind, severity="warning",
                signal=event.signal, step=event.step,
                value=event.value, baseline=event.baseline,
                ratio=event.ratio)
        self.flight.trigger(
            f"anomaly_{event.signal}_{event.kind}",
            {"signal": event.signal, "kind": event.kind,
             "step": event.step, "value": event.value,
             "baseline": event.baseline, "ratio": event.ratio})

    def _on_nonfinite(self, step: int, kind: str) -> None:
        """HealthMonitor callback: a NaN/Inf loss or grad norm is a
        flight-dump incident the moment it is consumed."""
        self.flight.trigger(f"nonfinite_{kind}", {"step": step})

    def _on_health_reading(self, step: int, loss, grad_norm) -> None:
        """Finite per-step health values feed the spike detectors."""
        if loss is not None and np.isfinite(loss):
            self.anomaly.observe("loss", step, float(loss))
        if grad_norm is not None and np.isfinite(grad_norm):
            self.anomaly.observe("grad_norm", step, float(grad_norm))

    # -- numerics observatory (obs/numwatch) -------------------------------

    def _numerics_provenance(self, step: int, kind: str, outputs) -> Dict:
        """Blast-radius sweep for the nonfinite_rollback artifact: the
        offending step's inputs, the (pre-rollback) param tree, the trip
        step's stats tree and the loss, in dataflow order."""
        batch = None
        if (self._numerics_last_batch is not None
                and self._numerics_last_batch[0] == step):
            batch = self._numerics_last_batch[1]
        return numwatch_lib.provenance_report(
            feeds=batch,
            params=(self._state.params
                    if self._state is not None else None),
            trip_stats=outputs.get("numerics"),
            loss=outputs.get("loss"), step=step, kind=kind)

    def run_drift_sentinels(self) -> Optional[List[Dict]]:
        """Shadow-run each hand-written kernel against its plain
        executor NOW (B2/B3 against the plain LSTM backward, B7 against
        the plain paged gather, on this session's device) and return the
        check results; gauges land as ``numerics.drift.<name>.*``. None
        when the numerics observatory is off. A kernel that fails to
        build or launch raises."""
        if self.numerics is None:
            return None
        if self._drift_sentinels is None:
            self._drift_sentinels = numwatch_lib.default_sentinels(
                self.metrics, device=self._device)
        results = [s.check() for s in self._drift_sentinels]
        self._drift_results = results
        for r in results:
            if r["flagged"]:
                parallax_log.warning(
                    "numerics: drift sentinel %r flagged — rel_err "
                    "%.3e (tol %.1e), argmax flips %s", r["name"],
                    r["rel_err"], r["rel_err_tol"],
                    r["argmax_flip_frac"])
                if self.journal is not None:
                    self.journal.emit(
                        "numerics", "kernel_drift", severity="warning",
                        name=r["name"], rel_err=r["rel_err"],
                        argmax_flip_frac=r["argmax_flip_frac"])
                self.flight.trigger(f"kernel_drift_{r['name']}", dict(r))
        return results

    def _run_drift_sentinels_guarded(self, step: int) -> None:
        try:
            with trace.span("numerics.drift_sweep", step=step):
                self.run_drift_sentinels()
        except Exception as e:
            # the in-loop cadence must never fail the training step;
            # run_drift_sentinels() itself raises
            parallax_log.warning("drift sentinel sweep failed: %s", e)

    def _numerics_for_dump(self) -> Optional[Dict]:
        """Non-blocking numerics flight section (trail + drift)."""
        if self.numerics is None:
            return None
        out = self.numerics.snapshot_for_dump()
        out["drift"] = self._drift_results
        return out

    def close(self) -> None:
        """Stop every thread the session started (prefetch, the metrics
        sink, the alert engine's), run one last alert pass, join a
        pending checkpoint commit, drain the health and numerics
        readings, write the Chrome trace (``Config.trace_path``), remove
        the SIGTERM handler and drop the engine and the state. Each step
        is isolated: one failing does not skip the rest."""
        self._closed = True
        self._uninstall_preemption_handler()
        self._profile.close()
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
        if self.alerts is not None:
            try:
                self.alerts.evaluate()
                self.alerts.stop()
            except Exception as e:
                parallax_log.warning("alert engine stop failed: %s", e)
        if self.journal is not None:
            try:
                self.journal.emit(
                    "session", "close", step=self._host_step(),
                    goodput=(self.ledger.goodput_fraction()
                             if self.ledger is not None else None))
            except Exception as e:
                parallax_log.warning("journal close event failed: %s", e)
        try:
            self._ckpt.close()
        except Exception as e:  # a failed async commit
            parallax_log.warning("checkpoint close failed: %s", e)
        if self.health is not None:
            try:
                report = self.health.report()
                if not self.health.healthy:
                    parallax_log.warning("health at close: %s", report)
            except Exception as e:
                parallax_log.warning("health drain failed: %s", e)
        if self.numerics is not None:
            try:
                self.numerics.poll(block=True)
            except Exception as e:
                parallax_log.warning("numerics drain failed: %s", e)
        if self._metrics_sink is not None:
            try:
                self._metrics_sink.stop()  # writes the final line
            except Exception as e:
                parallax_log.warning("metrics sink stop failed: %s", e)
            self._metrics_sink = None
        if self._config.trace_path:
            try:
                path = trace.export_chrome_trace(self._config.trace_path)
                parallax_log.info("wrote chrome trace to %s", path)
            except Exception as e:
                parallax_log.warning("chrome trace export failed: %s", e)
        self._engine = None
        self._state = None
        self._engine_cache.prune(keep=None)
        parallax_log.info("session closed after %d steps",
                          self._steps.value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
