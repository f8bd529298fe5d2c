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
resumes the other's run. The extras carry the JAX key set; ``anomaly``,
``health`` and ``ops`` are None (the port has no such monitors).

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
``on_preemption``, ``close``, ``metrics_snapshot`` and the serving
handoff (``serve``, ``push_weights``). The rest of the JAX session
(profiling hooks, the flight recorder, journal, health and anomaly
monitors, the goodput ledger, the partition search) is not.
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
from parallax_tpu_torch.ckpt.recovery import RecoveryPolicy
from parallax_tpu_torch.common.config import ParallaxConfig
from parallax_tpu_torch.common.lib import parallax_log, resolve_device
from parallax_tpu_torch.compile import bucketing, cache as compile_cache
from parallax_tpu_torch.core import engine as engine_lib, mesh as mesh_lib
from parallax_tpu_torch.data.prefetch import Prefetcher, skip_items
from parallax_tpu_torch.obs import trace
from parallax_tpu_torch.obs.metrics import MetricsRegistry


def _to_host(v):
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

    __slots__ = ("_raw", "_host", "_done", "_ready", "_shape")

    def __init__(self, value, ready=None):
        self._raw = value
        self._host = None
        self._done = False
        self._ready = ready
        self._shape = tuple(np.shape(value)) if not isinstance(
            value, torch.Tensor) else tuple(value.shape)

    def result(self):
        """The host value (blocks until the card has it), cached."""
        if not self._done:
            self._host = _to_host(self._raw)
            self._done = True
            self._raw = None
            self._ready = None
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
    the mesh is built with the session (every rank together), the
    engine (plan, optimizer grouping, step) from the first batch."""

    def __init__(self, model: engine_lib.Model, config: ParallaxConfig,
                 num_workers: int = 1, worker_id: int = 0,
                 num_replicas_per_worker: int = 1, seed: int = 0,
                 device="cuda", num_partitions: Optional[int] = None):
        self._model = model
        self._config = config
        self.num_workers = num_workers
        self.worker_id = worker_id
        self.num_replicas_per_worker = num_replicas_per_worker
        self._seed = int(seed)
        self._device = resolve_device(device)
        self.mesh = mesh_lib.build_mesh(self._device,
                                        num_partitions=num_partitions)
        self.metrics = MetricsRegistry()
        self._steps = self.metrics.counter("session.steps")
        self._step_ms = self.metrics.histogram("session.dispatch_ms")
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
        # -- checkpoints and recovery (ckpt/) ------------------------------
        self._ckpt = CheckpointHook(config.ckpt_config, worker_id,
                                    registry=self.metrics)
        self._rollback_hooks: List[Any] = []
        self._recovery = (RecoveryPolicy(
            config.recovery_config, registry=self.metrics,
            on_rollback=self._fire_rollback_hooks)
            if config.recovery_config.enabled else None)
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
        return batch

    def _convert_feed(self, feed_dict: Dict[str, Any],
                      static: bool = True):
        """The feed bucketed and on the card (in the step's static input
        buffers when ``static`` and steps replay graphs)."""
        host = self._host_feed(feed_dict)
        self._ensure_engine(host)
        return self._engine.place(host, static=static)

    def _ensure_engine(self, batch) -> None:
        if self._closed:
            raise RuntimeError("ParallaxSession is closed")
        if self._engine is not None:
            return
        with self._build_lock:
            if self._engine is not None:
                return
            self._build_engine(batch)
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
        """The exact-resume closure beyond the state: the data cursor
        (the state's step and seed came with its leaves)."""
        extras = self._ckpt.restored_extras
        self._data_cursor = int(extras.get("data_cursor", self._state.step))
        info = self._ckpt.last_restore_info or {}
        parallax_log.info("restored checkpoint at step %d (data cursor %d)",
                          self._state.step, self._data_cursor)
        if info.get("fallbacks") or info.get("torn_steps"):
            parallax_log.warning("checkpoint restore fell back: %s", info)

    def _build_engine(self, example_batch) -> None:
        """Get or build the engine of this plan and example signature
        (``compile.cache.EngineCache``); the state is made once."""
        example = self._bucketed_example(example_batch)
        cfg = self._config
        key = (cfg.run_option, cfg.sync, cfg.sparse_grad_mode,
               cfg.average_sparse, self.mesh.repl, self.mesh.shard,
               bucketing.batch_signature(engine_lib._to_meta(example)))
        engine = self._engine_cache.get(key)
        if engine is None:
            engine = engine_lib.Engine(
                self._model, self.mesh, cfg, example_batch,
                metrics=self.metrics)
            self._engine_cache.put(key, engine)
        self._engine = engine
        if self._state is None:
            self._state = engine.init_state(self._seed)

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

    def _convert_fetch(self, fetches, outputs, lazy: bool = True):
        ready = self._ready_fn()

        def one(name):
            if name not in outputs:
                raise KeyError(f"fetch {name!r} unknown; available: "
                               f"{sorted(outputs)}")
            f = Fetch(outputs[name], ready)
            return f if lazy else f.result()

        if fetches is None:
            return {k: one(k) for k in outputs}
        if isinstance(fetches, str):
            return one(fetches)
        return [one(f) for f in fetches]

    # -- running ----------------------------------------------------------

    def _run_step(self, fetches, batch, force_lazy: bool = False):
        """Dispatch one step on a placed batch; shared by run, run_async
        and run_iter."""
        step = self._state.step
        t0 = time.perf_counter()
        with trace.span("session.dispatch", step=step):
            self._state, outputs = self._engine.step(self._state, batch)
        self._step_ms.record((time.perf_counter() - t0) * 1e3)
        self._steps.inc()
        self._data_cursor += 1
        if self._recovery is not None:
            self._maybe_recover(step, outputs)
        self._ckpt.maybe_save(self._state.step, self._state_leaves,
                              extras_fn=self._ckpt_extras)
        lazy = force_lazy or not self._config.eager_fetch
        return self._convert_fetch(fetches, outputs, lazy=lazy)

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
        self._wait_ms.record((time.perf_counter() - t0) * 1e3)
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
        with trace.span("session.warmup"):
            return self._engine.warmup(self._state, batch_sizes)

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
            "anomaly": None,
            "health": None,
            "recovery": (self._recovery.stats()
                         if self._recovery is not None else None),
            "ops": None,
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

    def _maybe_recover(self, step: int, outputs) -> bool:
        """Read this step's health outputs; on a non-finite loss or
        gradient norm copy the last-good snapshot back into the state (the
        batch is skipped: the data cursor keeps advancing). Raises
        ``RecoverySurrender`` after ``max_retries`` consecutive failures.
        Returns True when it rolled back."""
        lf, gn = outputs.get("loss_finite"), outputs.get("grad_norm")
        kind = None
        if lf is not None and not bool(lf):
            kind = "loss"
        elif gn is not None and not math.isfinite(float(gn)):
            kind = "grad"
        if kind is None:
            self._recovery.note_good_step()
            self._recovery.maybe_snapshot(self._state.step,
                                          self._state_leaves())
            return False
        self._recovery.rollback(step, kind)
        return True

    def on_preemption(self, signum: Optional[int] = None) -> None:
        """The eviction path (SIGTERM by default): one final synchronous
        checkpoint of the current state. Best effort: never raises."""
        if self._closed:
            # a closed session's handler may survive in a newer session's
            # chain: it passes the signal on without saving stale state
            return
        if self._ckpt.enabled and self._state is not None:
            self._ckpt.save_now(self._state.step, self._state_leaves(),
                                extras=self._ckpt_extras(),
                                reason="preemption")

    def _install_preemption_handler(self) -> None:
        """SIGTERM -> on_preemption, then the previous disposition;
        installed only when something would be saved (``ckpt_dir``) and
        only from the main thread (the signal module's restriction)."""
        import signal
        if not self._config.handle_preemption or not self._ckpt.enabled:
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

    def metrics_snapshot(self) -> Dict:
        """One JSON-ready dict of the session's counters (steps, engine
        builds and steps, host dispatch ms) and, on the card, its memory
        in use and peak."""
        snap = self.metrics.snapshot()
        if self._device.type == "cuda":
            snap["memory.bytes_in_use"] = torch.cuda.memory_allocated(
                self._device)
            snap["memory.peak_bytes_in_use"] = \
                torch.cuda.max_memory_allocated(self._device)
        return snap

    def close(self) -> None:
        """Stop the prefetch thread, join a pending checkpoint commit,
        remove the SIGTERM handler and drop the engine and the state
        (their tensors are freed when no caller holds them)."""
        self._closed = True
        self._uninstall_preemption_handler()
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
        try:
            self._ckpt.close()
        except Exception as e:  # a failed async commit
            parallax_log.warning("checkpoint close failed: %s", e)
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
