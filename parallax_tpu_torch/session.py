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
before issuing the next one. ``run_iter()`` drives a batch iterator,
with batch t+1 converted and copied to the card while step t runs.

Compile-ahead (``parallax_tpu/session.py:1713-1797``): ``warmup()``
captures the step's CUDA graph for every declared
``Config.shape_buckets`` bucket before step 0, and ``compile_stats()``
reports the buckets, the capture seconds and the cache counters. With
buckets declared every feed is padded onto its bucket before it is
copied to the card. On the card, feeds are copied from pinned host
memory into the engine's static input buffers, which the step's graph
reads.

Ported: ``run``, ``run_iter``, ``Fetch``, ``state`` (with its ``model_state``
for a stateful model), ``engine``, ``evaluate``, ``warmup``,
``compile_stats``, ``gather_params``, ``sparse_wire_bytes_per_step``,
``close`` and ``metrics_snapshot``. The rest of the
JAX session (checkpoints, profiling hooks, recovery, health and anomaly
monitors, the partition search, serving handoff) is not.
"""

from __future__ import annotations

import operator
import time
from typing import Any, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from parallax_tpu_torch.common.config import ParallaxConfig
from parallax_tpu_torch.common.lib import parallax_log, resolve_device
from parallax_tpu_torch.compile import bucketing, cache as compile_cache
from parallax_tpu_torch.core import engine as engine_lib, mesh as mesh_lib
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
        self._engine: Optional[engine_lib.Engine] = None
        self._state: Optional[engine_lib.TrainState] = None
        self._closed = False
        # built engines keyed by (plan, bucketed example signature)
        self._engine_cache = compile_cache.EngineCache(self.metrics)
        if config.compilation_cache_dir:
            compile_cache.enable_persistent_cache(
                config.compilation_cache_dir)

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
        if self._engine is None:
            self._build_engine(batch)

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

    def _convert_fetch(self, fetches, outputs):
        ready = self._ready_fn()

        def one(name):
            if name not in outputs:
                raise KeyError(f"fetch {name!r} unknown; available: "
                               f"{sorted(outputs)}")
            return Fetch(outputs[name], ready)

        if fetches is None:
            return {k: one(k) for k in outputs}
        if isinstance(fetches, str):
            return one(fetches)
        return [one(f) for f in fetches]

    # -- running ----------------------------------------------------------

    def _run_step(self, fetches, batch):
        t0 = time.perf_counter()
        self._state, outputs = self._engine.step(self._state, batch)
        self._step_ms.record((time.perf_counter() - t0) * 1e3)
        self._steps.inc()
        return self._convert_fetch(fetches, outputs)

    def prepare(self, feed_dict: Dict[str, Any]) -> int:
        """Build the engine and the initial state from an example batch
        without running a step; returns the global step (0)."""
        self._ensure_engine(self._host_feed(feed_dict))
        return int(self._state.step)

    def run(self, fetches: Union[None, str, Sequence[str]] = None,
            feed_dict: Optional[Dict[str, Any]] = None):
        if feed_dict is None:
            raise ValueError(
                "ParallaxSession.run requires feed_dict (the batch)")
        return self._run_step(fetches, self._convert_feed(feed_dict))

    def run_iter(self, batches: Iterable[Dict[str, Any]],
                 fetches: Union[None, str, Sequence[str]] = None):
        """Yields one ``run()`` result per feed dict of ``batches``, in
        order. Each next batch is converted and its copy to the card
        queued before the current step's result is yielded, so the
        host's work on it overlaps the step on the card."""
        it = iter(batches)
        try:
            nxt = self._convert_feed(next(it))
        except StopIteration:
            return
        while nxt is not None:
            batch = nxt
            out = self._run_step(fetches, batch)
            try:
                nxt = self._convert_feed(next(it))
            except StopIteration:
                nxt = None
            yield out

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
        """Drop the engine and the state (their tensors are freed when
        no caller holds them)."""
        self._closed = True
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
