"""ParallaxSession — the user-facing training loop object (a subset of
``parallax_tpu/session.py``).

``run(fetches, feed_dict)`` executes one train step and returns the
requested named outputs. Feed contract (reference
session_context.py:205-233): each feed value is one array covering the
whole local batch, or a list of ``num_replicas_per_worker`` per-replica
arrays, concatenated on dim 0. Fetch contract: names among
{"loss", "global_step"} and the model's metric names; a single name
returns one value, a list returns a list, None returns a dict.

Fetches are lazy: ``run()`` returns ``Fetch`` handles whose value stays
on the card until first read, so the host does not wait for a step
before issuing the next one. ``run_iter()`` drives a batch iterator,
with batch t+1 converted and copied to the card while step t runs.

Ported: ``run``, ``run_iter``, ``Fetch``, ``state`` (with its ``model_state``
for a stateful model), ``engine``,
``evaluate``, ``close`` and ``metrics_snapshot``. The rest of the JAX
session (checkpoints, profiling hooks, recovery, health and anomaly
monitors, warmup, serving handoff) is not.
"""

from __future__ import annotations

import operator
import time
from typing import Any, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from parallax_tpu_torch.common.config import ParallaxConfig
from parallax_tpu_torch.common.lib import parallax_log, resolve_device
from parallax_tpu_torch.core import engine as engine_lib, mesh as mesh_lib
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
    """One model trained on one card. Built by ``parallel_run``; the
    engine (plan, optimizer grouping, step) is built from the first
    batch."""

    def __init__(self, model: engine_lib.Model, config: ParallaxConfig,
                 num_workers: int = 1, worker_id: int = 0,
                 num_replicas_per_worker: int = 1, seed: int = 0,
                 device="cuda"):
        self._model = model
        self._config = config
        self.num_workers = num_workers
        self.worker_id = worker_id
        self.num_replicas_per_worker = num_replicas_per_worker
        self._seed = int(seed)
        self._device = resolve_device(device)
        self.metrics = MetricsRegistry()
        self._steps = self.metrics.counter("session.steps")
        self._step_ms = self.metrics.histogram("session.dispatch_ms")
        self._engine: Optional[engine_lib.Engine] = None
        self._state: Optional[engine_lib.TrainState] = None
        self._closed = False

    # -- feeds and fetches ------------------------------------------------

    def _convert_feed(self, feed_dict: Dict[str, Any]):
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
                batch[name] = value.to(self._device, non_blocking=True)
            else:
                value = np.asarray(value)
                if value.dtype == np.float64:
                    value = value.astype(np.float32)
                t = torch.from_numpy(np.ascontiguousarray(value))
                if self._device.type == "cuda":
                    t = t.pin_memory()
                batch[name] = t.to(self._device, non_blocking=True)
        return batch

    def _ensure_engine(self, batch) -> None:
        if self._closed:
            raise RuntimeError("ParallaxSession is closed")
        if self._engine is None:
            self._engine = engine_lib.Engine(
                self._model, mesh_lib.build_mesh(self._device),
                self._config, batch, metrics=self.metrics)
            self._state = self._engine.init_state(self._seed)

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
        self._ensure_engine(self._convert_feed(feed_dict))
        return int(self._state.step)

    def run(self, fetches: Union[None, str, Sequence[str]] = None,
            feed_dict: Optional[Dict[str, Any]] = None):
        if feed_dict is None:
            raise ValueError(
                "ParallaxSession.run requires feed_dict (the batch)")
        batch = self._convert_feed(feed_dict)
        self._ensure_engine(batch)
        return self._run_step(fetches, batch)

    def run_iter(self, batches: Iterable[Dict[str, Any]],
                 fetches: Union[None, str, Sequence[str]] = None):
        """Yields one ``run()`` result per feed dict of ``batches``, in
        order. Each next batch is converted and its copy to the card
        issued before the current step's result is yielded, so the copy
        overlaps the step on the card."""
        it = iter(batches)
        try:
            nxt = self._convert_feed(next(it))
        except StopIteration:
            return
        while nxt is not None:
            batch = nxt
            self._ensure_engine(batch)
            out = self._run_step(fetches, batch)
            try:
                nxt = self._convert_feed(next(it))
            except StopIteration:
                nxt = None
            yield out

    def evaluate(self, feed_dict: Dict[str, Any], fetches="loss"):
        """A held-out loss (and metrics) on ``feed_dict``: the forward
        with no gradient and no update."""
        batch = self._convert_feed(feed_dict)
        self._ensure_engine(batch)
        loss, metrics = self._engine.evaluate(self._state, batch)
        return self._convert_fetch(fetches, {"loss": loss, **metrics})

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
        parallax_log.info("session closed after %d steps",
                          self._steps.value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
