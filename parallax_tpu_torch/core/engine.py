"""The hybrid parallelization engine, on one card
(``parallax_tpu/core/engine.py``: ``Model``, ``TrainState``,
``build_plan`` and ``Engine.init_state`` / ``step`` in sync mode).

Routing rule (reference: common/runner.py:93-119): a dense variable is
replicated and its gradient all-reduced; a sparse variable is
row-sharded and its rows exchanged. On one card both keep the whole
tensor, but the plan still routes each parameter to its own update
path, and that is what runs here:

* the dense group goes through the model's optimizer (for LM1B,
  ``clip_by_global_norm`` then Adagrad, core/optim.py);
* under ``Config(sparse_grad_mode="slices")`` the tables the model
  registers in ``slice_updaters`` are read through
  ``embedding_lookup``'s slice capture and updated scatter-only from
  their (ids, row-gradient) slices, outside the optimizer and its
  clip, never through a dense [V, D] gradient (engine.py:680-714).

Parameters live in a nested dict of tensors. The step updates them, the
optimizer state, the model state and the slice accumulators in place
(the JAX step returns a new state; in place, a step allocates nothing
table-sized, and a captured graph finds its state where it left it).
Each step draws its randomness (dropout masks, sampled-softmax
candidates) from one engine-owned generator, reseeded from the run's
seed and the step counter before the step, the counterpart of
``fold_in(PRNGKey(seed + 1), step)``.

A stateful model (``Model(stateful=True)``, e.g. BatchNorm statistics)
carries ``TrainState.model_state`` beside the parameters: the loss
returns the new state, which is copied over the old after the step; only
``params`` get gradients (engine.py:636, :719).

Compile-ahead (``parallax_tpu/core/engine.py:345-424, 767-916``): on
the card each batch signature (``compile.bucketing.batch_signature``)
runs as one CUDA graph of the whole step, forward, backward and update,
captured at its first sight or ahead of step 0 by ``warmup``
(compile/graphs.py, compile/warmup.py). A batch is copied into the
signature's static input buffers and the graph replayed; the outputs are
copied out of the graph's pool. Every new signature after the first is
counted in ``engine.recompiles`` and warned about once, unless it is a
declared ``Config.shape_buckets`` bucket, whose signatures are
registered as expected at build. On the CPU, and inside
``compile.disable_capture()``, the step runs eagerly.

``sync=False`` (the delayed-gradient emulation of async PS), the
numerics observatory and multiple ranks are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from parallax_tpu_torch.common import consts
from parallax_tpu_torch.common.config import ParallaxConfig
from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.compile import bucketing, graphs as graphs_lib, \
    warmup as warmup_lib
from parallax_tpu_torch.core import classify, mesh as mesh_lib, \
    optim, specs as specs_lib
from parallax_tpu_torch.obs import _state as obs_state
from parallax_tpu_torch.obs import metrics as obs_metrics, trace
from parallax_tpu_torch.ops import embedding

REPLICATED = "replicated"
ROW_SHARDED = "row_sharded"


class Model:
    """A single-device model description, the unit handed to
    ``parallel_run``.

    * ``init_fn(gen, device) -> params``: a nested dict of tensors on
      ``device``, drawn from the ``torch.Generator`` ``gen``. The engine
      also calls it with ``device="meta"`` (and a CPU generator) for the
      shapes alone. For a *stateful* model (``stateful=True``) it returns
      ``(params, model_state)``.
    * ``loss_fn(params, batch[, gen]) -> loss | (loss, metrics)``: the
      forward and loss on one batch of tensors. A stateful model takes
      ``loss_fn(params, model_state, batch[, gen])`` and returns
      ``(loss, metrics, new_model_state)``, the new state computed
      without gradient.
    * ``optimizer``: a core/optim.py transformation (default sgd(0.01)).
    * ``sparse_params`` / ``dense_params``: path overrides for the
      classifier.
    * ``slice_updaters``: path pattern (fnmatch) -> updater
      (ops/sparse_optim.py), used under ``sparse_grad_mode="slices"``.
      A table registered here must be touched only through
      ``embedding_lookup``; the engine refuses one that is not.
      Stateless models only.
    """

    def __init__(self, init_fn: Callable, loss_fn: Callable,
                 optimizer: Optional[optim.GradientTransformation] = None,
                 sparse_params: Sequence[str] = (),
                 dense_params: Sequence[str] = (),
                 stateful: bool = False,
                 slice_updaters: Optional[Dict[str, Any]] = None):
        self.init_fn = init_fn
        self.loss_fn = loss_fn
        self.optimizer = optimizer or optim.sgd(0.01)
        self.sparse_params = tuple(sparse_params)
        self.dense_params = tuple(dense_params)
        self.stateful = stateful
        self.slice_updaters = dict(slice_updaters or {})
        if stateful and self.slice_updaters:
            raise ValueError("slice_updaters is stateless-model only")
        try:
            n_pos = len([
                p for p in inspect.signature(loss_fn).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)])
        except (TypeError, ValueError):
            n_pos = 4 if stateful else 2
        self._loss_takes_gen = n_pos >= (4 if stateful else 3)

    def call_init(self, gen, device):
        """Returns (params, model_state); model_state is None for
        stateless models."""
        out = self.init_fn(gen, device)
        return out if self.stateful else (out, None)

    def call_loss(self, params, batch, gen, model_state=None):
        """Returns (loss, metrics, new_model_state)."""
        args = (params, model_state, batch) if self.stateful \
            else (params, batch)
        out = self.loss_fn(*args, gen) if self._loss_takes_gen \
            else self.loss_fn(*args)
        if self.stateful:
            loss, metrics, new_state = out
            return loss, dict(metrics), new_state
        if isinstance(out, tuple):
            loss, metrics = out
        else:
            loss, metrics = out, {}
        return loss, dict(metrics), None


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any
    seed: int
    # non-trainable state (e.g. BatchNorm statistics); stateful models only
    model_state: Any = None
    # sparse_grad_mode="slices" only: {table path: updater state}
    slice_state: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ShardingPlan:
    """Resolved placement: one placement per parameter path."""

    mesh: mesh_lib.Mesh
    var_specs: Dict[str, specs_lib.VariableSpec]
    placements: Dict[str, str]

    def describe(self) -> str:
        return specs_lib.summarize(self.var_specs)


def step_seed(seed: int, step: int) -> int:
    """The seed of one step, from the run's seed and the step counter
    (the counterpart of ``fold_in(PRNGKey(seed + 1), step)``)."""
    return ((seed + 1) * 0x9E3779B97F4A7C15 + step) & 0x7FFFFFFFFFFFFFFF


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """A fresh generator seeded for one step (``step_seed``)."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


def build_plan(model: Model, mesh: mesh_lib.Mesh, config: ParallaxConfig,
               meta_params, meta_batch, meta_state=None) -> ShardingPlan:
    """Classify variables (one recorded forward on meta tensors) and
    choose a placement for each (the 'graph transform'). The model
    state's leaves are inputs of that forward, not variables: they are
    not classified."""
    var_specs = classify.classify_params(
        model.call_loss, meta_params, meta_batch, torch.Generator(),
        meta_state, sparse_override=model.sparse_params,
        dense_override=model.dense_params)
    p = mesh_lib.num_shards(mesh)

    def choose(vs: specs_lib.VariableSpec) -> str:
        shardable = len(vs.shape) >= 1 and vs.shape[0] % p == 0
        if config.run_option == consts.RUN_AR:
            return REPLICATED
        if config.run_option == consts.RUN_SHARD:
            return ROW_SHARDED if shardable else REPLICATED
        return ROW_SHARDED if vs.is_sparse and shardable else REPLICATED

    placements = {path: choose(vs) for path, vs in var_specs.items()}
    plan = ShardingPlan(mesh, var_specs, placements)
    parallax_log.info("sharding plan: %s (run_option=%s, shard axis=%d)",
                      plan.describe(), config.run_option, p)
    return plan


def _torch_dtype(v) -> torch.dtype:
    if isinstance(v, torch.Tensor):
        return v.dtype
    return torch.from_numpy(np.empty((0,), np.asarray(v).dtype)).dtype


def _to_meta(batch):
    """Meta tensors of a batch of tensors or host arrays."""
    return {k: torch.empty(tuple(np.shape(v)), dtype=_torch_dtype(v),
                           device="meta") for k, v in batch.items()}


def state_tensors(state: "TrainState") -> List[torch.Tensor]:
    """Every tensor a step reads and writes: the parameters, the
    optimizer, model and slice states."""
    return [leaf for _, leaf in classify.flatten(
        [state.params, state.opt_state, state.model_state,
         state.slice_state]) if isinstance(leaf, torch.Tensor)]


def _host_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


class Engine:
    """Owns the plan, the optimizer grouping and the train step for one
    card."""

    def __init__(self, model: Model, mesh: mesh_lib.Mesh,
                 config: ParallaxConfig, example_batch,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None):
        if not config.sync:
            raise NotImplementedError(
                "sync=False (bounded-staleness delayed-gradient training) "
                "is not ported; pass sync=True")
        self.model = model
        self.mesh = mesh
        self.config = config
        self.device = mesh.device
        self.metrics = metrics if metrics is not None \
            else obs_metrics.MetricsRegistry()
        self._recompiles = self.metrics.counter("engine.recompiles")
        # batch signatures already seen or declared: a growing set means
        # shape-driven recaptures
        self._traced_signatures: set = set()
        # -- compile-ahead engine (compile/) -----------------------------
        # captured step graphs by batch signature (None: a signature the
        # CPU warmup registered, with nothing to capture)
        self._executables: Dict[Tuple, Optional[graphs_lib.Graph]] = {}
        self._inputs: Dict[Tuple, Dict[str, torch.Tensor]] = {}
        self._captured_state: Optional[TrainState] = None
        self._exec_hits = self.metrics.counter(
            "engine.executable_cache.hits")
        self._exec_misses = self.metrics.counter(
            "engine.executable_cache.misses")
        self.warmup_seconds: Dict[int, float] = {}
        # the step's generator, reseeded before each step (and each
        # replay: the graphs register it)
        self._gen = torch.Generator(device=self.device)
        self._buckets = None
        if config.shape_buckets is not None:
            if not isinstance(example_batch, dict):
                raise ValueError(
                    "shape_buckets requires dict feeds (name -> array); "
                    "got a %s example batch" % type(example_batch).__name__)
            lead = bucketing._leading_dim(example_batch)
            self._buckets = bucketing.resolve_buckets(
                config.shape_buckets, lead if lead else 1)
            example_batch, _ = bucketing.bucket_batch(
                example_batch, self._buckets, config.bucket_mask_feed)
        meta_params, meta_state = model.call_init(torch.Generator(), "meta")
        meta_batch = _to_meta(example_batch)
        self._batch_shapes = meta_batch
        self._example_batch_dim = bucketing._leading_dim(meta_batch)
        if self._buckets:
            # declared buckets are expected signatures: registered now, a
            # multi-bucket stream never counts into engine.recompiles
            # (each bucket still costs one capture; warmup() pays it
            # ahead of step 0)
            self._traced_signatures.update(bucketing.bucket_signatures(
                meta_batch, self._example_batch_dim, self._buckets))
        self.plan = build_plan(model, mesh, config, meta_params, meta_batch,
                               meta_state)
        self._slice_resolved = self._resolve_slice_updaters(meta_params,
                                                            meta_batch)
        self._dense_paths = [p for p in self.plan.var_specs
                             if p not in self._slice_resolved]
        self.metrics.counter("engine.builds").inc()

    def _resolve_slice_updaters(self, meta_params,
                                meta_batch) -> Dict[str, Any]:
        """{exact param path: updater} for sparse_grad_mode='slices'."""
        if (self.config.sparse_grad_mode != "slices"
                or not self.model.slice_updaters):
            if self.config.sparse_grad_mode == "slices":
                parallax_log.warning(
                    "sparse_grad_mode='slices' but the model declares no "
                    "slice_updaters; falling back to dense gradients")
            return {}
        resolved, hit = {}, set()
        for path in self.plan.var_specs:
            for pattern, upd in self.model.slice_updaters.items():
                if fnmatch.fnmatch(path, pattern):
                    resolved[path] = upd
                    hit.add(pattern)
                    break
        unmatched = set(self.model.slice_updaters) - hit
        if unmatched:
            raise ValueError(
                f"slice_updaters patterns {sorted(unmatched)} match no "
                f"param path; available: {sorted(self.plan.var_specs)}")
        # a registered table used other than through a gather would lose
        # that use's gradient: refuse it
        dense = [p for p in resolved if not self.plan.var_specs[p].is_sparse]
        if dense:
            raise ValueError(
                f"slice_updaters registered for {sorted(dense)}, which the "
                f"loss uses other than through embedding_lookup "
                f"({[self.plan.var_specs[p].reason for p in dense]}); "
                f"their gradients would be lost")
        # a table read by a gather other than embedding_lookup
        # (index_select, table[ids], F.embedding) is classified sparse but
        # never captured, so it would never be updated: one forward on the
        # meta tensors under a capture finds the tables that are looked up
        # (the reference's abstract discovery pass, engine.py:506-536)
        flat = dict(classify.flatten(meta_params))
        cap = embedding.SliceCapture({id(flat[p]): p for p in resolved})
        with torch.no_grad(), embedding.slice_capture_scope(cap):
            self.model.call_loss(meta_params, meta_batch, torch.Generator())
        missing = set(resolved) - {p for p, _, _ in cap.captured}
        if missing:
            raise ValueError(
                f"slice_updaters registered for {sorted(missing)} but no "
                f"embedding_lookup of those tables was traced; their "
                f"gradients would be silently lost")
        parallax_log.info("sparse_grad_mode=slices over %s", sorted(resolved))
        return resolved

    # -- state ------------------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params, model_state = self.model.call_init(gen, self.device)
        flat = dict(classify.flatten(params))
        for path in self._dense_paths:
            flat[path].requires_grad_(True)
        with torch.no_grad():
            opt_state = self.model.optimizer.init(
                {p: flat[p] for p in self._dense_paths})
            slice_state = {p: upd.init(flat[p])
                           for p, upd in self._slice_resolved.items()} \
                or None
        return TrainState(step=0, params=params, opt_state=opt_state,
                          seed=seed, model_state=model_state,
                          slice_state=slice_state)

    # -- feeds --------------------------------------------------------------

    def bucket(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """``batch`` padded onto its declared bucket (compile/
        bucketing.py; unchanged without ``shape_buckets``). Host feeds:
        numpy arrays or CPU tensors."""
        if self._buckets is None or not isinstance(batch, dict):
            return batch
        return bucketing.bucket_batch(batch, self._buckets,
                                      self.config.bucket_mask_feed)[0]

    def place(self, batch: Dict[str, Any],
              static: bool = True) -> Dict[str, torch.Tensor]:
        """A host batch (numpy arrays or tensors), bucketed, on the
        engine's device. Host arrays go through pinned memory with an
        asynchronous copy. Where steps replay graphs (and ``static``),
        the batch is copied into its signature's static input buffers,
        which are returned: the next ``step`` replays on them, and the
        next ``place`` of that signature overwrites them, in stream
        order, after the step."""
        host = {k: _host_tensor(v) for k, v in self.bucket(batch).items()}
        cuda = self.device.type == "cuda"
        if cuda:
            host = {k: (t.pin_memory() if t.device.type == "cpu" else t)
                    for k, t in host.items()}
        if static and graphs_lib.capture_enabled(self.device):
            return self._static_inputs(
                bucketing.batch_signature(host), host)
        return {k: t.to(self.device, non_blocking=cuda)
                for k, t in host.items()}

    def _static_inputs(self, sig, batch=None) -> Dict[str, torch.Tensor]:
        """The static input buffers of signature ``sig`` (made on first
        use), with ``batch`` copied in when given and not already them."""
        bufs = self._inputs.get(sig)
        if bufs is None:
            bufs = {name: torch.zeros(shape, dtype=getattr(torch, dt[6:]),
                                      device=self.device)
                    for name, shape, dt in sig}
            self._inputs[sig] = bufs
        if batch is not None:
            for k, t in batch.items():
                if bufs[k] is not t:
                    bufs[k].copy_(t, non_blocking=True)
        return bufs

    def _bucket_shapes(self, b: int) -> Dict[str, bucketing._Aval]:
        """The example batch's shapes with every batch-leading dim
        re-sized to bucket ``b``."""
        return {name: bucketing._Aval(bucketing.bucket_shape(
                    tuple(leaf.shape), self._example_batch_dim, b),
                    leaf.dtype)
                for name, leaf in self._batch_shapes.items()}

    # -- the step ---------------------------------------------------------

    def step(self, state: TrainState, batch) -> tuple:
        """One training step on a batch of tensors on the card (``place``
        gives them). Returns (state, outputs); the state is updated in
        place. On the card the signature's graph is replayed, captured
        first if it has none; on the CPU and inside
        ``compile.disable_capture()`` the step runs eagerly."""
        sig = bucketing.batch_signature(batch)
        self._note_batch_signature(sig)
        with trace.span("engine.step"):
            if graphs_lib.capture_enabled(self.device):
                outputs = self._replay(state, sig, batch)
            else:
                self._reseed(state)
                outputs = self._compute(state, batch)
        state.step += 1
        self.metrics.counter("engine.steps").inc()
        outputs = {"loss": outputs.pop("loss"), "global_step": state.step,
                   **outputs}
        return state, outputs

    def _reseed(self, state: TrainState) -> None:
        self._gen.manual_seed(step_seed(state.seed, state.step))

    def _compute(self, state: TrainState, batch) -> Dict[str, Any]:
        """The step's device work, every state tensor written in place:
        forward, gradients, the optimizer, the slice updates and the new
        model state. Returns the loss and metrics (tensors on the
        device)."""
        flat = dict(classify.flatten(state.params))
        cap = None
        scope = contextlib.nullcontext()
        if self._slice_resolved:
            cap = embedding.SliceCapture(
                {id(flat[p]): p for p in self._slice_resolved})
            scope = embedding.slice_capture_scope(cap)
        with scope:
            loss, metrics, new_model_state = self.model.call_loss(
                state.params, batch, self._gen, state.model_state)
        leaves = [flat[p] for p in self._dense_paths]
        rows = [r for _, _, r in cap.captured] if cap is not None else []
        grads = torch.autograd.grad(loss, leaves + rows, allow_unused=True)
        with torch.no_grad():
            dense = {p: (g if g is not None else torch.zeros_like(flat[p]))
                     for p, g in zip(self._dense_paths, grads)}
            updates, _ = self.model.optimizer.update(
                dense, state.opt_state,
                {p: flat[p] for p in self._dense_paths})
            optim.apply_updates(flat, updates)
            if cap is not None:
                self._apply_slices(flat, state, cap.captured,
                                   grads[len(leaves):])
            if self.model.stateful:
                old = [t for _, t in classify.flatten(state.model_state)]
                new = [t for _, t in classify.flatten(new_model_state)]
                if len(old) != len(new):
                    raise ValueError(
                        f"the loss returned a model state of {len(new)} "
                        f"leaves for one of {len(old)}")
                if old:
                    torch._foreach_copy_(old, new)
        outputs = {"loss": loss.detach()}
        outputs.update({k: (v.detach() if isinstance(v, torch.Tensor)
                            else v) for k, v in metrics.items()})
        return outputs

    def _replay(self, state: TrainState, sig, batch) -> Dict[str, Any]:
        inputs = self._static_inputs(sig, batch)
        graph = self._executables.get(sig)
        if graph is not None and state is self._captured_state:
            self._exec_hits.inc()
        else:
            if self._executables and graph is None:
                self._exec_misses.inc()
            if state is not self._captured_state:
                # the graphs read another state's buffers
                self._drop_graphs()
            graph = self._capture(state, sig, inputs)
        self._reseed(state)
        out = graph.replay()
        # copied out of the pool: the next replay overwrites it, and a
        # lazy fetch may be read after that
        return {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in out.items()}

    def _drop_graphs(self) -> None:
        self._executables = {s: None for s in self._executables}
        self._captured_state = None

    @torch.no_grad()
    def _capture(self, state: TrainState, sig, inputs) -> graphs_lib.Graph:
        """Capture the step on ``inputs`` against ``state``'s buffers. The
        eager call that precedes the capture runs a real step; every
        state tensor is copied aside first and back after, so the state
        leaves the capture bitwise as it came (as compiling a JAX step
        never runs it)."""
        leaves = state_tensors(state)
        snapshot = [t.detach().clone() for t in leaves]

        def body():
            with torch.enable_grad():
                return self._compute(state, inputs)

        try:
            graph = graphs_lib.capture(body, self.device, self._gen)
        finally:
            torch._foreach_copy_(leaves, snapshot)
            del snapshot
        self._executables[sig] = graph
        self._captured_state = state
        self.metrics.histogram("engine.capture_seconds").record(
            graph.seconds)
        parallax_log.info("captured the step for signature %s in %.2fs "
                          "(%d kernel-wrapper launches)",
                          [(n, s) for n, s, _ in sig], graph.seconds,
                          sum(graph.launches.values()))
        return graph

    def warmup(self, state: TrainState,
               batch_sizes: Optional[Sequence[int]] = None
               ) -> Dict[int, float]:
        """Capture the step's graph for every declared batch bucket
        (``Config.shape_buckets``), or for explicit ``batch_sizes``,
        ahead of step 0, so no step of a bucketed stream stops to
        capture. Idempotent: a size already captured is skipped. The
        state is left bitwise as it was. Returns {batch_size: seconds};
        also recorded in ``warmup_seconds`` and the
        ``engine.compile_seconds`` histogram. On the CPU (and inside
        ``compile.disable_capture()``) there is nothing to capture: the
        sizes' signatures are registered and the steps run eagerly."""
        return warmup_lib.aot_warmup(self, state, batch_sizes)

    def _captures(self) -> bool:
        return graphs_lib.capture_enabled(self.device)

    def _compile(self, state: TrainState, sig) -> None:
        """Warmup's unit of work for one signature: capture it on the
        card, register it elsewhere."""
        if self._captures():
            if state is not self._captured_state:
                self._drop_graphs()
            self._capture(state, sig, self._static_inputs(sig))
        else:
            self._executables.setdefault(sig, None)

    def _note_batch_signature(self, sig) -> None:
        """Flag shape-driven recaptures: every batch signature beyond the
        first costs a capture of the step, and a loop feeding ragged
        batches is capture-bound while looking healthy. Counted as
        ``engine.recompiles`` and warned once per new signature; declared
        ``shape_buckets`` signatures are registered as expected and never
        count."""
        if not obs_state.enabled:
            return
        if sig in self._traced_signatures:
            return
        first = not self._traced_signatures
        self._traced_signatures.add(sig)
        if not first:
            self._recompiles.inc()
            parallax_log.warning(
                "new batch shape signature #%d is captured as a new CUDA "
                "graph of the step (signature: %s); declare "
                "Config.shape_buckets=[...] (or 'auto') so ragged "
                "batches are padded onto a fixed set of bucket shapes",
                len(self._traced_signatures) - 1,
                [(n, s) for n, s, _ in sig])

    def _apply_slices(self, flat, state, captured, row_grads):
        """Scatter-only table updates from the captured slices; duplicate
        ids combine inside the updater."""
        per_path: Dict[str, list] = {}
        for (path, ids, rows), g in zip(captured, row_grads):
            if g is None:
                g = torch.zeros_like(rows)
            per_path.setdefault(path, []).append((ids, g))
        for path, items in per_path.items():
            ids = torch.cat([i.reshape(-1) for i, _ in items])
            drows = torch.cat([d.reshape(-1, d.shape[-1]) for _, d in items])
            self._slice_resolved[path].update(
                flat[path], state.slice_state[path], ids, drows,
                average=self.config.average_sparse)

    def evaluate(self, state: TrainState, batch, seed: int = 0):
        """The loss and metrics of ``batch`` with no gradient (a held-out
        loss): the forward alone, no update; the model state is read and
        left as it was."""
        gen = step_generator(self.device, seed, 0)
        with torch.no_grad():
            loss, metrics, _ = self.model.call_loss(
                state.params, batch, gen, state.model_state)
        return loss, metrics
