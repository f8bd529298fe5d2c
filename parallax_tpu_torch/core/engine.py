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
optimizer state and the slice accumulators in place (the JAX step
returns a new state; in place, a step allocates nothing table-sized).
Each step draws its randomness (dropout masks, sampled-softmax
candidates) from a ``torch.Generator`` seeded from the run's seed and
the step counter, the counterpart of ``fold_in(PRNGKey(seed + 1),
step)``.

A stateful model (``Model(stateful=True)``, e.g. BatchNorm statistics)
carries ``TrainState.model_state`` beside the parameters: the loss
returns the new state, which replaces the old after the step; only
``params`` get gradients (engine.py:636, :719). ``sync=False`` (the
delayed-gradient emulation of async PS), the numerics observatory and
multiple ranks are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import inspect
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from parallax_tpu_torch.common import consts
from parallax_tpu_torch.common.config import ParallaxConfig
from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.core import classify, mesh as mesh_lib, \
    optim, specs as specs_lib
from parallax_tpu_torch.obs import metrics as obs_metrics
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


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The generator of one step: seeded from the run's seed and the
    step counter (the counterpart of ``fold_in(PRNGKey(seed + 1),
    step)``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed + 1) * 0x9E3779B97F4A7C15 + step)
                    & 0x7FFFFFFFFFFFFFFF)
    return gen


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


def _to_meta(batch):
    return {k: v.to("meta") for k, v in batch.items()}


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
        meta_params, meta_state = model.call_init(torch.Generator(), "meta")
        meta_batch = _to_meta(example_batch)
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

    # -- the step ---------------------------------------------------------

    def step(self, state: TrainState, batch) -> tuple:
        """One training step on a batch of tensors already on the card.
        Returns (state, outputs); the state is updated in place."""
        gen = step_generator(self.device, state.seed, state.step)
        flat = dict(classify.flatten(state.params))
        cap = None
        scope = contextlib.nullcontext()
        if self._slice_resolved:
            cap = embedding.SliceCapture(
                {id(flat[p]): p for p in self._slice_resolved})
            scope = embedding.slice_capture_scope(cap)
        with scope:
            loss, metrics, new_model_state = self.model.call_loss(
                state.params, batch, gen, state.model_state)
        leaves = [flat[p] for p in self._dense_paths]
        rows = [r for _, _, r in cap.captured] if cap is not None else []
        grads = torch.autograd.grad(loss, leaves + rows, allow_unused=True)
        with torch.no_grad():
            dense = {p: (g if g is not None else torch.zeros_like(flat[p]))
                     for p, g in zip(self._dense_paths, grads)}
            updates, state.opt_state = self.model.optimizer.update(
                dense, state.opt_state,
                {p: flat[p] for p in self._dense_paths})
            optim.apply_updates(flat, updates)
            if cap is not None:
                self._apply_slices(flat, state, cap.captured,
                                   grads[len(leaves):])
        if self.model.stateful:
            state.model_state = new_model_state
        state.step += 1
        self.metrics.counter("engine.steps").inc()
        outputs = {"loss": loss.detach(), "global_step": state.step}
        outputs.update({k: (v.detach() if isinstance(v, torch.Tensor)
                            else v) for k, v in metrics.items()})
        return state, outputs

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
