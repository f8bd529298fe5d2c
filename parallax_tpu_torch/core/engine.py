"""The hybrid parallelization engine (``parallax_tpu/core/engine.py``:
``Model``, ``TrainState``, ``build_plan``, ``Engine.init_state`` /
``step``, sync and bounded-staleness, ``sparse_wire_bytes_per_step``).

Routing rule (reference: common/runner.py:93-119), over the mesh of
core/mesh.py (one rank per card; one rank and no process group on one
card):

* a replicated variable lives whole on every rank; its gradient is
  all-reduced over the world group in flat buckets, one collective a
  bucket, and averaged over the world size;
* a sparse variable the plan row-shards lives on each rank as its rows
  over 'shard'; ``embedding_lookup`` moves ids and rows through
  all-gather and reduce-scatter (ops/embedding.py), and its backward
  brings each rank the gradient of its own rows from the whole mesh;
* a dense variable the plan row-shards (SHARD, or HYBRID with
  ``PSConfig.replicate_variables=False``) is all-gathered for the loss,
  and its gradient reduce-scattered back onto the shards;
* run_option AR replicates everything, SHARD row-shards whatever
  divides the shard axis, HYBRID follows the class;
  ``Model.param_specs`` overrides by fnmatch (``P()``, the row spec, or
  a tensor-parallel spec);
* a tensor-parallel variable (``ops.tensor_parallel``'s specs, a
  ``mesh.TPSpec`` or a column spec ``P(None, 'shard')``) lives on each
  rank as its column or row shard and is used as it is, never gathered
  (the Megatron products of ``ops.tensor_parallel`` take the parts);
* an expert weight (``mesh.ExpertSpec``, as ``models/moe_lm.py``
  declares its ``moe_w1``/``moe_w2``) lives on each rank as its E/n
  experts and is used as it is, never gathered: ``ops.moe.switch_moe``
  dispatches the tokens to them through an all-to-all over 'shard',
  whose backward brings their gradient summed over the shard group; the
  engine sums it over 'repl' and averages it over the world as every
  other gradient.
  The engine tells an expert weight from a sparse table by the spec's
  type alone: the JAX package's plain ``P('shard', None, None)`` stays a
  row-sharded variable here (a table looked up through
  ``embedding_lookup``, or a dense variable gathered for use), and an
  ``ExpertSpec`` on a variable the classifier finds sparse is refused.
  An expert count that does not divide the shard axis warns and
  replicates (``switch_moe`` then runs its dense path), as in JAX.

Every gradient that crosses ranks is averaged over the ranks the batch
is split over: the world, or the repl group where ``Model.batch_specs``
put the batch on 'repl' alone (JAX's ``_feed_process_scale``,
engine.py:844-860: each rank feeds its repl row's share, alike across
its shard group). Losses normalised over the batch use
``ops.collectives.global_sum`` so that this gives the JAX package's
gradients of the global loss. With the batch on 'repl' alone, the ranks
of a shard group compute alike gradients for every replicated variable
(the tensor-parallel operators sum the parts inside the backward), so a
replicated or tensor-parallel gradient is all-reduced over the repl
group only; a row-sharded one is summed over the mesh by its backward
(the lookup reads each rank's chunk of the ids, ops/embedding.py) and
scaled. Tensor parallelism needs the batch on 'repl' alone where the
shard axis is wider than 1. Under the sequence layout (``P('repl',
'shard')``, JAX's ``long_context.py:495-505``) each rank of a shard group
is fed its repl row's whole rows and computes on its own block of the
sequence (``collectives.shard_index``): the tokens are split over the
world as in the default layout, so every replicated gradient, a partial
one on each rank (``pos``'s rows differ by block), is summed over the
world by the flat all-reduce and averaged as there, and ``global_sum``
reduces over the world. The routes per update path:

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
``params`` get gradients (engine.py:636, :719). On more than one rank it
is refused: the JAX package takes BatchNorm statistics over the global
batch, and cross-rank BatchNorm is not ported.

``sync=False`` is bounded-staleness delayed-gradient training
(engine.py:575-677): each step applies the gradients computed
``Config.staleness`` steps earlier, kept in one pending buffer a
variable at k = 1 and in a ring of k at k > 1; the first k steps apply
zeros.

Per-rank state: every rank initialises the whole tree from the same
generator and keeps its own rows of each row-sharded leaf, with the
optimizer and slice state of those rows. Every rank seeds the step's
generator identically, so sampled candidates and dropout masks agree
across ranks.

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

On the card the collectives are NCCL's and are captured inside the
step's graph (the capture's eager call runs them first, which sets up
the communicators; every rank captures in the same order). A declared
``dedup_capacity`` below the exact bound needs a host read of the
mesh-uniform overflow flag each step, so such an engine runs its steps
eagerly (``compile_stats()["step_capture"]`` says so).

Not ported: pipeline parallelism (``value_and_grad_fn``,
``pipeline_info``), ``batch_specs`` other than the default, 'repl'
alone on dim 0 and ``P('repl', 'shard')``, tensor parallelism with
``sparse_grad_mode="slices"``, and the numerics observatory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from parallax_tpu_torch.common import consts
from parallax_tpu_torch.common.config import ParallaxConfig
from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.compile import bucketing, graphs as graphs_lib, \
    warmup as warmup_lib
from parallax_tpu_torch.core import classify, mesh as mesh_lib, \
    optim, specs as specs_lib
from parallax_tpu_torch.obs import _state as obs_state
from parallax_tpu_torch.obs import metrics as obs_metrics, trace
from parallax_tpu_torch.ops import collectives, embedding
from parallax_tpu_torch.tune import costmodel

REPLICATED = "replicated"
ROW_SHARDED = "row_sharded"
# tensor-parallel: each rank keeps and uses its part (last dim / dim 0)
TP_COLUMN = "tp_column"
TP_ROW = "tp_row"
TP_PLACEMENTS = (TP_COLUMN, TP_ROW)
# expert-parallel: each rank keeps and uses its E/n experts (dim 0)
EXPERT = "expert_sharded"
# placements a rank computes with as it holds them (never gathered)
LOCAL_PLACEMENTS = TP_PLACEMENTS + (EXPERT,)


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
    * ``param_specs``: path pattern (fnmatch) -> ``core.mesh.P`` override
      of the plan: ``P()`` replicates, ``P('shard', None, ...)``
      row-shards (gathered for use), a ``TPSpec`` or ``P(None, ...,
      'shard')`` is tensor-parallel (``ops.tensor_parallel``'s specs),
      an ``ExpertSpec`` expert-parallel (``ops.moe``'s expert weights).
    * ``batch_specs``: feed name -> spec of that feed; dim 0 on
      ``('repl', 'shard')`` (the default), on ``'repl'`` alone, or
      ``P('repl', 'shard')``: the batch on 'repl' and the sequence (dim
      1) on 'shard' (the sequence layout of the long-context LM).
    * ``value_and_grad_fn``, ``pipeline_info``: kept for the JAX
      package's signature; not ported (the engine refuses a model that
      sets one).
    * A row-sharded table must be read through ``embedding_lookup``: a
      rank holds only its rows.
    """

    def __init__(self, init_fn: Callable, loss_fn: Callable,
                 optimizer: Optional[optim.GradientTransformation] = None,
                 sparse_params: Sequence[str] = (),
                 dense_params: Sequence[str] = (),
                 stateful: bool = False,
                 batch_specs: Optional[Dict[str, Any]] = None,
                 param_specs: Optional[Dict[str, Any]] = None,
                 slice_updaters: Optional[Dict[str, Any]] = None,
                 value_and_grad_fn: Optional[Callable] = None,
                 pipeline_info: Optional[Dict[str, Any]] = None):
        self.batch_specs = dict(batch_specs or {})
        self.param_specs = dict(param_specs or {})
        self.value_and_grad_fn = value_and_grad_fn
        self.pipeline_info = dict(pipeline_info) if pipeline_info else None
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
    # sync=False only: {path: the pending gradient} (k = 1) or {path:
    # a ring [k, ...] of them, oldest first} (k > 1)
    pending_grads: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ShardingPlan:
    """Resolved placement: one placement per parameter path."""

    mesh: mesh_lib.Mesh
    var_specs: Dict[str, specs_lib.VariableSpec]
    placements: Dict[str, str]
    # tensor-parallel variables: path -> groups of the split dim
    tp_groups: Dict[str, int] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        return specs_lib.summarize(self.var_specs)

    @property
    def sharded_tables(self) -> List[str]:
        """Sparse variables the plan row-shards: the collective lookup's
        tables."""
        return [p for p, v in self.var_specs.items()
                if v.is_sparse and self.placements[p] == ROW_SHARDED]

    @property
    def gathered(self) -> List[str]:
        """Dense variables the plan row-shards: all-gathered for use."""
        return [p for p, v in self.var_specs.items()
                if not v.is_sparse and self.placements[p] == ROW_SHARDED]

    @property
    def sharded_shapes(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(self.var_specs[p].shape for p in self.sharded_tables)

    @property
    def split(self) -> List[str]:
        """Variables a rank holds a part of (row shards and tensor-
        parallel shards)."""
        return [p for p, pl in self.placements.items() if pl != REPLICATED]


def step_seed(seed: int, step: int) -> int:
    """The seed of one step, from the run's seed and the step counter
    (the counterpart of ``fold_in(PRNGKey(seed + 1), step)``)."""
    return ((seed + 1) * 0x9E3779B97F4A7C15 + step) & 0x7FFFFFFFFFFFFFFF


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """A fresh generator seeded for one step (``step_seed``)."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


def _spec_placement(spec, shape, p: int, path: str) -> Optional[str]:
    """The placement a ``param_specs`` override asks for: REPLICATED for
    ``P()``, ROW_SHARDED for the row spec, EXPERT for an ``ExpertSpec``
    (None for either when dim 0 does not divide the shard axis), TP_ROW
    for a row ``TPSpec`` and TP_COLUMN for a column spec; any other
    layout raises."""
    entries = tuple(mesh_lib.resolve_spec(spec))
    tp = isinstance(spec, mesh_lib.TPSpec)
    if all(e is None for e in entries):
        return REPLICATED
    if isinstance(spec, mesh_lib.ExpertSpec):
        if entries[0] != mesh_lib.AXIS_SHARD or len(entries) > len(shape) \
                or any(e is not None for e in entries[1:]):
            raise ValueError(f"expert spec {spec!r} for {path}: only dim 0 "
                             f"(the experts) splits over 'shard'")
        if shape[0] % p:
            parallax_log.warning(
                "param_specs override for %s: dim 0 (%d) not divisible by "
                "shard (%d); replicating", path, shape[0], p)
            return None
        return EXPERT if p > 1 else REPLICATED
    if len(entries) > len(shape):
        raise ValueError(f"param_specs override {spec!r} for {path}: "
                         f"{len(entries)} entries for a {len(shape)}-d "
                         f"variable {tuple(shape)}")
    # trailing dims a spec leaves out are unsplit, as in JAX
    entries += (None,) * (len(shape) - len(entries))
    on = [i for i, e in enumerate(entries) if e is not None]
    if len(on) != 1 or entries[on[0]] != mesh_lib.AXIS_SHARD \
            or on[0] not in (0, len(entries) - 1):
        raise NotImplementedError(
            f"param_specs override {spec!r} for {path}: only P(), the "
            f"row spec P('shard', None, ...) and the tensor-parallel "
            f"column and row specs are ported")
    dim = on[0]
    column = dim == len(entries) - 1 and dim > 0
    if not (tp or column):
        if shape[0] % p == 0:
            return ROW_SHARDED if p > 1 else REPLICATED
        parallax_log.warning(
            "param_specs override for %s: dim 0 (%d) not divisible by "
            "shard (%d); replicating", path, shape[0], p)
        return None
    groups = getattr(spec, "groups", 1)
    if shape[dim] % (groups * p):
        raise ValueError(
            f"tensor-parallel {spec!r} for {path}: dim {dim} ({shape[dim]}) "
            f"does not split into {groups} block(s) over {p} shard(s)")
    if p == 1:
        return REPLICATED
    return TP_COLUMN if column else TP_ROW


def build_plan(model: Model, mesh: mesh_lib.Mesh, config: ParallaxConfig,
               meta_params, meta_batch, meta_state=None) -> ShardingPlan:
    """Classify variables (one recorded forward on meta tensors) and
    choose a placement for each (the 'graph transform', reference
    engine.py:204-302). The model state's leaves are inputs of that
    forward, not variables: they are not classified."""
    var_specs = classify.classify_params(
        model.call_loss, meta_params, meta_batch, torch.Generator(),
        meta_state, sparse_override=model.sparse_params,
        dense_override=model.dense_params)
    p = mesh_lib.num_shards(mesh)
    replicate_dense = \
        config.communication_config.ps_config.replicate_variables

    def choose(path, vs: specs_lib.VariableSpec) -> str:
        shardable = len(vs.shape) >= 1 and vs.shape[0] % p == 0 and p > 1
        if config.run_option == consts.RUN_AR:
            return REPLICATED
        if config.run_option == consts.RUN_SHARD:
            return ROW_SHARDED if shardable else REPLICATED
        if vs.is_sparse and shardable:
            return ROW_SHARDED
        if vs.is_sparse and p > 1:
            parallax_log.warning(
                "sparse variable %s has leading dim %s not divisible by "
                "shard axis %d; replicating (pad with "
                "ops.embedding.pad_vocab to shard it)", path,
                vs.shape[:1], p)
        if not vs.is_sparse and not replicate_dense and shardable:
            return ROW_SHARDED
        return REPLICATED

    tp_groups = {}

    def with_override(path, vs, placement):
        for pattern, spec in model.param_specs.items():
            if fnmatch.fnmatch(path, pattern):
                chosen = _spec_placement(spec, vs.shape, p, path)
                if chosen in TP_PLACEMENTS:
                    tp_groups[path] = getattr(spec, "groups", 1)
                return chosen or placement
        return placement

    placements = {path: with_override(path, vs, choose(path, vs))
                  for path, vs in var_specs.items()}
    tables = [path for path, pl in placements.items()
              if pl == EXPERT and var_specs[path].is_sparse]
    if tables:
        raise ValueError(
            f"expert specs on {tables}, which the loss reads only through "
            f"embedding_lookup (sparse tables): an expert weight is a "
            f"dense operand of ops.moe.switch_moe")
    plan = ShardingPlan(mesh, var_specs, placements, tp_groups)
    for path, vs in var_specs.items():
        if vs.shape in plan.sharded_shapes and not vs.is_sparse:
            parallax_log.warning(
                "dense variable %s shares shape %s with a row-sharded "
                "sparse variable (the JAX package would route its lookups "
                "through the collective path; here lookups route by "
                "tensor, so nothing is misrouted)", path, vs.shape)
    parallax_log.info("sharding plan: %s (run_option=%s, mesh %dx%d, "
                      "row-sharded %s, tensor-parallel %s)", plan.describe(),
                      config.run_option, mesh.repl, p, sorted(
                          q for q, pl in placements.items()
                          if pl == ROW_SHARDED), sorted(tp_groups))
    return plan


BATCH = "batch"          # the default: dim 0 over ('repl', 'shard')
REPL = "repl"            # dim 0 over 'repl' alone (tensor parallelism)
SEQUENCE = "sequence"    # dim 0 over 'repl', dim 1 over 'shard'


def _feed_layout(name: str, spec) -> str:
    """The layout one feed's ``batch_specs`` entry asks for; a layout
    that is not ported raises."""
    if spec is None:
        return BATCH
    spec = mesh_lib.resolve_spec(spec)
    axes = mesh_lib.dim0_axes(spec)
    rest = [e for e in tuple(spec)[1:] if e is not None]
    if not rest:
        if tuple(axes) == mesh_lib.BATCH_AXES:
            return BATCH
        if tuple(axes) == (mesh_lib.AXIS_REPL,):
            return REPL
    elif tuple(axes) == (mesh_lib.AXIS_REPL,) \
            and tuple(spec)[1] == mesh_lib.AXIS_SHARD and len(rest) == 1:
        return SEQUENCE
    raise NotImplementedError(
        f"batch_specs[{name!r}] = {spec!r}: only the default ('repl', "
        f"'shard') on dim 0, 'repl' alone on dim 0, and P('repl', "
        f"'shard') (the batch over 'repl', the sequence over 'shard') "
        f"are ported")


def _batch_layout(model: Model, example_batch) -> str:
    """The layout ``Model.batch_specs`` gives every feed of the example
    batch: ``BATCH`` (the default), ``REPL`` (the batch on 'repl' alone)
    or ``SEQUENCE`` (``P('repl', 'shard')``: the batch on 'repl', dim 1
    on 'shard'). A spec with an axis past dim 0 is read past dim 0, never
    as its dim 0 alone; feeds of different layouts raise."""
    if not model.batch_specs:
        return BATCH
    names = list(example_batch) if isinstance(example_batch, dict) else []
    kinds = {name: _feed_layout(name, model.batch_specs.get(name))
             for name in names}
    if len(set(kinds.values())) > 1:
        raise NotImplementedError(
            f"batch_specs give the feeds different layouts: {kinds}; one "
            f"layout for every feed is ported")
    return next(iter(kinds.values()), BATCH)


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
    optimizer, model and slice states, the pending gradients."""
    return [leaf for _, leaf in classify.flatten(
        [state.params, state.opt_state, state.model_state,
         state.slice_state, state.pending_grads])
        if isinstance(leaf, torch.Tensor)]


def _with_leaves(tree, leaves: Dict[str, Any], prefix: str = ""):
    """A copy of the nested dict/list ``tree`` with the leaves at the
    paths of ``leaves`` replaced (the rest shared)."""
    if isinstance(tree, dict):
        return {k: _with_leaves(v, leaves, f"{prefix}/{k}" if prefix
                                else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_leaves(v, leaves, f"{prefix}/{i}" if prefix
                                       else str(i))
                          for i, v in enumerate(tree))
    return leaves.get(prefix, tree)


class _ShardReads(TorchFunctionMode):
    """Records every torch call that reads one of the watched tensors
    (``{id: path}``) outside the sharded lookup; metadata queries are not
    reads."""

    def __init__(self, watched: Dict[int, str]):
        super().__init__()
        self.watched = watched
        self.found: Dict[str, set] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if not embedding.in_sharded_lookup() and name != "__get__" \
                and func not in classify._METADATA:
            for x in list(args) + list(kwargs.values()):
                for leaf in (x if isinstance(x, (list, tuple)) else (x,)):
                    path = self.watched.get(id(leaf)) \
                        if isinstance(leaf, torch.Tensor) else None
                    if path is not None:
                        self.found.setdefault(path, set()).add(name)
        return func(*args, **kwargs)


def _host_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


class Engine:
    """Owns the plan, the optimizer grouping and the train step of one
    rank of the mesh."""

    def __init__(self, model: Model, mesh: mesh_lib.Mesh,
                 config: ParallaxConfig, example_batch,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None):
        missing = [name for name, v in (
            ("value_and_grad_fn", model.value_and_grad_fn),
            ("pipeline_info", model.pipeline_info)) if v]
        if missing:
            raise NotImplementedError(
                f"Model.{', '.join(missing)}: pipeline parallelism is not "
                f"ported")
        if model.stateful and mesh.size > 1:
            raise NotImplementedError(
                f"a stateful model on {mesh.size} ranks: cross-rank "
                f"BatchNorm (statistics over the global batch) is not "
                f"ported; run it on one rank")
        if config.sync and int(config.staleness) > 1:
            raise ValueError(
                f"staleness={config.staleness} has no effect with "
                f"sync=True; pass sync=False to parallel_run for "
                f"bounded-staleness training")
        if not config.sync:
            parallax_log.info(
                "sync=False: bounded-staleness delayed-gradient training "
                "(each step applies the gradients computed %d step(s) "
                "earlier)", int(config.staleness))
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
        self.batch_layout = _batch_layout(model, example_batch)
        self._batch_on_repl = self.batch_layout == REPL
        experts = [p for p, pl in self.plan.placements.items()
                   if pl == EXPERT]
        if experts and self.batch_layout != BATCH:
            raise NotImplementedError(
                f"expert-parallel param_specs ({experts}) with the "
                f"{self.batch_layout!r} batch layout: the MoE dispatch "
                f"takes each rank's own rows (the default layout)")
        if self.plan.tp_groups and not self._batch_on_repl:
            raise NotImplementedError(
                f"tensor-parallel param_specs ({sorted(self.plan.tp_groups)}"
                f") on a shard axis of {mesh.shard}: the shard group must "
                f"hold the same rows; declare batch_specs that put every "
                f"feed on 'repl' alone")
        self._batch_group = mesh.repl_group if self._batch_on_repl \
            else mesh.world
        self._lookup_records: list = []
        self._slice_resolved = self._resolve_slice_updaters()
        self._guarded = self._meta_pass(meta_params, meta_batch) \
            if self._slice_resolved or self.plan.sharded_tables else []
        if self._guarded:
            parallax_log.warning(
                "dedup_capacity below the exact bound for %s: each step "
                "reads the mesh-uniform overflow flag on the host, so the "
                "steps run eagerly (no CUDA graph)", self._guarded)
        if self._slice_resolved and not config.sync:
            raise ValueError(
                "sparse_grad_mode='slices' requires sync=True (the "
                "delayed-gradient emulation stashes dense gradients)")
        if self._slice_resolved and self._batch_on_repl:
            raise NotImplementedError(
                "sparse_grad_mode='slices' with batch_specs on 'repl' "
                "alone is not ported (the slices gather over the world)")
        self._dense_paths = [p for p in self.plan.var_specs
                             if p not in self._slice_resolved]
        self.metrics.counter("engine.builds").inc()

    def _lookup_scope(self, flat, records):
        """The sharded-lookup scope of a step over the leaves ``flat``
        (this rank's row shards, or meta tensors of whole tables)."""
        ps = self.config.communication_config.ps_config
        return embedding.sharded_lookup_scope(
            self.mesh, [(flat[p], self.plan.var_specs[p].shape, p)
                        for p in self.plan.sharded_tables],
            self.config.average_sparse, records,
            local_aggregation=ps.local_aggregation,
            dedup_capacity=ps.dedup_capacity,
            cross_replica_sparse=ps.cross_replica_sparse,
            batch_on_repl=self._batch_on_repl)

    def _meta_pass(self, meta_params, meta_batch):
        """One forward on meta tensors under the step's scopes (the
        reference's abstract discovery pass, engine.py:506-536). Refuses a
        slice table that no ``embedding_lookup`` reads (a gather other
        than it would never be captured, so the table never updated) and
        a row-sharded table that the loss reads other than through
        ``embedding_lookup`` (a rank holds only its rows). Returns the
        tables whose lookups a declared ``dedup_capacity`` guards."""
        # the loss reads a tensor-parallel or expert weight as this rank's
        # part; a row-sharded leaf stays whole (a table's lookup takes the
        # whole shape; a dense one is gathered whole for use)
        meta_params = self._local_tree(meta_params, LOCAL_PLACEMENTS)
        flat = dict(classify.flatten(meta_params))
        cap = embedding.SliceCapture(
            {id(flat[p]): p for p in self._slice_resolved})
        reads = _ShardReads({id(flat[p]): p
                             for p in self.plan.sharded_tables})
        with torch.no_grad(), embedding.slice_capture_scope(cap), \
                self._lookup_scope(flat, None) as lctx, reads:
            self.model.call_loss(meta_params, meta_batch, torch.Generator())
        missing = set(self._slice_resolved) - {p for p, _, _ in cap.captured}
        if missing:
            raise ValueError(
                f"slice_updaters registered for {sorted(missing)} but no "
                f"embedding_lookup of those tables was traced; their "
                f"gradients would be silently lost")
        if reads.found:
            raise ValueError(
                f"row-sharded tables read other than through "
                f"embedding_lookup: { {p: sorted(f) for p, f in
                                       sorted(reads.found.items())} }; a "
                f"rank holds only its rows of each (pass the table itself "
                f"to embedding_lookup, or Model(dense_params=...) to "
                f"replicate it)")
        return sorted(set(lctx.guarded))

    def _resolve_slice_updaters(self) -> Dict[str, Any]:
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
        parallax_log.info("sparse_grad_mode=slices over %s", sorted(resolved))
        return resolved

    # -- state ------------------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        """The whole tree from the seed's generator (the same on every
        rank), then this rank's rows of each row-sharded leaf, with the
        optimizer, slice and pending state of what it keeps."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params, model_state = self.model.call_init(gen, self.device)
        params = self._local_tree(params)
        flat = dict(classify.flatten(params))
        for path in self._dense_paths:
            flat[path].requires_grad_(True)
        with torch.no_grad():
            opt_state = self.model.optimizer.init(
                {p: flat[p] for p in self._dense_paths})
            slice_state = {p: upd.init(flat[p])
                           for p, upd in self._slice_resolved.items()} \
                or None
            pending = None
            if not self.config.sync:
                k = int(self.config.staleness)
                pending = {p: torch.zeros(((k,) if k > 1 else ())
                                          + tuple(flat[p].shape),
                                          dtype=flat[p].dtype,
                                          device=self.device)
                           for p in self._dense_paths}
        return TrainState(step=0, params=params, opt_state=opt_state,
                          seed=seed, model_state=model_state,
                          slice_state=slice_state, pending_grads=pending)

    def local_part(self, path: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of variable ``path`` from the whole one, as its
        own tensor: its rows of a row-sharded or row-parallel leaf, its
        experts of an expert-parallel one, its columns of a
        column-parallel one (of each of its ``groups`` blocks, in block
        order), the whole of a replicated one."""
        placement = self.plan.placements[path]
        if placement == REPLICATED:
            return whole
        p, s = self.mesh.shard, self.mesh.coords[1]
        if placement == TP_COLUMN:
            g = self.plan.tp_groups[path]
            blocks = whole.reshape(whole.shape[:-1] + (g, -1))
            n = blocks.shape[-1] // p
            part = blocks[..., s * n:(s + 1) * n]
            return part.reshape(whole.shape[:-1] + (g * n,)).detach() \
                .clone()
        n = whole.shape[0] // p
        return whole[s * n:(s + 1) * n].detach().clone()

    def _local_tree(self, params, placements=None):
        """``params`` (whole leaves) as this rank holds them (only the
        leaves of ``placements``, when given)."""
        split = [p for p in self.plan.split if placements is None
                 or self.plan.placements[p] in placements]
        if not split:
            return params
        flat = dict(classify.flatten(params))
        return _with_leaves(params, {p: self.local_part(p, flat[p])
                                     for p in split})

    def _whole(self, path: str, part: torch.Tensor) -> torch.Tensor:
        """Variable ``path`` gathered whole from the shard group's parts
        (``local_part``'s inverse; a collective)."""
        group = self.mesh.shard_group
        if self.plan.placements[path] != TP_COLUMN:
            return collectives.all_gather(part, group)
        g, p = self.plan.tp_groups[path], self.mesh.shard
        cols = collectives.all_gather(part.movedim(-1, 0), group)
        # [p * g * n, ...] in (rank, block, column) order -> (block, rank,
        # column)
        cols = cols.reshape((p, g, -1) + tuple(cols.shape[1:]))
        return cols.transpose(0, 1).reshape((-1,) + tuple(cols.shape[3:])) \
            .movedim(0, -1).contiguous()

    def gather_params(self, state: TrainState):
        """The parameter tree with every split leaf (row-sharded, tensor-
        parallel) gathered whole in the JAX package's global layout (a
        collective: every rank calls it); the rest as they are."""
        flat = dict(classify.flatten(state.params))
        with torch.no_grad():
            return _with_leaves(state.params, {
                p: self._whole(p, flat[p]) for p in self.plan.split})

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
        if static and self._captures():
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
            if self._captures():
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

    def _loss_view(self, state: TrainState, flat):
        """The parameters the loss reads: row-sharded dense leaves
        gathered whole (their gradient reduce-scattered back), the rest
        (row-sharded tables too) as this rank holds them."""
        gathered = self.plan.gathered
        if not gathered:
            return state.params
        return _with_leaves(state.params, {
            p: collectives.gather_rows(flat[p], self.mesh)
            for p in gathered})

    def _compute(self, state: TrainState, batch) -> Dict[str, Any]:
        """The step's device work, every state tensor written in place:
        forward, gradients, their combine across ranks, the optimizer,
        the slice updates and the new model state. Returns the loss and
        metrics (tensors on the device)."""
        flat = dict(classify.flatten(state.params))
        cap = None
        scope = contextlib.nullcontext()
        if self._slice_resolved:
            cap = embedding.SliceCapture(
                {id(flat[p]): p for p in self._slice_resolved})
            scope = embedding.slice_capture_scope(cap)
        self._lookup_records = records = []
        with scope, self._lookup_scope(flat, records):
            loss, metrics, new_model_state = self.model.call_loss(
                self._loss_view(state, flat), batch, self._gen,
                state.model_state)
        leaves = [flat[p] for p in self._dense_paths]
        rows = [r for _, _, r in cap.captured] if cap is not None else []
        grads = torch.autograd.grad(loss, leaves + rows, allow_unused=True)
        with torch.no_grad():
            dense = {p: (g if g is not None else torch.zeros_like(flat[p]))
                     for p, g in zip(self._dense_paths, grads)}
            self._combine(dense)
            apply = dense
            if not self.config.sync:
                apply = self._delayed(state, dense)
            with optim.sharded_scope(self.plan.split, self.mesh):
                updates, _ = self.model.optimizer.update(
                    apply, state.opt_state,
                    {p: flat[p] for p in self._dense_paths})
            optim.apply_updates(flat, updates)
            if not self.config.sync:
                self._push_pending(state, dense)
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

    def _combine(self, dense: Dict[str, torch.Tensor]) -> None:
        """Average the dense gradients over the ranks the batch is split
        over, in place: replicated and tensor-parallel ones all-reduced
        in flat buckets over that group (the world, or the repl group when
        the batch rides 'repl' alone; a process group of one rank runs
        the collective too); expert shards, which the dispatch's backward
        summed over 'shard', all-reduced over 'repl' and scaled alike;
        row-shard gradients, which their backward already summed over
        the mesh, scaled alone."""
        group = self._batch_group
        if group is None:
            return
        scale = 1.0 / group.size if group.size > 1 else None
        collectives.flat_all_reduce_(
            [g for p, g in dense.items()
             if self.plan.placements[p] not in (ROW_SHARDED, EXPERT)],
            group, scale)
        experts = [g for p, g in dense.items()
                   if self.plan.placements[p] == EXPERT]
        if experts:
            collectives.flat_all_reduce_(experts, self.mesh.repl_group,
                                         scale)
        shards = [g for p, g in dense.items()
                  if self.plan.placements[p] == ROW_SHARDED]
        if shards and scale is not None:
            torch._foreach_mul_(shards, scale)

    def _delayed(self, state: TrainState, grads) -> Dict[str, Any]:
        """The gradients due this step under ``sync=False``: the pending
        buffer (k = 1) or the ring's oldest slot (k > 1)."""
        k = int(self.config.staleness)
        return {p: (b if k == 1 else b[0])
                for p, b in state.pending_grads.items()}

    def _push_pending(self, state: TrainState, grads) -> None:
        """This step's gradients into the pending buffer, or onto the
        ring's newest slot with the rest moved one older."""
        k = int(self.config.staleness)
        for p, b in state.pending_grads.items():
            if k == 1:
                b.copy_(grads[p])
            else:
                b.copy_(torch.cat([b[1:], grads[p][None]]))

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
        return graphs_lib.capture_enabled(self.device) and not self._guarded

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
        ids combine inside the updater. On a mesh the step's slices are
        gathered from every rank (averaged over the world size, as every
        gradient that crosses ranks is) and each rank updates the rows it
        holds, its ids shifted to its shard."""
        per_path: Dict[str, list] = {}
        for (path, ids, rows), g in zip(captured, row_grads):
            if g is None:
                g = torch.zeros_like(rows)
            per_path.setdefault(path, []).append((ids, g))
        world = self.mesh.world
        for path, items in per_path.items():
            ids = torch.cat([i.reshape(-1).long() for i, _ in items])
            drows = torch.cat([d.reshape(-1, d.shape[-1]) for _, d in items])
            if world is not None and world.size > 1:
                ids = collectives.all_gather(ids, world)
                drows = collectives.all_gather(drows, world) \
                    * (1.0 / world.size)
            if self.plan.placements[path] == ROW_SHARDED:
                ids = ids - self.mesh.coords[1] * flat[path].shape[0]
            self._slice_resolved[path].update(
                flat[path], state.slice_state[path], ids, drows,
                average=self.config.average_sparse)

    def sparse_wire_bytes_per_step(self) -> Dict[str, Any]:
        """Bytes on the wire a step for the sparse path against the dense
        alternative (BASELINE's "sparse-grad bytes on wire"; reference
        engine.py:998-1064), from one record per sharded lookup of the
        last traced step, over ``tune/costmodel.py``'s formulas. Exact but
        for a guarded ``dedup_capacity``, where it is a lower bound (an
        overflowing step ships the uncompressed exchange). Mesh totals:
        every rank reports the same numbers."""
        if not self._lookup_records and self.plan.sharded_tables:
            raise RuntimeError(
                "sparse_wire_bytes_per_step() called before any step "
                "was traced; run at least one session step first")
        sparse_bytes = 0
        per_lookup = []
        for tshape, n_ids, n_cnt, repl_bytes, sparse_repl, elem in \
                self._lookup_records:
            sparse_bytes += costmodel.lookup_wire_bytes(
                tshape, n_ids, n_cnt, repl_bytes, elem)
            per_lookup.append({
                "table_shape": tshape, "ids_on_wire": n_ids,
                "counts_on_wire": n_cnt, "cross_replica_bytes": repl_bytes,
                "cross_replica_sparse": sparse_repl, "elem_bytes": elem})
        dense_bytes = 0
        for path in self.plan.sharded_tables:
            vs = self.plan.var_specs[path]
            e = torch.empty((), dtype=vs.dtype).element_size() \
                if vs.dtype is not None else 4
            dense_bytes += costmodel.dense_alternative_bytes(vs.shape, e)
        return {"sparse_path_bytes": sparse_bytes,
                "dense_allreduce_bytes": dense_bytes,
                "per_lookup": per_lookup}

    def evaluate(self, state: TrainState, batch, seed: int = 0):
        """The loss and metrics of ``batch`` with no gradient (a held-out
        loss): the forward alone, no update; the model state is read and
        left as it was."""
        gen = step_generator(self.device, seed, 0)
        flat = dict(classify.flatten(state.params))
        with torch.no_grad(), self._lookup_scope(flat, None):
            loss, metrics, _ = self.model.call_loss(
                self._loss_view(state, flat), batch, gen,
                state.model_state)
        return loss, metrics
