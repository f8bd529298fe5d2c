"""The hybrid parallelization engine (``parallax_tpu/core/engine.py``:
``Model``, ``TrainState``, ``build_plan``, ``Engine.init_state`` /
``step``, sync and bounded-staleness, ``sparse_wire_bytes_per_step``).

Routing rule (reference: common/runner.py:93-119), over the mesh of
core/mesh.py (one rank per card; one rank and no process group on one
card):

* a replicated variable lives whole on every rank; its gradient is
  all-reduced over the batch group (the world under the default feed
  layout) in flat buckets, one collective a bucket, and averaged over
  its size;
* a sparse variable the plan row-shards lives on each rank as its rows
  over 'shard'; ``embedding_lookup`` moves ids and rows through
  all-gather and reduce-scatter (ops/embedding.py), and its backward
  brings each rank the gradient of its own rows from the whole mesh;
* a dense variable the plan row-shards (SHARD, or HYBRID with
  ``PSConfig.replicate_variables=False``) is all-gathered for the loss,
  and its gradient reduce-scattered back onto the shards;
* run_option AR replicates everything, SHARD row-shards whatever
  divides the shard axis, HYBRID follows the class;
  ``Model.param_specs`` overrides by fnmatch with any spec JAX's
  ``spec_shape_mismatch`` accepts (a dim that does not divide its axes
  warns and keeps the plan's placement, as JAX's ``with_override``
  does): ``P()``, the row spec, a tensor-parallel, expert or stage
  spec, or any other split (a middle dim, 'repl', an axis tuple in
  either order, two dims), which is ``GATHERED``: each rank keeps its
  block, the blocks are all-gathered along each split dim over the
  split axes' group before the forward, and the gradient is summed over
  the batch group and cut back to the block (``collectives.
  gather_param``), then averaged as every other gradient;
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
* a stage-sharded variable (``P('pipe')`` on dim 0, as the pipeline LM
  declares its ``blocks_stacked``) lives on each rank as its rows of
  the stage stack over the mesh's pipeline axis (``mesh.
  pipeline_group``: 'pipe' on a three-axis mesh, else 'shard') and is
  used as it is, never gathered: ``ops/pipeline.py`` runs each rank's
  stages. Expert and stage placements are one kind, a dim-0 split kept
  local over an axis (``ROW_LOCAL``): the gradient of such rows is
  this rank's own and is summed over 'repl' alone, never over the split
  axis, and averaged over the batch group as every other gradient.

Every gradient that crosses ranks is averaged over the ranks the batch
is split over: the group of the mesh axes that dim 0 of the laid-out
feeds rides (``_batch_group``; JAX's ``_feed_process_scale``,
engine.py:844-860: the number of distinct shares, never the world size
of a layout that repeats rows). ``Model.batch_specs`` may give each
feed any layout JAX's ``place_host_batch`` places: dim 0 over both axes
(the default) in either order, over 'repl' alone, over 'shard' alone,
or whole on every rank (``P()``); a split past dim 0 is gathered whole
before the loss, but for the sequence layout ``P('repl', 'shard')``
(JAX's ``long_context.py:495-505``), whose rank computes on its own
block of its repl row's whole rows (``collectives.shard_index``). Each
rank is fed its share as the JAX mesh's device of its coordinates holds
it. Before the loss the engine lays the split feeds onto one layout
(``_relay``): where they share one they stay as fed; feeds of
different layouts meet on their union in the mesh's order (chunked
where a feed repeats rows over an axis of it, gathered over the axes it
lacks); tensor-parallel weights take 'shard' out of it (the shard
group's rows gathered, so the Megatron products see the same rows on
every member); expert weights put every feed, whole ones too, on the
default layout (JAX's ``switch_moe`` splits its tokens over both axes
whatever the feeds' layout). The ranks along the other axes hold the
same rows and compute alike gradients of every replicated variable
(the tensor-parallel operators sum the parts inside the backward), so
such a gradient is all-reduced over the batch group only; a row-sharded
or gathered one is summed by its backward (the lookup reads each rank's
chunk of the ids it repeats, ops/embedding.py) and scaled; expert rows
are summed over 'repl' where the batch rides it. Losses normalised over
the batch use ``ops.collectives.global_sum``, which reduces over the
batch group and scales its backward by its size, so that this gives
the JAX package's gradients of the global loss. Under the sequence
layout the tokens are split over the world as in the default layout,
so every replicated gradient, a partial one on each rank (``pos``'s
rows differ by block), is summed over the world by the flat all-reduce
and averaged as there, and ``global_sum`` reduces over the world. The routes per update path:

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
``params`` get gradients (engine.py:636, :719). On more than one rank
``models/_nn.py``'s BatchNorm takes its statistics over the global batch
(the batch group of the step's mesh scope), as the JAX package's one
program does, so the new state is the same on every rank.

``Model.value_and_grad_fn`` (engine.py:642-656) replaces autograd: the
model returns ``(loss, metrics, grads)`` (the 1F1B pipeline computes its
gradients itself, ``ops.pipeline.pipeline_value_and_grad``), inside the
step's lookup and mesh scope. Its gradients are this rank's, as autograd
would give them, and go through the same combine across ranks.
``pipeline_info`` is kept on the Model for the tuner. The JAX engine's
``_guard_persistent_cache_for_pipeline`` (engine.py:302-340) works round
a crash of XLA:CPU reloading cached pipeline executables and has no
counterpart here.

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

Batches a prefetch thread places ahead (``stage``, the session's
``place_batch``) go through a ring of staging slots, pinned host and
device buffers reused slot by slot (the ring grows to the number of
staged batches held at once: ``Config.prefetch_depth`` + 2 under
``run_iter``), copied to the card on a side stream;
each step waits on its slot's event and copies it into the static input
buffers on its own stream, so a batch staged ahead never overwrites the
inputs of a step not yet dispatched. Under ``Config.monitor_health`` the
step also outputs ``grad_norm`` and ``loss_finite``
(``parallax_tpu/core/engine.py:724-739``), computed inside the graph.

Under ``Config.numerics_interval`` (``parallax_tpu/core/engine.py:
740-762``; obs/numwatch.py) every signature has a second graph that
also computes the per-layer stats (a ``[layers, 6]`` tensor, read as a
``numwatch.StatsTree``; a split leaf's terms are its part's, summed
over the group it is split over, its gradient's absmax the group's
max, so every rank gets the whole parameters' stats, and a sliced
table's touched rows are the ids of every share of the batch, as its
update applies them): the host replays it every ``numerics_interval``
steps and the plain graph otherwise, whose ``numerics`` output is the
host zeros tree. ``trip_numerics`` computes a non-finite step's stats
after it from the gradients the step's graph left in its buffers; the
JAX engine forces the sample inside the step. With the interval 0 or
the obs layer off there is no second graph and no output. ``count_step_
flops`` counts a step's matmuls on meta tensors (``step_flops``).

On the card the collectives are NCCL's and are captured inside the
step's graph (the capture's eager call runs them first, which sets up
the communicators; every rank captures in the same order). A declared
``dedup_capacity`` below the exact bound needs a host read of the
mesh-uniform overflow flag each step, so such an engine runs its steps
eagerly (``compile_stats()["step_capture"]`` says so).

The tuner's and the profiler's hooks: ``step_cost_analysis`` (the
counterpart of the JAX engine's XLA ``cost_analysis``, which
``tune.costmodel.inputs_from_engine`` reads) counts one step on meta
tensors, its matmuls (``count_step_flops``) and the input and output
bytes of its ops, unfused (``count_step_bytes``); that pass also fills
the lookup records before any step has run. The step's parts run under
``torch.profiler.record_function`` scopes named after their source files
(the model's file around the loss, ``engine.py`` around the combine,
``optim.py`` around the update, ``sparse_optim.py`` around the slice
updates; the lookups, the sampled softmax and the LSTM scan open their
own), and ``scope_index`` maps each kernel name to its scope from a
profiled warm call of a capture. ``step_captures`` tells the profile hook
which step would capture.

Refused: tensor-parallel weights with the sequence layout on a shard
axis wider than 1 (both split over 'shard'), expert weights with the
sequence layout or with tensor-parallel weights, and a general split
or a feed relayout on a three-axis mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import inspect
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from parallax_tpu_torch.common import consts
from parallax_tpu_torch.common.config import ParallaxConfig
from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.compile import bucketing, graphs as graphs_lib, \
    warmup as warmup_lib
from parallax_tpu_torch.core import classify, mesh as mesh_lib, \
    optim, specs as specs_lib
from parallax_tpu_torch.obs import _state as obs_state
from parallax_tpu_torch.obs import metrics as obs_metrics, trace
from parallax_tpu_torch.obs import numwatch
from parallax_tpu_torch.ops import _cuda, collectives, embedding
from parallax_tpu_torch.tune import costmodel

REPLICATED = "replicated"
ROW_SHARDED = "row_sharded"
# tensor-parallel: each rank keeps and uses its part (last dim / dim 0)
TP_COLUMN = "tp_column"
TP_ROW = "tp_row"
TP_PLACEMENTS = (TP_COLUMN, TP_ROW)
# expert-parallel: each rank keeps and uses its E/n experts (dim 0)
EXPERT = "expert_sharded"
# pipeline stages: each rank keeps and uses its rows of the stage stack
STAGE = "stage_sharded"
# dim-0 splits kept local over one axis: their gradient is the rank's own
ROW_LOCAL = (EXPERT, STAGE)
# any other split (a middle dim, 'repl', an axis tuple, two dims): the
# parts gathered whole for use, the gradient summed back onto them
GATHERED = "gathered"
# placements a rank computes with as it holds them (never gathered)
LOCAL_PLACEMENTS = TP_PLACEMENTS + ROW_LOCAL


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
      an ``ExpertSpec`` expert-parallel (``ops.moe``'s expert weights),
      ``P('pipe')`` stage-sharded (``ops.pipeline``'s stage stacks), and
      any other split, e.g. ``P(None, 'shard', None)``, ``P('repl',
      None)``, ``P(('repl', 'shard'), None)`` or ``P('repl', None,
      'shard')``, is gathered for use.
    * ``batch_specs``: feed name -> spec of that feed; dim 0 on
      ``('repl', 'shard')`` (the default) or ``('shard', 'repl')``, on
      ``'repl'`` or ``'shard'`` alone, or ``P()`` (whole on every rank);
      other splits past dim 0 are gathered before the loss, but
      ``P('repl', 'shard')``: the batch on 'repl' and the sequence (dim
      1) on 'shard' (the sequence layout of the long-context LM). Feeds
      may differ (see the module doc).
    * ``value_and_grad_fn(params, batch, gen) -> (loss, metrics,
      grads)``: replaces autograd in the step (the 1F1B pipeline); the
      grads are a tree like ``params``, this rank's (see the module
      doc). Stateless models without ``slice_updaters`` only.
    * ``pipeline_info``: the schedule's description, kept for the tuner
      (``tune/costmodel.pipeline_bubble`` prices it).
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
        # the profiler scope the loss runs under: its source file's name
        # (obs/xprof.py joins kernels to scopes)
        try:
            src = inspect.getsourcefile(loss_fn)
        except TypeError:
            src = None
        self.scope = os.path.basename(src) if src else "model"

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
    # gathered variables: path -> ((dim, axes), ...) of their spec
    gather_splits: Dict[str, tuple] = dataclasses.field(
        default_factory=dict)

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
        """Variables split across ranks and all-gathered for use: dense
        row-sharded ones and the general splits (``GATHERED``)."""
        return [p for p, v in self.var_specs.items()
                if (not v.is_sparse and self.placements[p] == ROW_SHARDED)
                or self.placements[p] == GATHERED]

    @property
    def sharded_shapes(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(self.var_specs[p].shape for p in self.sharded_tables)

    @property
    def split(self) -> List[str]:
        """Variables a rank holds a part of (row shards and tensor-
        parallel shards)."""
        return [p for p, pl in self.placements.items() if pl != REPLICATED]

    def split_group(self, path: str):
        """(group, this rank's index in it) of the axis variable ``path``
        is split over: the pipeline group for a stage-sharded one, the
        shard group for the other splits."""
        if self.placements[path] == STAGE:
            return (mesh_lib.pipeline_group(self.mesh),
                    mesh_lib.pipeline_index(self.mesh))
        if self.placements[path] == GATHERED:
            axes = self.split_axes(path)
            return (collectives.axis_group(self.mesh, axes),
                    collectives.axes_index(self.mesh, axes))
        return self.mesh.shard_group, self.mesh.coords[1]

    def split_size(self, path: str) -> int:
        """How many parts variable ``path`` is split into."""
        if self.placements[path] == STAGE:
            return mesh_lib.pipeline_stage_count(self.mesh)
        if self.placements[path] == GATHERED:
            return collectives.axes_size(self.mesh, self.split_axes(path))
        return self.mesh.shard

    def split_axes(self, path: str) -> tuple:
        """The mesh axes a gathered variable's parts differ along (every
        axis its spec names, in the mesh's order)."""
        named = {a for _, axes in self.gather_splits[path]
                 for a in axes}
        return tuple(a for a in mesh_lib.BATCH_AXES if a in named)

    def writes_split(self, path: str) -> bool:
        """Whether this rank writes its part of split variable ``path`` to
        a checkpoint: the first of the ranks that hold the same part
        (index 0 on every axis but the split one)."""
        mesh = self.mesh
        r, s = mesh.coords
        if self.placements[path] == STAGE:
            return r == 0 and (s == 0 or mesh.pipe == 1)
        if self.placements[path] == GATHERED:
            axes = self.split_axes(path)
            return (r == 0 or mesh_lib.AXIS_REPL in axes) and \
                (s == 0 or mesh_lib.AXIS_SHARD in axes)
        return r == 0 and mesh.pipe_index == 0

    def local_part(self, path: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of variable ``path`` from the whole one, as its
        own tensor: its rows of a row-sharded or row-parallel leaf, its
        experts of an expert-parallel one, its stage rows of a
        stage-sharded one, its columns of a column-parallel one (of each
        of its ``groups`` blocks, in block order), the whole of a
        replicated one."""
        placement = self.placements[path]
        if placement == REPLICATED:
            return whole
        if placement == GATHERED:
            for dim, axes in self.gather_splits[path]:
                whole = collectives.chunk_axes(whole, self.mesh, axes, dim)
            return whole.detach().clone()
        p, s = self.split_size(path), self.split_group(path)[1]
        if placement == TP_COLUMN:
            g = self.tp_groups[path]
            blocks = whole.reshape(whole.shape[:-1] + (g, -1))
            n = blocks.shape[-1] // p
            part = blocks[..., s * n:(s + 1) * n]
            return part.reshape(whole.shape[:-1] + (g * n,)).detach() \
                .clone()
        n = whole.shape[0] // p
        return whole[s * n:(s + 1) * n].detach().clone()

    def local_tree(self, params, placements=None):
        """``params`` (whole leaves) as this rank holds them (only the
        leaves of ``placements``, when given)."""
        split = [p for p in self.split if placements is None
                 or self.placements[p] in placements]
        if not split:
            return params
        flat = dict(classify.flatten(params))
        return _with_leaves(params, {p: self.local_part(p, flat[p])
                                     for p in split})

    def whole(self, path: str, part: torch.Tensor) -> torch.Tensor:
        """Variable ``path`` gathered whole from the parts over its split
        axis (``local_part``'s inverse; a collective)."""
        if self.placements[path] == GATHERED:
            for dim, axes in self.gather_splits[path]:
                part = collectives.gather_axes(part, self.mesh, axes, dim)
            return part
        group = self.split_group(path)[0]
        if self.placements[path] != TP_COLUMN:
            return collectives.all_gather(part, group)
        g, p = self.tp_groups[path], self.mesh.shard
        cols = collectives.all_gather(part.movedim(-1, 0), group)
        # [p * g * n, ...] in (rank, block, column) order -> (block, rank,
        # column)
        cols = cols.reshape((p, g, -1) + tuple(cols.shape[1:]))
        return cols.transpose(0, 1).reshape((-1,) + tuple(cols.shape[3:])) \
            .movedim(0, -1).contiguous()

    def loss_view(self, params, flat=None):
        """The parameters the loss reads: row-sharded dense leaves and
        gathered ones whole (their gradient summed back onto the parts),
        the rest (row-sharded tables too) as this rank holds them.
        ``flat``: ``params`` flattened (``classify.flatten``), when the
        caller has it."""
        gathered = self.gathered
        if not gathered:
            return params
        splits = self.gather_splits
        if flat is None:
            flat = dict(classify.flatten(params))
        return _with_leaves(params, {
            p: (collectives.gather_param(flat[p], self.mesh, splits[p])
                if p in splits else
                collectives.gather_rows(flat[p], self.mesh))
            for p in gathered})


def step_seed(seed: int, step: int) -> int:
    """The seed of one step, from the run's seed and the step counter
    (the counterpart of ``fold_in(PRNGKey(seed + 1), step)``)."""
    return ((seed + 1) * 0x9E3779B97F4A7C15 + step) & 0x7FFFFFFFFFFFFFFF


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """A fresh generator seeded for one step (``step_seed``)."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


def _stage_placement(spec, shape, mesh: mesh_lib.Mesh,
                     path: str) -> Optional[str]:
    """The placement of a ``P('pipe')`` override: STAGE over the mesh's
    pipeline stages (REPLICATED on one stage; None when dim 0 does not
    divide them); 'pipe' past dim 0 raises."""
    if any(e is not None for e in tuple(spec)[1:]):
        raise ValueError(f"stage spec {spec!r} for {path}: only dim 0 "
                         f"(the stages) splits over 'pipe'")
    n = mesh_lib.pipeline_stage_count(mesh)
    if shape[0] % n:
        parallax_log.warning(
            "param_specs override for %s: dim 0 (%d) not divisible by the "
            "%d pipeline stages; replicating", path, shape[0], n)
        return None
    return STAGE if n > 1 else REPLICATED


def _spec_splits(spec, shape, path: str) -> tuple:
    """((dim, axes), ...) of the dims ``spec`` splits (trailing dims it
    leaves out are unsplit, as in JAX); an axis named twice, or a name
    that is no axis of the two-axis mesh, raises."""
    entries = tuple(spec)
    if len(entries) > len(shape):
        raise ValueError(f"param_specs override {spec!r} for {path}: "
                         f"{len(entries)} entries for a {len(shape)}-d "
                         f"variable {tuple(shape)}")
    splits, seen = [], []
    for dim, e in enumerate(entries):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        if not axes:
            continue
        bad = [a for a in axes if a not in mesh_lib.BATCH_AXES]
        if bad or len(set(axes)) != len(axes) or set(axes) & set(seen):
            raise ValueError(f"spec {spec!r} for {path}: each axis of "
                             f"{mesh_lib.BATCH_AXES} at most once")
        seen += axes
        splits.append((dim, axes))
    return tuple(splits)


def _spec_placement(spec, shape, p: int, path: str,
                    repl: int = 1) -> Optional[str]:
    """The placement a ``param_specs`` override asks for: REPLICATED for
    ``P()`` (or a split over axes of one rank), ROW_SHARDED for the row
    spec, EXPERT for an ``ExpertSpec``, TP_ROW for a row ``TPSpec`` and
    TP_COLUMN for a column spec (``p`` the shard axis' width, ``repl``
    the repl axis'), GATHERED for any other split JAX's
    ``spec_shape_mismatch`` accepts: a middle dim, 'repl', an axis
    tuple, two dims. None (warned: the plan's own placement stands, as
    JAX's ``with_override`` keeps its spec) where a split dim does not
    divide its axes. ``P('pipe')`` is ``_stage_placement``'s."""
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
    splits = _spec_splits(entries, shape, path)
    sizes = {mesh_lib.AXIS_REPL: repl, mesh_lib.AXIS_SHARD: p}
    one = len(splits) == 1 and splits[0][1] == (mesh_lib.AXIS_SHARD,)
    dim = splits[0][0] if one else None
    column = one and dim == len(shape) - 1 and dim > 0
    if tp and not (one and dim in (0, len(shape) - 1)):
        raise ValueError(f"tensor-parallel {spec!r} for {path}: dim 0 or "
                         f"the last dim over 'shard'")
    if tp or column:
        groups = getattr(spec, "groups", 1)
        if shape[dim] % (groups * p):
            raise ValueError(
                f"tensor-parallel {spec!r} for {path}: dim {dim} "
                f"({shape[dim]}) does not split into {groups} block(s) "
                f"over {p} shard(s)")
        if p == 1:
            return REPLICATED
        return TP_COLUMN if column else TP_ROW
    for d, axes in splits:
        n = int(np.prod([sizes[a] for a in axes]))
        if shape[d] % n:
            parallax_log.warning(
                "param_specs override for %s: dim %d (%d) not divisible by "
                "%s (%d); replicating", path, d, shape[d], axes, n)
            return None
    if all(sizes[a] == 1 for _, axes in splits for a in axes):
        return REPLICATED
    if one and dim == 0:
        return ROW_SHARDED
    return GATHERED


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

    tp_groups, gather_splits = {}, {}

    def with_override(path, vs, placement):
        for pattern, spec in model.param_specs.items():
            if fnmatch.fnmatch(path, pattern):
                chosen = _stage_placement(spec, vs.shape, mesh, path) \
                    if len(spec) and spec[0] == mesh_lib.AXIS_PIPE \
                    else _spec_placement(spec, vs.shape, p, path,
                                         repl=mesh.repl)
                if chosen in TP_PLACEMENTS:
                    tp_groups[path] = getattr(spec, "groups", 1)
                if chosen == GATHERED:
                    if mesh.pipe > 1:
                        raise ValueError(
                            f"param_specs override {spec!r} for {path}: "
                            f"a general split on a three-axis mesh")
                    gather_splits[path] = _spec_splits(
                        mesh_lib.resolve_spec(spec), vs.shape, path)
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
    plan = ShardingPlan(mesh, var_specs, placements, tp_groups,
                        gather_splits)
    for path, vs in var_specs.items():
        if vs.shape in plan.sharded_shapes and not vs.is_sparse:
            parallax_log.warning(
                "dense variable %s shares shape %s with a row-sharded "
                "sparse variable (the JAX package would route its lookups "
                "through the collective path; here lookups route by "
                "tensor, so nothing is misrouted)", path, vs.shape)
    parallax_log.info("sharding plan: %s (run_option=%s, mesh %dx%d, "
                      "row-sharded %s, tensor-parallel %s, gathered %s)",
                      plan.describe(), config.run_option, mesh.repl, p,
                      sorted(q for q, pl in placements.items()
                             if pl == ROW_SHARDED), sorted(tp_groups),
                      sorted(gather_splits))
    return plan


def plan_for_params(model: Model, mesh: mesh_lib.Mesh,
                    config: ParallaxConfig, params,
                    example_batch) -> ShardingPlan:
    """``build_plan`` outside training: the placement the engine would
    give ``params`` (whole leaves, any device) on ``mesh`` for a batch
    like ``example_batch`` (host arrays or tensors), with no engine
    built. ``plan.local_tree(params)`` then cuts each rank's part: the
    rows ``[s * V/p, (s + 1) * V/p)`` of a row-sharded table go to shard
    column ``s``, replicated leaves stay whole (the serving session's
    placement, ``parallax_tpu/serve/session.py:201-234``)."""
    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(meta(v) for v in tree)
        return torch.empty(tuple(np.shape(tree)), dtype=_torch_dtype(tree),
                           device="meta")

    meta_params = meta(params)
    meta_state = model.call_init(torch.Generator(), "meta")[1] \
        if model.stateful else None
    return build_plan(model, mesh, config, meta_params,
                      _to_meta(example_batch), meta_state)


BATCH = "batch"          # the default: dim 0 over ('repl', 'shard')
REPL = "repl"            # dim 0 over 'repl' alone (tensor parallelism)
SHARD = "shard"          # dim 0 over 'shard' alone
WHOLE = "whole"          # every rank the whole batch
SEQUENCE = "sequence"    # dim 0 over 'repl', dim 1 over 'shard'
_LAYOUT_OF_AXES = {frozenset(mesh_lib.BATCH_AXES): BATCH,
                   frozenset((mesh_lib.AXIS_REPL,)): REPL,
                   frozenset((mesh_lib.AXIS_SHARD,)): SHARD,
                   frozenset(): WHOLE}


@dataclasses.dataclass(frozen=True)
class FeedLayout:
    """One feed's ``batch_specs`` entry: the axes of dim 0 (in order),
    whether it is the sequence layout (dim 1 over 'shard', consumed in
    place by the model), and the other split dims, gathered whole before
    the loss."""

    axes0: tuple
    sequence: bool = False
    gathered: tuple = ()


def _feed_layout(name: str, spec) -> FeedLayout:
    """The layout one feed's ``batch_specs`` entry asks for (None: the
    default); an axis named twice or unknown raises."""
    if spec is None:
        return FeedLayout(mesh_lib.BATCH_AXES)
    spec = mesh_lib.resolve_spec(spec)
    splits = _spec_splits(spec, (None,) * len(spec), f"batch_specs"
                          f"[{name!r}]")
    axes0 = next((axes for d, axes in splits if d == 0), ())
    rest = tuple((d, axes) for d, axes in splits if d > 0)
    if axes0 == (mesh_lib.AXIS_REPL,) and rest == (
            (1, (mesh_lib.AXIS_SHARD,)),):
        return FeedLayout(axes0, sequence=True)
    return FeedLayout(axes0, gathered=rest)


def _feed_layouts(model: Model, example_batch) -> Dict[str, FeedLayout]:
    names = list(example_batch) if isinstance(example_batch, dict) else []
    return {name: _feed_layout(name, model.batch_specs.get(name))
            for name in names}


def _target_axes(layouts: Dict[str, FeedLayout],
                 gather_shard: bool = False,
                 own_rows: bool = False) -> Tuple[tuple, tuple]:
    """(the dim-0 axes every split feed is laid out on before the loss,
    the axes the batch is split over). One order shared by every split
    feed stands as it is; differing ones meet on their union in the
    mesh's order. The sequence layout keeps dim 0 on 'repl' and splits
    the tokens over both axes. ``gather_shard`` (tensor-parallel
    weights): the shard group must hold the same rows, so 'shard' leaves
    dim 0 (its parts gathered). ``own_rows`` (expert-parallel weights):
    each rank must hold its own rows, as JAX's ``switch_moe`` splits the
    tokens over both axes whatever the feeds' layout, so every feed
    takes the default layout."""
    if any(lay.sequence for lay in layouts.values()):
        return (mesh_lib.AXIS_REPL,), mesh_lib.BATCH_AXES
    if own_rows:
        return mesh_lib.BATCH_AXES, mesh_lib.BATCH_AXES
    orders = {lay.axes0 for lay in layouts.values() if lay.axes0}
    if not layouts:
        orders = {mesh_lib.BATCH_AXES}
    if len(orders) == 1:
        target = next(iter(orders))
    else:
        union = {a for order in orders for a in order}
        target = tuple(a for a in mesh_lib.BATCH_AXES if a in union)
    if gather_shard:
        target = tuple(a for a in target if a != mesh_lib.AXIS_SHARD)
    return target, target


def _relaid_feeds(layouts: Dict[str, FeedLayout], target: tuple,
                  whole_too: bool = False) -> Dict[str, FeedLayout]:
    """The feeds ``_relay_batch`` moves onto ``target`` (``whole_too``:
    whole feeds split onto it as well)."""
    return {name: lay for name, lay in layouts.items()
            if lay.gathered or (not lay.sequence and lay.axes0 != target
                                and (lay.axes0 or whole_too))}


def _relay_batch(batch, mesh, relaid: Dict[str, FeedLayout],
                 target: tuple):
    """The feeds laid out as the loss takes them: each split past dim 0
    (but the sequence layout's) gathered whole, and dim 0 of each split
    feed moved onto ``target`` (``_target_axes``): chunked where the
    feed is alike over an axis of it, gathered over the axes it lacks.
    Feeds already on it, and whole feeds (``P()``) but where
    ``_relaid_feeds`` lists them, pass as they are. On meta tensors only
    the shapes change."""
    if not relaid or not isinstance(batch, dict):
        return batch
    out = dict(batch)
    for name, lay in relaid.items():
        x = out[name]
        for dim, axes in lay.gathered:
            x = collectives.gather_axes(x, mesh, axes, dim)
        a = lay.axes0
        if a != target and not lay.sequence:
            if target[:len(a)] == a:
                x = collectives.chunk_axes(x, mesh, target[len(a):])
            elif a[:len(target)] == target:
                x = collectives.gather_axes(x, mesh, a[len(target):])
            else:
                x = collectives.chunk_axes(
                    collectives.gather_axes(x, mesh, a), mesh, target)
        out[name] = x
    return out


def _batch_layout(model: Model, example_batch) -> str:
    """The name of the layout ``Model.batch_specs`` give the example
    batch's feeds (before any tensor-parallel gather): ``BATCH`` (the
    default), ``REPL``, ``SHARD``, ``WHOLE`` or ``SEQUENCE``."""
    layouts = _feed_layouts(model, example_batch)
    if any(lay.sequence for lay in layouts.values()):
        return SEQUENCE
    return _LAYOUT_OF_AXES[frozenset(_target_axes(layouts)[1])]


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


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _ByteCount(TorchDispatchMode):
    """The bytes a step's ops move, unfused: each op's input tensors read
    once and its outputs written once (an in-place op's tensor both).
    View ops and allocations move nothing; the ops a plain version runs
    in a kernel's place (``_cuda.stand_in``) are skipped, since the
    kernels' own byte models price their traffic."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _cuda.standing_in() and not _moves_nothing(func):
            self.total += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided"}


def _moves_nothing(func) -> bool:
    if func.overloadpacket.__name__ in _ALLOCATIONS:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _host_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


class _StageSlot:
    """One slot of the staging ring: pinned host buffers and device
    buffers per batch signature, the event of its last copy to the card
    and of the last step that read it, and whether that step was
    dispatched or the batch dropped unread (``free``)."""

    def __init__(self):
        self.bufs: Dict[Tuple, Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]] = {}
        self.copied = None
        self.consumed = None
        self.free = threading.Event()
        self.free.set()

    def buffers(self, sig, device):
        got = self.bufs.get(sig)
        if got is None:
            dtypes = {name: getattr(torch, dt[6:]) for name, _, dt in sig}
            got = ({name: torch.empty(shape, dtype=dtypes[name],
                                      pin_memory=True)
                    for name, shape, _ in sig},
                   {name: torch.empty(shape, dtype=dtypes[name],
                                      device=device)
                    for name, shape, _ in sig})
            self.bufs[sig] = got
        return got

    def release(self, stream) -> None:
        ev = torch.cuda.Event()
        ev.record(stream)
        self.consumed = ev
        self.free.set()


class StagedBatch(dict):
    """A batch on the card in a slot of the engine's staging ring
    (``Engine.stage``). Its copy from the host ran on a side stream: the
    step makes its own stream wait on ``ready`` before reading it and
    releases the slot after. A staged batch dropped unread (a closed
    prefetcher's queue) frees its slot when it is collected."""

    def __init__(self, tensors, ready, slot: _StageSlot):
        super().__init__(tensors)
        self.ready = ready
        self._slot = slot

    def release(self, stream) -> None:
        """The step that read the batch was dispatched on ``stream``."""
        slot, self._slot = self._slot, None
        if slot is not None:
            slot.release(stream)

    def __del__(self):
        if self._slot is not None:
            self._slot.free.set()


class Engine:
    """Owns the plan, the optimizer grouping and the train step of one
    rank of the mesh."""

    def __init__(self, model: Model, mesh: mesh_lib.Mesh,
                 config: ParallaxConfig, example_batch,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None):
        if model.value_and_grad_fn is not None and (
                model.stateful or model.slice_updaters):
            raise ValueError(
                "Model.value_and_grad_fn returns the gradients of the "
                "parameters alone: it takes no model state and no "
                "slice_updaters")
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
        # one step dispatch, or one signature's capture (its snapshot,
        # warm call, capture and restore of the state), at a time: a
        # background warmup's capture interleaved with a step would roll
        # the live state back. ``step_stream`` is the stream the last
        # step ran on, which a capture from another thread orders after
        self.step_lock = threading.RLock()
        self.step_stream = None
        self._exec_hits = self.metrics.counter(
            "engine.executable_cache.hits")
        self._exec_misses = self.metrics.counter(
            "engine.executable_cache.misses")
        self.warmup_seconds: Dict[int, float] = {}
        # the step's generator, reseeded before each step (and each
        # replay: the graphs register it)
        self._gen = torch.Generator(device=self.device)
        # the staging ring of prefetched batches (``stage``)
        self._stage_slots: List[_StageSlot] = []
        self._stage_next = 0
        self._stage_stream = None
        self._stage_lock = threading.Lock()
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
        # the feeds' layouts, and the one they are laid out on before the
        # loss (tensor-parallel weights: the shard group's rows gathered);
        # the classifier's forward takes the feeds' shapes so laid out
        self._feed_layouts = _feed_layouts(model, example_batch)
        target = _target_axes(self._feed_layouts)[0]
        self.plan = build_plan(model, mesh, config, meta_params,
                               _relay_batch(meta_batch, mesh, _relaid_feeds(
                                   self._feed_layouts, target), target),
                               meta_state)
        experts = [p for p, pl in self.plan.placements.items()
                   if pl == EXPERT]
        sequence = any(lay.sequence for lay in self._feed_layouts.values())
        if experts and (sequence or self.plan.tp_groups):
            raise NotImplementedError(
                f"expert-parallel param_specs ({experts}) with "
                + ("the sequence layout: the MoE dispatch takes each "
                   "rank's own rows, the sequence layout its own block of "
                   "its repl row's rows" if sequence else
                   f"tensor-parallel ones ({sorted(self.plan.tp_groups)}):"
                   f" the shard group holds its own rows for the MoE "
                   f"dispatch and the same rows for the Megatron "
                   f"products"))
        self._dim0_target, self._batch_axes = _target_axes(
            self._feed_layouts, gather_shard=bool(self.plan.tp_groups),
            own_rows=bool(experts))
        self.batch_layout = SEQUENCE if sequence \
            else _LAYOUT_OF_AXES[frozenset(self._batch_axes)]
        self._relaid = _relaid_feeds(self._feed_layouts,
                                     self._dim0_target,
                                     whole_too=bool(experts))
        if self._relaid and mesh.pipe > 1:
            raise ValueError(
                f"batch_specs {dict(model.batch_specs)} on a three-axis "
                f"mesh: the feeds must share one layout of dim 0 alone")
        if self.plan.tp_groups and self.batch_layout == SEQUENCE \
                and mesh.shard > 1:
            raise NotImplementedError(
                f"tensor-parallel param_specs "
                f"({sorted(self.plan.tp_groups)}) with the sequence "
                f"layout: both split over 'shard', the Megatron products "
                f"the hidden dim and the model's blocks the sequence")
        stages = [p for p, pl in self.plan.placements.items()
                  if pl == STAGE]
        if stages and self.batch_layout != REPL:
            raise ValueError(
                f"stage-sharded param_specs ({stages}) with the "
                f"{self.batch_layout!r} batch layout: every rank of a stage "
                f"ring must hold the same rows; declare batch_specs that "
                f"put every feed on 'repl' alone")
        self._batch_group = collectives.axis_group(mesh, self._batch_axes)
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
        self._dense_paths = [p for p in self.plan.var_specs
                             if p not in self._slice_resolved]
        # -- the numerics observatory (obs/numwatch.py) -----------------
        # gated at build time, as the JAX engine gates its output: with
        # numerics_interval 0 or the obs layer off there is no second
        # graph and no extra output
        self._numerics = int(config.numerics_interval) > 0 \
            and obs_state.enabled
        # the numerics graphs by signature, their capture seconds, the
        # gradient buffers each graph (or the last eager step) leaves
        # behind, and the last step's inputs (NaN provenance)
        self._num_executables: Dict[Tuple, Optional[graphs_lib.Graph]] = {}
        self.numerics_capture_seconds: Dict[Tuple, float] = {}
        self._graph_grads: Dict[Tuple, Dict[str, torch.Tensor]] = {}
        self._step_grads: Optional[Dict[str, torch.Tensor]] = None
        self._last_grads: Optional[Dict[str, torch.Tensor]] = None
        self.last_inputs: Optional[Dict[str, Any]] = None
        # count_step_flops' and count_step_bytes' counts by signature,
        # and the last step's signature
        self._step_flops: Dict[Tuple, Optional[float]] = {}
        self._step_bytes: Dict[Tuple, Optional[float]] = {}
        # scope_index's kernel-name -> source-scope maps by signature
        self._scope_index: Dict[Tuple, Dict[str, Dict[str, Any]]] = {}
        self._last_sig: Optional[Tuple] = None
        if self._numerics:
            # the float leaves the stats cover, and their layers
            self._num_paths = [p for p, t in classify.flatten(meta_params)
                               if t.is_floating_point()]
            self._num_prefixes = sorted({numwatch.prefix_of(p)
                                         for p in self._num_paths})
            self._numerics_zeros = numwatch.zeros_tree(self._num_prefixes)
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
            batch_axes=self._batch_axes)

    def _relay(self, batch):
        """The step's feeds laid out as the loss takes them
        (``_relay_batch``)."""
        return _relay_batch(batch, self.mesh, self._relaid,
                            self._dim0_target)

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
        meta_params = self.plan.local_tree(meta_params, LOCAL_PLACEMENTS)
        flat = dict(classify.flatten(meta_params))
        cap = embedding.SliceCapture(
            {id(flat[p]): p for p in self._slice_resolved})
        reads = _ShardReads({id(flat[p]): p
                             for p in self.plan.sharded_tables})
        with torch.no_grad(), embedding.slice_capture_scope(cap), \
                self._lookup_scope(flat, None) as lctx, reads, \
                _cuda.meta_for(self.device):
            self.model.call_loss(meta_params, self._relay(meta_batch),
                                 torch.Generator())
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
        params = self.plan.local_tree(params)
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

    def gather_params(self, state: TrainState):
        """The parameter tree with every split leaf (row-sharded, tensor-
        parallel) gathered whole in the JAX package's global layout (a
        collective: every rank calls it); the rest as they are."""
        flat = dict(classify.flatten(state.params))
        with torch.no_grad():
            return _with_leaves(state.params, {
                p: self.plan.whole(p, flat[p]) for p in self.plan.split})

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
        with trace.span("engine.h2d_place"):
            host = {k: _host_tensor(v)
                    for k, v in self.bucket(batch).items()}
            cuda = self.device.type == "cuda"
            if cuda:
                host = {k: (t.pin_memory() if t.device.type == "cpu"
                            else t) for k, t in host.items()}
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

    def _take_slot(self) -> _StageSlot:
        """The next free slot of the staging ring, round robin from the
        last one taken, marked busy; a new slot when every slot holds a
        staged batch not yet stepped. The ring so grows to the most
        batches held staged at once (``prefetch_depth`` + 2 under
        ``run_iter``: the queue, the one the thread holds, the one being
        stepped) and never blocks a caller that holds more."""
        with self._stage_lock:
            n = len(self._stage_slots)
            for i in range(n):
                slot = self._stage_slots[(self._stage_next + i) % n]
                if slot.free.is_set():
                    self._stage_next = (self._stage_next + i + 1) % n
                    break
            else:
                slot = _StageSlot()
                self._stage_slots.insert(self._stage_next, slot)
                self._stage_next = (self._stage_next + 1) % (n + 1)
            slot.free.clear()
            return slot

    def stage(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """A host batch, bucketed, staged for a later ``step``: the
        placement a prefetch thread runs ahead of the step loop. On the
        card the batch goes into a free slot of the staging ring
        (``_take_slot``): into the slot's pinned host buffers (pinned
        once per slot and signature, not once per batch), then to its
        device buffers on a side stream, with an event the step waits on.
        Each step copies its slot into the signature's static input
        buffers (a device-to-device copy) on its own stream, so a batch
        staged ahead never overwrites the inputs of a step not yet
        dispatched. A slot is reused only after the step that read it was
        dispatched, or the batch was dropped unread, and after its last
        copy finished. On the CPU the batch's tensors are returned as
        they are."""
        with trace.span("engine.h2d_place"):
            return self._stage(batch)

    def _stage(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        host = {k: _host_tensor(v) for k, v in self.bucket(batch).items()}
        if self.device.type != "cuda":
            return host
        with torch.cuda.device(self.device):
            with self._stage_lock:
                if self._stage_stream is None:
                    self._stage_stream = torch.cuda.Stream(self.device)
            slot = self._take_slot()
            try:
                if slot.copied is not None:
                    slot.copied.synchronize()   # the pinned buffers are free
                stream = self._stage_stream
                with torch.cuda.stream(stream):
                    # allocated on the stream that writes them: a block the
                    # step's stream freed may still be written by a kernel
                    # pending there, and the allocator hands such blocks
                    # only to allocations on that same stream
                    pinned, dev = slot.buffers(
                        bucketing.batch_signature(host), self.device)
                for k, t in host.items():
                    pinned[k].copy_(t)
                if slot.consumed is not None:
                    # the last step that read the device buffers is done
                    stream.wait_event(slot.consumed)
                with torch.cuda.stream(stream):
                    for k in host:
                        dev[k].copy_(pinned[k], non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(stream)
            except BaseException:
                slot.free.set()
                raise
            slot.copied = ready
            return StagedBatch(dev, ready, slot)

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
        or ``stage`` gives them). Returns (state, outputs); the state is
        updated in place. On the card the signature's graph is replayed,
        captured first if it has none; on the CPU and inside
        ``compile.disable_capture()`` the step runs eagerly."""
        with self.step_lock:
            return self._step(state, batch)

    def _step(self, state: TrainState, batch) -> tuple:
        staged = batch if isinstance(batch, StagedBatch) else None
        if self.device.type == "cuda":
            self.step_stream = torch.cuda.current_stream(self.device)
        if staged is not None:
            self.step_stream.wait_event(staged.ready)
        sig = bucketing.batch_signature(batch)
        self._note_batch_signature(sig)
        self._last_sig = sig
        sampled = self._numerics and \
            state.step % int(self.config.numerics_interval) == 0
        with trace.span("engine.step"):
            if self._captures():
                outputs = self._replay(state, sig, batch, sampled)
            else:
                self._reseed(state)
                outputs = self._compute(state, batch, sampled)
                self._last_grads = self._step_grads
                self.last_inputs = batch
        if staged is not None:
            staged.release(torch.cuda.current_stream(self.device))
        state.step += 1
        self.metrics.counter("engine.steps").inc()
        if self._numerics:
            mat = outputs.pop("_numerics", None)
            outputs["numerics"] = (
                numwatch.StatsTree(self._num_prefixes, mat)
                if mat is not None else self._numerics_zeros)
        outputs = {"loss": outputs.pop("loss"), "global_step": state.step,
                   **outputs}
        return state, outputs

    def _reseed(self, state: TrainState) -> None:
        self._gen.manual_seed(step_seed(state.seed, state.step))

    def _compute(self, state: TrainState, batch,
                 numerics: bool = False) -> Dict[str, Any]:
        """The step's device work, every state tensor written in place:
        forward, gradients, their combine across ranks, the optimizer,
        the slice updates and the new model state. Returns the loss and
        metrics (tensors on the device); with ``numerics`` also the
        per-layer stats as ``_numerics`` (``[layers, 6]``)."""
        flat = dict(classify.flatten(state.params))
        cap = None
        scope = contextlib.nullcontext()
        if self._slice_resolved:
            cap = embedding.SliceCapture(
                {id(flat[p]): p for p in self._slice_resolved})
            scope = embedding.slice_capture_scope(cap)
        self._lookup_records = records = []
        vag = self.model.value_and_grad_fn
        # profiler scopes named after the source files their work comes
        # from: obs/xprof.py joins each kernel to the one it ran under
        with scope, self._lookup_scope(flat, records), \
                torch.profiler.record_function(self.model.scope):
            batch = self._relay(batch)
            if vag is not None:
                loss, metrics, grad_tree = vag(state.params, batch,
                                               self._gen)
                metrics, new_model_state = dict(metrics), None
            else:
                loss, metrics, new_model_state = self.model.call_loss(
                    self.plan.loss_view(state.params, flat), batch, self._gen,
                    state.model_state)
        if self.config.monitor_health:
            taken = {"grad_norm", "loss_finite"} & set(metrics)
            if taken:
                raise ValueError(
                    f"monitor_health=True reserves the output names "
                    f"'grad_norm'/'loss_finite' but the model's metrics "
                    f"already define {sorted(taken)}; rename the model "
                    f"metric(s)")
        if self._numerics and "numerics" in metrics:
            raise ValueError(
                "numerics_interval > 0 reserves the output name "
                "'numerics' but the model's metrics already define it; "
                "rename the model metric")
        leaves = [flat[p] for p in self._dense_paths]
        rows = [r for _, _, r in cap.captured] if cap is not None else []
        if vag is not None:
            got = dict(classify.flatten(grad_tree))
            grads = tuple(got.get(p) for p in self._dense_paths)
        else:
            grads = torch.autograd.grad(loss, leaves + rows,
                                        allow_unused=True)
        with torch.no_grad():
            dense = {p: (g if g is not None else torch.zeros_like(flat[p]))
                     for p, g in zip(self._dense_paths, grads)}
            with torch.profiler.record_function("engine.py"):
                self._combine(dense)
            health = self._health(loss, dense, grads[len(leaves):]) \
                if self.config.monitor_health else {}
            if self._numerics:
                # kept for the trip step's forced stats (trip_numerics)
                self._step_grads = dense
            pre = self._numerics_before(flat, cap) if numerics else None
            apply = dense
            if not self.config.sync:
                apply = self._delayed(state, dense)
            with optim.sharded_scope(self._split_groups(), self.mesh), \
                    torch.profiler.record_function("optim.py"):
                updates, _ = self.model.optimizer.update(
                    apply, state.opt_state,
                    {p: flat[p] for p in self._dense_paths})
                optim.apply_updates(flat, updates)
            if not self.config.sync:
                self._push_pending(state, dense)
            if cap is not None:
                with torch.profiler.record_function("sparse_optim.py"):
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
            if pre is not None:
                num = self._numerics_after(flat, pre, dense)
        outputs = {"loss": loss.detach()}
        outputs.update({k: (v.detach() if isinstance(v, torch.Tensor)
                            else v) for k, v in metrics.items()})
        outputs.update(health)
        if pre is not None:
            outputs["_numerics"] = num
        return outputs

    # -- the numerics observatory (obs/numwatch.py) ------------------------

    def _numerics_before(self, flat, cap) -> Dict[str, Any]:
        """What the stats need from the parameters before the update:
        each dense leaf's copy, and for each sliced table its squared
        norm and the rows the step's ids touch (sorted, the first
        occurrence of each id marked), gathered before the update."""
        pre: Dict[str, Any] = {}
        for p in self._dense_paths:
            if flat[p].is_floating_point():
                pre[p] = flat[p].detach().clone()
        if cap is not None:
            ids_of: Dict[str, list] = {}
            for path, ids, _ in cap.captured:
                ids_of.setdefault(path, []).append(ids.reshape(-1).long())
            for path, parts in ids_of.items():
                table = flat[path]
                n = table.shape[0]
                # the ids the update applies (every share of the batch);
                # those this rank holds no row of sort last, unmarked
                ids = self._slice_ids(flat, path, torch.cat(parts))
                ids, _ = torch.sort(torch.where((ids >= 0) & (ids < n),
                                                ids, n))
                first = torch.ones_like(ids, dtype=torch.bool)
                first[1:] = ids[1:] != ids[:-1]
                first &= ids < n
                ids = ids.clamp(max=n - 1)
                # the squared norm in one reduction: no table-sized
                # temporary in the graph's pool
                w_sq = torch.linalg.vector_norm(
                    table.detach(), dtype=torch.float32).square()
                pre[path] = (w_sq, ids, first, table[ids].detach().float())
        return pre

    def _slice_ids(self, flat, path: str, ids: torch.Tensor
                   ) -> torch.Tensor:
        """A sliced table's ids of this rank's lookups as the update
        applies them: gathered over the batch group (the distinct
        shares), shifted to this rank's rows of a row-sharded table."""
        group = self._batch_group
        if group is not None and group.size > 1:
            ids = collectives.all_gather(ids, group)
        if self.plan.placements[path] == ROW_SHARDED:
            ids = ids - self.mesh.coords[1] * flat[path].shape[0]
        return ids

    def _numerics_after(self, flat, pre, dense) -> torch.Tensor:
        """The ``[layers, 6]`` stats (``numwatch.stats_matrix``) after the
        update: a dense leaf's update against its copy, a sliced table's
        over the distinct rows it touched (the rest did not move), its
        dense gradient zero (as the JAX engine's per-prefix stats see
        it). A split leaf's terms are its part's, summed over the group
        it is split over (``numwatch.stats_matrix``)."""
        groups: Dict[str, list] = {}
        split = self._split_groups()
        for p in self._num_paths:
            w1 = flat[p]
            if p in self._slice_resolved:
                if p in pre:
                    w_sq, ids, first, rows0 = pre[p]
                    d = (w1[ids].float() - rows0) * first[:, None]
                    terms = (w_sq, d.square().sum(), None)
                else:   # a table the step did not look up
                    w_sq = torch.linalg.vector_norm(
                        w1.detach(), dtype=torch.float32).square()
                    terms = (w_sq, torch.zeros_like(w_sq), None)
            else:
                w0 = pre[p].float()
                terms = (w0.square().sum(),
                         (w1.detach().float() - w0).square().sum(),
                         dense[p])
            groups.setdefault(numwatch.prefix_of(p), []).append(
                terms + (split.get(p),))
        return numwatch.stats_matrix([groups[p] for p in self._num_prefixes])

    def trip_numerics(self, state: TrainState,
                      params_before: Dict[str, Any]) -> numwatch.StatsTree:
        """The stats tree of the step just run, computed after it: the
        gradients it left in its buffers (the graph's, or the eager
        step's), the live (post-step) parameters and ``params_before``
        ({path: array}, the recovery snapshot's) as the pre-step ones.
        The session's recovery path calls it on a non-finite step that
        was not sampled, before the rollback (the JAX engine forces the
        sample inside the step)."""
        if self._last_grads is None:
            raise RuntimeError("trip_numerics: no step has run yet")
        flat = dict(classify.flatten(state.params))
        groups: Dict[str, list] = {}
        split = self._split_groups()
        with torch.no_grad():
            for p, w1 in flat.items():
                if not w1.is_floating_point():
                    continue
                g = self._last_grads.get(p) \
                    if p not in self._slice_resolved else None
                groups.setdefault(numwatch.prefix_of(p), []).append(
                    numwatch.leaf_terms(params_before[p], w1, g)
                    + (split.get(p),))
            mat = numwatch.stats_matrix(
                [groups[p] for p in self._num_prefixes])
        return numwatch.StatsTree(self._num_prefixes, mat)

    def _meta_step(self, sig, mode, records: Optional[list] = None
                   ) -> None:
        """One step of signature ``sig`` on meta tensors under the
        dispatch ``mode``: the forward and the gradient, every kernel
        wrapper on its plain version (a meta tensor is not a CUDA one),
        routed as this engine's device would route it
        (``_cuda.meta_for``); the lookups append their records to
        ``records``."""
        meta_params, meta_state = self.model.call_init(
            torch.Generator(), "meta")
        meta_params = self.plan.local_tree(meta_params, LOCAL_PLACEMENTS)
        batch = {name: torch.empty(shape, dtype=getattr(torch, dt[6:]),
                                   device="meta")
                 for name, shape, dt in sig}
        flat = dict(classify.flatten(meta_params))
        leaves = [flat[p].requires_grad_() for p in self._dense_paths
                  if flat[p].is_floating_point()]
        cap = embedding.SliceCapture(
            {id(flat[p]): p for p in self._slice_resolved})
        vag = self.model.value_and_grad_fn
        with mode, embedding.slice_capture_scope(cap), \
                self._lookup_scope(flat, records), \
                _cuda.meta_for(self.device):
            batch = self._relay(batch)
            if vag is not None:
                vag(meta_params, batch, torch.Generator())
            else:
                loss, _, _ = self.model.call_loss(
                    meta_params, batch, torch.Generator(), meta_state)
                rows = [r for _, _, r in cap.captured]
                torch.autograd.grad(loss, leaves + rows,
                                    allow_unused=True)

    def _default_sig(self, sig):
        if sig is not None:
            return sig
        return self._last_sig if self._last_sig is not None else \
            bucketing.batch_signature(self._batch_shapes)

    def count_step_flops(self, sig=None) -> Optional[float]:
        """This rank's FLOPs of one step of signature ``sig`` (default:
        the last step's, else the example batch's), counted once and
        kept: the step runs on meta tensors (``_meta_step``) under
        ``torch.utils.flop_counter.FlopCounterMode``, so the count is the
        plain versions' matmuls — the same matmuls the kernels compute.
        The optimizer's elementwise update counts nothing. None when a
        model's step cannot run on meta tensors."""
        from torch.utils.flop_counter import FlopCounterMode
        sig = self._default_sig(sig)
        if sig in self._step_flops:
            return self._step_flops[sig]
        flops = None
        try:
            counter = FlopCounterMode(display=False)
            self._meta_step(sig, counter)
            flops = float(counter.get_total_flops())
        except Exception as e:
            parallax_log.warning("step FLOPs not counted: %s", e)
        self._step_flops[sig] = flops
        return flops

    def count_step_bytes(self, sig=None) -> Optional[float]:
        """This rank's device-memory bytes of one step of signature
        ``sig``, counted once on meta tensors (``_ByteCount``): every
        op's inputs and outputs, unfused, with the hand kernels' plain
        stand-ins left out (their byte models price them, through the
        kernels' trace records). The step's lookup records land in
        ``_lookup_records`` when no step has run yet. None when a model's
        step cannot run on meta tensors."""
        sig = self._default_sig(sig)
        if sig in self._step_bytes:
            return self._step_bytes[sig]
        nbytes = None
        records: list = []
        try:
            counter = _ByteCount()
            self._meta_step(sig, counter, records)
            nbytes = float(counter.total)
            if not self._lookup_records:
                self._lookup_records = records
        except Exception as e:
            parallax_log.warning("step bytes not counted: %s", e)
        self._step_bytes[sig] = nbytes
        return nbytes

    def step_cost_analysis(self, cheap_only: bool = True
                           ) -> Dict[str, float]:
        """The counterpart of the JAX engine's XLA ``cost_analysis`` of
        one step (``parallax_tpu/core/engine.py:960``): ``flops``
        (``count_step_flops``) and ``bytes accessed``
        (``count_step_bytes``, an unfused count: larger than XLA's,
        which fuses), each left out when it cannot be counted. The
        counts are cheap either way; ``cheap_only`` is the JAX engine's
        signature."""
        out: Dict[str, float] = {}
        flops = self.count_step_flops()
        if flops is not None:
            out["flops"] = flops
        nbytes = self.count_step_bytes()
        if nbytes is not None:
            out["bytes accessed"] = nbytes
        return out

    def step_captures(self, state: TrainState, batch) -> bool:
        """Whether ``step(state, batch)`` captures a graph first (its
        signature, or its sampled variant, has none for this state): the
        profiler must not trace such a step (profiler.py)."""
        if not self._captures():
            return False
        sig = bucketing.batch_signature(batch)
        sampled = self._numerics and \
            state.step % int(self.config.numerics_interval) == 0
        table = self._num_executables if sampled else self._executables
        return table.get(sig) is None or state is not self._captured_state

    def scope_index(self) -> Optional[Dict[str, Dict[str, Any]]]:
        """{kernel name: {"source_file": scope}} of the last step's
        signature, for ``obs.xprof.attribute``: a replayed graph's trace
        names its kernels but no scope, so the step is captured once
        more with its warm eager call under the profiler
        (``graphs.capture(warm_trace=)``, stopped before the capture
        begins, the state left as it was), and each kernel name that ran
        under one scope alone maps to it (``xprof.build_scope_index``).
        Kept per signature. None where steps do not replay graphs (their
        profiled window carries the scopes itself)."""
        sig = self._last_sig
        if sig is None or not self._captures() \
                or self._captured_state is None:
            return None
        if sig not in self._scope_index:
            self._capture(self._captured_state, sig,
                          self._static_inputs(sig), index_scopes=True)
        return self._scope_index.get(sig)

    def captured_graphs(self, numerics: bool = False
                        ) -> List[graphs_lib.Graph]:
        """The step graphs held now (``numerics``: the numerics graphs)."""
        table = self._num_executables if numerics else self._executables
        return [g for g in table.values() if g is not None]

    def _health(self, loss, dense, row_grads) -> Dict[str, torch.Tensor]:
        """The in-graph health outputs (``Config.monitor_health``, JAX's
        engine.py:724-739): ``grad_norm``, the global norm of this step's
        gradients (the dense ones after their combine across ranks, and
        the slice tables' row gradients, scaled and summed over the batch
        group as ``_apply_slices`` gathers them), and ``loss_finite``."""
        with optim.sharded_scope(self._split_groups(), self.mesh):
            sq = optim.global_norm(dense).square() if dense else \
                torch.zeros((), device=self.device)
        rows = [g for g in row_grads if g is not None]
        if rows:
            rsq = torch.stack([g.float().square().sum() for g in rows]).sum()
            group = self._batch_group
            if group is not None and group.size > 1:
                rsq = (rsq / group.size ** 2).reshape(1)
                collectives.all_reduce_(rsq, group)
                rsq = rsq[0]
            sq = sq + rsq
        return {"grad_norm": torch.sqrt(sq),
                "loss_finite": torch.isfinite(loss.detach())}

    def _split_groups(self) -> Dict[str, Any]:
        """{split variable: the group it is split over}, for the global
        norm (``optim.sharded_scope``)."""
        return {p: self.plan.split_group(p)[0] for p in self.plan.split}

    def _combine(self, dense: Dict[str, torch.Tensor]) -> None:
        """Average the dense gradients over the ranks the batch is split
        over, in place: replicated and tensor-parallel ones all-reduced
        in flat buckets over that group (the world, or the repl group when
        the batch rides 'repl' alone; a process group of one rank runs
        the collective too); expert and stage rows (``ROW_LOCAL``), whose
        gradient is this rank's own (the dispatch's backward summed the
        experts' over 'shard'), all-reduced over 'repl' and scaled alike;
        row-shard gradients, which their backward already summed over
        the mesh, scaled alone."""
        group = self._batch_group
        if group is None:
            return
        scale = 1.0 / group.size if group.size > 1 else None
        summed = (ROW_SHARDED, GATHERED)
        collectives.flat_all_reduce_(
            [g for p, g in dense.items()
             if self.plan.placements[p] not in summed + ROW_LOCAL],
            group, scale)
        local = [g for p, g in dense.items()
                 if self.plan.placements[p] in ROW_LOCAL]
        if local:
            collectives.flat_all_reduce_(local, self.mesh.repl_group,
                                         scale)
        shards = [g for p, g in dense.items()
                  if self.plan.placements[p] in summed]
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

    def _replay(self, state: TrainState, sig, batch,
                numerics: bool = False) -> Dict[str, Any]:
        inputs = self._static_inputs(sig, batch)
        table = self._num_executables if numerics else self._executables
        graph = table.get(sig)
        if graph is not None and state is self._captured_state:
            if not numerics:
                self._exec_hits.inc()
        else:
            if self._executables and graph is None and not numerics:
                self._exec_misses.inc()
            if state is not self._captured_state:
                # the graphs read another state's buffers
                self._drop_graphs()
            graph = self._capture(state, sig, inputs, numerics)
        self._reseed(state)
        self.last_inputs = inputs
        self._last_grads = self._graph_grads.get((sig, numerics))
        out = graph.replay()
        # copied out of the pool: the next replay overwrites it, and a
        # lazy fetch may be read after that
        return {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in out.items()}

    def _drop_graphs(self) -> None:
        self._executables = {s: None for s in self._executables}
        self._num_executables = {s: None for s in self._num_executables}
        self._graph_grads = {}
        self._captured_state = None

    @torch.no_grad()
    def _capture(self, state: TrainState, sig, inputs,
                 numerics: bool = False,
                 index_scopes: bool = False) -> graphs_lib.Graph:
        """Capture the step on ``inputs`` against ``state``'s buffers
        (``numerics``: the graph that also computes the per-layer
        stats). The eager call that precedes the capture runs a real
        step; every state tensor is copied aside first and back after,
        so the state leaves the capture bitwise as it came (as compiling
        a JAX step never runs it). ``index_scopes``: that eager call runs
        under the profiler, and its trace gives ``scope_index``."""
        import tempfile
        leaves = state_tensors(state)
        snapshot = [t.detach().clone() for t in leaves]

        def body():
            with torch.enable_grad():
                return self._compute(state, inputs, numerics)

        tmp = tempfile.TemporaryDirectory(prefix="parallax-scopes-") \
            if index_scopes else None
        try:
            graph = graphs_lib.capture(
                body, self.device, self._gen,
                warm_trace=(os.path.join(tmp.name, "warm.trace.json")
                            if tmp is not None else None))
            if tmp is not None:
                from parallax_tpu_torch.obs import xprof
                doc, _ = xprof.load_trace(tmp.name)
                self._scope_index[sig] = xprof.build_scope_index(doc)
        finally:
            torch._foreach_copy_(leaves, snapshot)
            del snapshot
            if tmp is not None:
                tmp.cleanup()
        if numerics:
            self._num_executables[sig] = graph
            self.numerics_capture_seconds[sig] = graph.seconds
        else:
            self._executables[sig] = graph
        if self._numerics:
            # the captured call's gradients: pool tensors every replay
            # of this graph rewrites
            self._graph_grads[(sig, numerics)] = self._step_grads
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
            if self._numerics:
                self._capture(state, sig, self._static_inputs(sig),
                              numerics=True)
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
        gathered over the batch group, whose ranks hold the distinct
        shares (averaged over its size, as every gradient that crosses
        ranks is; the ranks along the other axes gather the same slices),
        and each rank updates the rows it holds, its ids shifted to its
        shard."""
        per_path: Dict[str, list] = {}
        for (path, ids, rows), g in zip(captured, row_grads):
            if g is None:
                g = torch.zeros_like(rows)
            per_path.setdefault(path, []).append((ids, g))
        group = self._batch_group
        for path, items in per_path.items():
            ids = self._slice_ids(flat, path, torch.cat(
                [i.reshape(-1).long() for i, _ in items]))
            drows = torch.cat([d.reshape(-1, d.shape[-1]) for _, d in items])
            if group is not None and group.size > 1:
                drows = collectives.all_gather(drows, group) \
                    * (1.0 / group.size)
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
                self.plan.loss_view(state.params, flat), self._relay(batch), gen,
                state.model_state)
        return loss, metrics
