"""ServeSession — put a model behind a request queue
(``parallax_tpu/serve/session.py``).

One object owns the serving stack of one replica:

* **placement** — over the ``('repl', 'shard')`` mesh the training
  engine uses (``mesh=``, else ``core.mesh.build_mesh(device,
  num_partitions)``): with ``model=`` each rank holds its part by the
  engine's own plan (``core.engine.plan_for_params``: each rank its rows
  of every row-sharded table, dense leaves whole), without it every
  leaf whole on every rank. Either way the leaves are the session's own
  copies (a ``swap_params`` overwrites them in place). ``plan=`` (the
  training session's ``serve()``) takes a tree already placed by that
  plan as it lies, with no copy. Lookups of a row shard run the
  collective lookup (``ops.embedding.sharded_lookup_scope``);
* **a mesh of ranks** (serve/mesh.py) — every rank constructs the
  session; rank 0 leads (queue, batcher or scheduler, metrics) and
  broadcasts each dispatch's header and host inputs, the followers
  replay it. A one-shot bucket that divides the ranks gives each rank
  its rows of dim 0 and the outputs are gathered back along dim 0; any
  other bucket goes whole to every rank. At one rank nothing is sent;
* **a bounded signature set** (one-shot mode) — requests are padded
  onto declared length buckets (``ServeConfig.length_buckets``,
  per-request ragged feeds) and formed batches onto batch buckets
  (``ServeConfig.batch_buckets``, default powers of two up to
  ``max_batch``). On the card ``warmup()`` (run at construction)
  captures ``infer_fn`` once per (batch, length) signature as a CUDA
  graph over static input buffers — the counterpart of the JAX
  package's AOT compile of every signature — so live traffic replays
  graphs only; a dispatch that misses the captured set is captured then
  and counted in ``serve.recompiles`` (a healthy session holds it at 0).
  A feed outside the declared set is refused at ``submit``;
* **the dynamic micro-batcher** (serve/batcher.py) for one-shot
  inference, or **the slot-based continuous scheduler**
  (serve/continuous.py) driving a :class:`DecodeProgram`;
* **admission** — the bounded request queue with deadlines, tenant
  quotas and SLO classes;
* **observability** — ``serve.*`` metrics (queue depth, batch
  occupancy, request latency, time-to-first-token, tokens/sec,
  shed/timeout counters) in the session's registry, a ``serve.request``
  span per request, and the per-request lifecycle records;
* **the replica surface** a fleet drives — ``replica_id``, the fault
  hooks (``faults``: serve/faults.py), ``on_fatal`` / ``on_error``, the
  non-finite output guard (``check_outputs``), ``prefill_only`` /
  ``import_prefix_entry`` (an exported prefill and its import into the
  prefix cache), ``swap_params`` (the weights replaced in place,
  nothing captured again), and the ``alive`` / ``heartbeat`` / ``load``
  / ``idle`` probes a router reads.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from parallax_tpu_torch.common.config import ParallaxConfig
from parallax_tpu_torch.common.lib import parallax_log, resolve_device
from parallax_tpu_torch.compile import bucketing, graphs as graphs_lib
from parallax_tpu_torch.core import classify, engine as engine_lib
from parallax_tpu_torch.core import mesh as mesh_lib
from parallax_tpu_torch.ops import collectives
from parallax_tpu_torch.obs import _state as obs_state
from parallax_tpu_torch.obs import metrics as obs_metrics, reqtrace, trace
from parallax_tpu_torch.serve.batcher import (DeadlineExceeded, MicroBatcher,
                                              ReplicaUnavailable, Request,
                                              RequestQueue, ServeClosed,
                                              ServeError, ServeOverloaded)
from parallax_tpu_torch.serve import mesh as serve_mesh
from parallax_tpu_torch.serve.continuous import ContinuousScheduler


def _to_device(tree, device):
    """A copy of ``tree`` on ``device`` whose leaves are the session's
    own (never the caller's tensors)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.as_tensor(tree).detach().to(device, copy=True)


def _leaves(tree, path=""):
    """(path, leaf) pairs of a params tree, dict keys sorted (as a JAX
    treedef orders them); the path names the structure (dict keys, list
    positions)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


class _Skel:
    """A leaf's place in a flattened output tree."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _flatten(tree, leaves: list):
    """The tree's skeleton, its leaves appended to ``leaves`` in order."""
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    leaves.append(tree)
    return _Skel(len(leaves) - 1)


def _unflatten(skel, leaves):
    if isinstance(skel, dict):
        return {k: _unflatten(v, leaves) for k, v in skel.items()}
    if isinstance(skel, (list, tuple)):
        return type(skel)(_unflatten(v, leaves) for v in skel)
    return leaves[skel.i]


def _host(x) -> np.ndarray:
    """One output leaf on the host (bf16 widened to fp32: numpy has no
    bfloat16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class _Signature:
    """One captured (batch, length) signature: the static input buffers
    its graph reads (this rank's rows where ``split``), the graph (None
    on the CPU, which runs ``infer_fn`` eagerly) and whether the batch is
    split over the mesh's ranks."""

    __slots__ = ("inputs", "graph", "split")

    def __init__(self, inputs, graph, split):
        self.inputs = inputs
        self.graph = graph
        self.split = split


def _gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows of output leaf ``x`` along dim 0, in rank order."""
    if x.dtype == torch.bool:
        return collectives.all_gather(x.to(torch.uint8), mesh.world).bool()
    return collectives.all_gather(x, mesh.world)


class ServeSession:
    """Serve ``infer_fn(params, batch) -> outputs`` (one-shot mode) or a
    :class:`~parallax_tpu_torch.serve.continuous.DecodeProgram`
    (continuous-decode mode) behind a request queue.

    One-shot mode::

        serve = ServeSession(infer_fn, params, example_feed={"x": x0},
                             config=Config(serve_config=ServeConfig(
                                 max_batch=8)))
        req = serve.submit({"x": x}, deadline_ms=50)
        y = req.result()
        serve.close()

    ``example_feed`` is ONE request's feed (no batch dim, numpy); the
    batch reaches ``infer_fn`` as a dict of tensors on the session's
    device, and every output leaf must carry the batch on dim 0 (0-d
    leaves pass through to every request unchanged). Results come back
    as host arrays (bf16 leaves as fp32). On the card ``infer_fn`` is
    captured as a CUDA graph, so it must make no host sync.

    Decode mode::

        prog = NMTDecodeProgram(cfg, max_src_len=64, page_size=16,
                                pool_pages=512, attn_impl="kernel")
        with ServeSession(program=prog, params=params,
                          config=Config(serve_config=ServeConfig(
                              max_batch=64))) as serve:
            tokens = serve.submit({"src": src},
                                  max_new_tokens=32).result()

    A program serves one live session at a time (one program per
    replica; serve/continuous.py).

    ``device`` (default the card) is where the parameters are placed;
    it must match the program's device. On a machine without CUDA the
    default raises — pass ``device="cpu"`` (to the program too) to run on
    the CPU. A given ``mesh`` brings its own device.

    Over a mesh of ranks (an initialised process group) every rank
    constructs the session with the same arguments; rank 0 is the leader
    and serves (``submit``), the others follow (``submit`` raises
    ``ValueError``) until the leader's ``close()``, which each
    follower's ``close()`` waits for. While it serves, the mesh's
    collectives belong to it. ``close()`` destroys the graphs the
    session captured over the mesh (they hold its NCCL communicators,
    which ``destroy_process_group`` cannot destroy while such a graph
    lives), so after every rank's ``close()`` the caller has nothing to
    release before ``destroy_process_group``; a decode program of the
    caller's own that captures graphs gives ``release_graphs()`` for
    that. Not over more than one rank: the prefix
    cache, ``prefill_only``, ``import_prefix_entry``, ``swap_params``,
    and plans with tensor-, expert- or stage-parallel weights (for a
    program, also gathered ones): each raises.

    ``model=`` classifies the params on a batch of the model's loss feed:
    ``plan_feed`` if given, else the program's ``plan_feed(max_batch)``,
    else (one-shot) the example feed at the longest length bucket stacked
    ``max_batch`` times, as the JAX session does (a model whose loss
    reads other feeds than the served ones needs ``plan_feed``).
    """

    def __init__(self, infer_fn: Optional[Callable] = None,
                 params: Any = None, *,
                 example_feed: Optional[Dict[str, Any]] = None,
                 config: Optional[ParallaxConfig] = None,
                 model: Optional[engine_lib.Model] = None,
                 mesh: Optional[mesh_lib.Mesh] = None,
                 num_partitions: Optional[int] = None,
                 plan: Optional[engine_lib.ShardingPlan] = None,
                 plan_feed: Optional[Dict[str, Any]] = None,
                 ragged_feeds: Sequence[str] = (),
                 pad_value=0, warmup: bool = True,
                 program=None,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None,
                 flight=None, replica_id=None, faults=None,
                 on_fatal=None, on_error=None,
                 check_outputs: bool = False,
                 device="cuda"):
        if (infer_fn is None) == (program is None):
            raise ValueError(
                "pass exactly one of infer_fn (one-shot) or program "
                "(continuous decode)")
        if params is None:
            raise ValueError("ServeSession needs a params tree")
        if plan is not None and model is not None:
            raise ValueError("pass model= (place the tree by its plan) or "
                             "plan= (a tree already placed), not both")
        if mesh is None and plan is not None:
            mesh = plan.mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.mesh = mesh if mesh is not None else mesh_lib.build_mesh(
            self.device, num_partitions=num_partitions)
        self.rank = self.mesh.rank
        self.leader = self.rank == 0
        self._config = config or ParallaxConfig()
        sc = self._config.serve_config
        if self.mesh.size > 1 and sc.prefix_cache:
            raise NotImplementedError(
                "ServeConfig.prefix_cache over a mesh of ranks: a cached "
                "request state is the leader's alone, and the followers "
                "would have to keep theirs in step")
        # the leader's headers to the followers (serve/mesh.py)
        self._channel = serve_mesh.Channel(self.mesh) \
            if self.mesh.size > 1 else None
        self._follower = None      # a follower's replay thread
        self._follow_error = None
        self._plan_feed = plan_feed
        self.metrics = metrics if metrics is not None \
            else obs_metrics.MetricsRegistry()
        self._recompiles = self.metrics.counter("serve.recompiles")
        self._requests = self.metrics.counter("serve.requests")
        # the flight recorder (duck-typed ``trigger(kind, payload)``): a
        # deadline breach is an incident worth a post-mortem
        self._flight = flight
        # fleet wiring: replica identity, deterministic fault hooks
        # (serve/faults.py), death and error reporting, and the
        # non-finite output guard the router's error-rate probe rides on
        self.replica_id = replica_id
        self._faults = faults
        self._check_outputs = bool(check_outputs)
        # standalone sessions own their lifecycle records; fleet
        # sub-requests carry the FLEET's record through submit(rec=...),
        # so a failed-over request keeps one decomposition across hops
        self.reqtrace = reqtrace.RequestTraceRing(self.metrics)
        self._queue = RequestQueue(
            sc.max_queue, self.metrics,
            on_timeout=self._on_deadline_breach,
            tenant_quotas=sc.tenant_quotas,
            default_tenant_quota=sc.default_tenant_quota)
        self._closed = False
        self._close_lock = threading.Lock()

        if program is not None:
            prog_dev = torch.device(getattr(program, "device", self.device))
            if prog_dev.type != self.device.type or None not in (
                    prog_dev.index, self.device.index) \
                    and prog_dev.index != self.device.index:
                raise ValueError(
                    f"program runs on {prog_dev}, the session on "
                    f"{self.device}")
            self._params = self._place_params(params, model, plan, program)
            self._program = program
            if self.mesh.size > 1:
                program = serve_mesh.MeshProgram(
                    program, self.mesh, self._tables, self._channel)
            self._batcher = None
            self._scheduler = ContinuousScheduler(
                program, self._params, sc, self.metrics, self._queue,
                on_deadline_breach=self._on_deadline_breach,
                replica_id=replica_id, faults=faults,
                on_fatal=on_fatal, on_error=on_error,
                follower=not self.leader)
            # graphs the program captured: the warmup's, and none after
            # (a params swap copies in place)
            self.metrics.gauge("serve.graph_captures").set_fn(
                lambda: getattr(self._program, "captures", 0))
            if self._channel is not None:
                if self.leader:
                    program.start_relay()
                else:
                    self._start_follower(
                        serve_mesh.follow, program, self._params,
                        self._scheduler._state, self._channel)
            return
        self._scheduler = None
        self._program = None

        if example_feed is None:
            raise ValueError(
                "one-shot serving needs params and example_feed (one "
                "request's feed dict, no batch dim)")
        self._completed = self.metrics.counter("serve.completed")
        self._batches = self.metrics.counter("serve.batches")
        self._latency = self.metrics.histogram("serve.request_latency_ms")
        self._occupancy = self.metrics.histogram("serve.batch_occupancy")
        self._step_ms = self.metrics.histogram("serve.step_ms")
        self._batcher_ms = self.metrics.histogram(
            "serve.batcher_overhead_ms")
        self._h2d_ms = self.metrics.histogram("serve.h2d_ms")
        self._infer_fn = infer_fn
        self._example = {k: np.asarray(v) for k, v in example_feed.items()}
        self._ragged = tuple(ragged_feeds)
        self._pad_value = pad_value
        unknown = set(self._ragged) - set(self._example)
        if unknown:
            raise ValueError(
                f"ragged_feeds {sorted(unknown)} not in example_feed "
                f"{sorted(self._example)}")
        if self._ragged and not sc.length_buckets:
            raise ValueError(
                "ragged_feeds declared but ServeConfig.length_buckets "
                "is unset; declare the length signature set so live "
                "traffic cannot recapture")
        for name in self._ragged:
            if self._example[name].ndim < 1:
                raise ValueError(
                    f"ragged feed {name!r} must have a length axis "
                    f"(ndim >= 1)")
        self._batch_buckets = sc.resolved_batch_buckets()
        self._params = self._place_params(params, model, plan, None)
        # the admitted per-request signatures: a submit whose padded
        # feed is not one of these is REFUSED at admission (it could
        # only be served by a capture at serve time)
        lengths = (sc.length_buckets if self._ragged else None) or (None,)
        self._admitted = {
            bucketing.batch_signature(self._padded_example(L))
            for L in lengths}
        # batch signature -> its captured graph and static inputs;
        # filled by warmup(), consulted on every dispatch (a miss is a
        # capture at serve time, counted)
        self._signatures: Dict[tuple, _Signature] = {}
        self.warmup_seconds: Dict[tuple, float] = {}
        self.metrics.gauge("serve.graph_captures").set_fn(
            lambda: sum(1 for g in self._signatures.values()
                        if g.graph is not None))
        if warmup:
            self.warmup()
        self._batcher = None
        if not self.leader:
            self._start_follower(self._follow_batches)
            return
        self._batcher = MicroBatcher(self._queue, self._run_batch,
                                     sc.max_batch, sc.max_wait_ms,
                                     on_error=on_error,
                                     on_fatal=on_fatal)

    # -- placement over the mesh -------------------------------------------

    def _place_params(self, params, model, plan, program):
        """The served tree on this rank (module doc): taken as it lies
        under ``plan``; this rank's parts by the engine's plan with
        ``model``; else every leaf whole. Sets ``_plan``, ``_tables``
        (the row-sharded tables the lookup scope registers) and
        ``_gathered`` (leaves split over ranks and gathered for use)."""
        self._borrowed = plan is not None
        if plan is None and model is not None:
            plan = engine_lib.plan_for_params(
                model, self.mesh, self._config, params,
                self._plan_example_batch(program))
        self._plan = plan
        self._tables, self._gathered = [], False
        if plan is None:
            return _to_device(params, self.device)
        local = {engine_lib.EXPERT: "expert", engine_lib.STAGE: "stage",
                 engine_lib.TP_COLUMN: "tensor", engine_lib.TP_ROW: "tensor"}
        refused = sorted((path, local[pl]) for path, pl
                         in plan.placements.items() if pl in local)
        if any(kind == "expert" for _, kind in refused) \
                and program is not None:
            raise NotImplementedError(
                f"serving expert-parallel weights ({refused}) over a mesh: "
                f"a decode step would need the MoE all_to_all dispatch "
                f"(ops.moe), which runs in training only; serve the model "
                f"without model= (its weights whole on every rank)")
        if refused:
            raise NotImplementedError(
                f"serving {refused} over a mesh: a rank's part of a "
                f"tensor-, expert- or stage-parallel weight needs that "
                f"parallelism's collectives in the served forward")
        self._gathered = bool(plan.gathered)
        if self._gathered and program is not None:
            raise NotImplementedError(
                f"serving a decode program with {plan.gathered} split over "
                f"ranks and gathered for use: the program's graphs read "
                f"the served leaves themselves")
        if not self._borrowed:
            params = plan.local_tree(_to_device(params, self.device))
        flat = dict(classify.flatten(params))
        self._tables = [(flat[p], plan.var_specs[p].shape, p)
                        for p in plan.sharded_tables]
        return params

    def _plan_example_batch(self, program):
        """A full-batch example feed for the plan's classification: the
        caller's ``plan_feed``, the program's training feed
        (``plan_feed``), or the one-shot example at the longest length
        bucket."""
        if self._plan_feed is not None:
            return self._plan_feed
        b = int(self._config.serve_config.max_batch)
        if program is not None:
            return program.plan_feed(b)
        ex = self._padded_example(self._max_length_bucket())
        return {k: np.stack([v] * b) for k, v in ex.items()}

    def _max_length_bucket(self) -> Optional[int]:
        lb = self._config.serve_config.length_buckets
        return lb[-1] if lb and self._ragged else None

    def _split(self, bucket: int) -> bool:
        """Does a batch of ``bucket`` rows split over the mesh's ranks
        (each its rows of dim 0)? Decided per bucket, so the placement is
        part of the signature (``_batch_sharding_fn`` of the JAX
        session)."""
        return self.mesh.size > 1 and bucket % self.mesh.size == 0

    def _rows(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This rank's rows of a batch that splits over the ranks."""
        n = next(iter(batch.values())).shape[0] // self.mesh.size
        r = self.rank
        return {k: v[r * n:(r + 1) * n] for k, v in batch.items()}

    # -- the followers -----------------------------------------------------

    def _start_follower(self, fn, *args) -> None:
        def run():
            try:
                if self.device.type == "cuda":
                    # a new thread starts on device 0; this rank's is its own
                    torch.cuda.set_device(self.device)
                fn(*args)
            except BaseException as e:
                self._follow_error = e
                parallax_log.error("serving follower rank %d stopped: %s: "
                                   "%s", self.rank, type(e).__name__, e)

        self._follower = threading.Thread(
            target=run, name=f"parallax-serve-follower-{self.rank}",
            daemon=True)
        self._follower.start()

    def _follow_batches(self) -> None:
        """A one-shot follower: each batch the leader formed runs through
        its signature on this rank, until the leader's stop."""
        while True:
            msg = self._channel.recv()
            if msg[0] == "stop":
                return
            batch = msg[1]
            entry = self._entry(bucketing.batch_signature(batch), batch)
            self._stage(entry, batch)
            self._infer(entry)

    # -- the bounded signature set ----------------------------------------

    def _padded_example(self, L: Optional[int]) -> Dict[str, np.ndarray]:
        """The example feed with every ragged feed padded to length
        ``L`` (identity when no length buckets are declared)."""
        if L is None or not self._ragged:
            return self._example
        out = dict(self._example)
        for name in self._ragged:
            out[name] = bucketing.pad_axis0(
                out[name][:L], L, self._pad_value)
        return out

    def _signature_set(self):
        """Every (batch bucket, length bucket) example batch the session
        serves — the COMPLETE set warmup captures."""
        lengths = (self._config.serve_config.length_buckets
                   if self._ragged else None) or (None,)
        for L in lengths:
            ex = self._padded_example(L)
            for b in self._batch_buckets:
                yield (b, L), {name: np.stack([v] * b)
                               for name, v in ex.items()}

    def _prepare(self, batch: Dict[str, np.ndarray]) -> _Signature:
        """Static device inputs for ``batch``'s signature (this rank's
        rows where it splits over the ranks), filled with ``batch``, and
        — on the card outside ``compile.disable_capture()`` —
        ``infer_fn`` captured over them (its warm call runs on these
        values)."""
        split = self._split(next(iter(batch.values())).shape[0])
        rows = self._rows(batch) if split else batch
        inputs = {name: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for name, v in rows.items()}
        graph = None
        if graphs_lib.capture_enabled(self.device):
            graph = graphs_lib.capture(self._infer_call(inputs, split),
                                       self.device)
        return _Signature(inputs, graph, split)

    def _infer_call(self, inputs, split: bool):
        axes = mesh_lib.BATCH_AXES if split else ()

        def call():
            with serve_mesh.lookup_scope(self.mesh, self._tables, axes):
                params = self._plan.loss_view(self._params) \
                    if self._gathered else self._params
                return self._infer_fn(params, inputs)
        return call

    def _entry(self, key, batch) -> _Signature:
        """The signature of a formed batch; a miss is a capture at serve
        time (every rank takes it together), counted loudly."""
        entry = self._signatures.get(key)
        if entry is None:
            # the signature set was supposed to be closed — count it and
            # serve the request anyway
            self._recompiles.inc()
            parallax_log.warning(
                "serve dispatch missed the captured signature set (%s); "
                "capturing at serve time — declare batch/length buckets "
                "covering this shape", [(k, s) for k, s, _ in key])
            entry = self._signatures[key] = self._prepare(batch)
        return entry

    def _stage(self, entry: _Signature, batch) -> None:
        """This rank's rows of ``batch`` into the signature's inputs."""
        for name, v in (self._rows(batch) if entry.split
                        else batch).items():
            src = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                entry.inputs[name].copy_(src.pin_memory(),
                                         non_blocking=True)
            else:
                entry.inputs[name].copy_(src)

    def _infer(self, entry: _Signature):
        """One call of the signature: (the output tree's skeleton, its
        leaves), gathered along dim 0 over the ranks where the batch was
        split. A graph's outputs are overwritten by its next replay."""
        if entry.graph is not None:
            out = entry.graph.replay()
        else:
            out = self._infer_call(entry.inputs, entry.split)()
        leaves: list = []
        skel = _flatten(out, leaves)
        if entry.split:
            leaves = [_gather_rows(a, self.mesh)
                      if isinstance(a, torch.Tensor) and a.ndim >= 1
                      else a for a in leaves]
        return skel, leaves

    def warmup(self) -> Dict[tuple, float]:
        """Capture every declared (batch, length) signature (on the
        card; the CPU only registers them); idempotent. Returns
        {(batch, length): seconds}."""
        stats: Dict[tuple, float] = {}
        for key, batch in self._signature_set():
            sig = bucketing.batch_signature(batch)
            if sig in self._signatures:
                continue
            t0 = time.perf_counter()
            with trace.span("serve.warmup_compile", batch=key[0],
                            length=key[1]):
                self._signatures[sig] = self._prepare(batch)
            dt = time.perf_counter() - t0
            self.metrics.histogram("serve.compile_seconds").record(dt)
            stats[key] = dt
            parallax_log.info(
                "serve warmup: signature batch=%s length=%s ready in "
                "%.2fs", key[0], key[1], dt)
        self.warmup_seconds.update(stats)
        return stats

    # -- admission ---------------------------------------------------------

    def submit(self, feed: Dict[str, Any],
               deadline_ms: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               rec: Optional[reqtrace.RequestRecord] = None,
               tenant: Any = None,
               slo_class: Optional[str] = None) -> Request:
        """Admit one request; returns its :class:`Request` future (the
        outputs tree in one-shot mode, the decoded token array in decode
        mode).

        Raises :class:`ServeOverloaded` when admission control sheds it
        (queue full, or an armed ``saturate`` fault),
        :class:`TenantQuotaExceeded` when ``tenant`` is at its admission
        quota, :class:`ServeClosed` after ``close()``, and
        ``ValueError`` for a feed outside the declared serving set or a
        ``max_new_tokens`` the program cannot take. The deadline
        (``deadline_ms``, else the ``slo_class`` deadline, else
        ``ServeConfig.default_deadline_ms``) bounds QUEUE+SERVE time: an
        expired request is dropped with :class:`DeadlineExceeded`
        instead of served late. ``slo_class`` sets the queue priority in
        decode mode; one-shot batch formation stays FIFO by group and
        takes only the class deadline.

        ``rec`` is the fleet's lifecycle record when this submit is a
        failover hop (the record accumulates across hops); standalone
        submits get a fresh one (None with the obs layer disabled)."""
        if not self.leader:
            raise ValueError(
                f"submit on rank {self.rank}: a serving mesh admits "
                f"requests on rank 0, its leader; this rank follows")
        t_sub = time.perf_counter()
        sc = self._config.serve_config
        if self._faults is not None:
            # chaos hook: an armed `saturate` fault sheds here, as a
            # full queue would (ServeOverloaded, retryable)
            self._faults.on_admission(self.replica_id)
        slo_rank, slo_ddl_ms = sc.resolve_slo_class(slo_class)
        ddl_ms = (deadline_ms if deadline_ms is not None
                  else slo_ddl_ms if slo_ddl_ms is not None
                  else sc.default_deadline_ms)
        deadline = (time.perf_counter() + float(ddl_ms) / 1e3
                    if ddl_ms is not None else None)
        if self._scheduler is not None:
            req = self._scheduler.make_request(feed, deadline,
                                               max_new_tokens,
                                               tenant=tenant,
                                               slo_rank=slo_rank)
        else:
            req = self._make_one_shot_request(feed, deadline,
                                              tenant=tenant,
                                              slo_rank=slo_rank)
        if rec is None and obs_state.enabled:
            rec = reqtrace.RequestRecord(req.id, t0=t_sub,
                                         deadline=deadline,
                                         ring=self.reqtrace)
        if rec is not None:
            req.rec = rec
            rec.note_hop(self.replica_id)
            rec.mark("queue_wait")
        self._requests.inc()
        try:
            self._queue.put(req)  # raises ServeOverloaded / ServeClosed
        except ServeError as e:
            if rec is not None:
                # the refused placement never held the request
                rec.drop_hop()
                # a replica-level shed is retryable at the fleet tier —
                # only a standalone record finalizes here
                rec.attempt_failed("shed" if isinstance(
                    e, ServeOverloaded) else "closed")
            raise
        if self._scheduler is not None:
            self._scheduler.kick()
        return req

    def _make_one_shot_request(self, feed, deadline, tenant=None,
                               slo_rank: int = 0) -> Request:
        feed = {k: np.asarray(v) for k, v in feed.items()}
        if set(feed) != set(self._example):
            raise ValueError(
                f"feed names {sorted(feed)} != example names "
                f"{sorted(self._example)}")
        if self._ragged:
            lb = self._config.serve_config.length_buckets
            longest = max(feed[n].shape[0] for n in self._ragged)
            L = bucketing.length_bucket(longest, lb)
            if L is None:
                raise ValueError(
                    f"request length {longest} exceeds the largest "
                    f"declared length bucket {lb[-1]}")
            for name in self._ragged:
                feed[name] = bucketing.pad_axis0(feed[name], L,
                                                 self._pad_value)
        # requests in one device batch must share a signature
        group_key = bucketing.batch_signature(feed)
        if group_key not in self._admitted:
            raise ValueError(
                f"request signature {[(n, s) for n, s, _ in group_key]} "
                f"is outside the declared serving set "
                f"{sorted([(n, s) for n, s, _ in sig] for sig in self._admitted)}; "
                f"serving it would capture at serve time — fix the "
                f"feed shapes or declare matching length_buckets")
        return Request(feed, deadline=deadline, group_key=group_key,
                       tenant=tenant, slo_rank=slo_rank)

    def _on_deadline_breach(self, n: int = 1,
                            where: str = "queue") -> None:
        """SLO-breach hook: every deadline expiry (queued, at dispatch,
        or during service) triggers one flight dump, when a recorder is
        attached."""
        if self._flight is not None:
            self._flight.trigger(
                "serve_deadline_breach",
                {"where": where, "n": int(n),
                 "timeouts_total": self.metrics.counter(
                     "serve.timeouts").value})

    def request_records(self, last: Optional[int] = None):
        """Snapshots of recently completed request lifecycle records."""
        return self.reqtrace.records(last)

    def prefix_stats(self) -> Optional[Dict[str, Any]]:
        """The prefix cache's own snapshot (entries, cached pages,
        pinned entries, insertions/evictions); None in one-shot mode or
        with ``ServeConfig.prefix_cache`` off."""
        if self._scheduler is None:
            return None
        return self._scheduler.prefix_stats()

    # -- dispatch (batcher thread) -------------------------------------------

    def _run_batch(self, requests) -> None:
        t_host0 = time.perf_counter()
        fault_mode = (self._faults.on_dispatch(self.replica_id)
                      if self._faults is not None else None)
        # deadline re-check at dispatch: form_group sheds while requests
        # WAIT, but one can expire between dequeue and here — spend no
        # device time on a caller who already gave up
        live = []
        n_expired = 0
        for r in requests:
            if r.deadline is not None and t_host0 > r.deadline:
                self.metrics.counter("serve.timeouts").inc()
                n_expired += 1
                r._fail(DeadlineExceeded(
                    f"request {r.id} deadline expired at dispatch"))
            else:
                live.append(r)
        if n_expired:
            self._on_deadline_breach(n_expired, where="dispatch")
        requests = live
        if not requests:
            return
        for r in requests:
            if r.rec is not None:
                # the one-shot service phase: batch formation, the copy
                # in, the device step and the split, ended by
                # _complete/_fail
                r.rec.mark("service", t_host0)
        n = len(requests)
        bucket = next(b for b in self._batch_buckets if b >= n)
        batch = {}
        for name in requests[0].feed:
            rows = [r.feed[name] for r in requests]
            if n < bucket:
                # edge-pad with the last real request's row (finite for
                # finite data; padded rows are discarded at split time)
                rows = rows + [rows[-1]] * (bucket - n)
            batch[name] = np.stack(rows)
        key = bucketing.batch_signature(batch)
        t_form = time.perf_counter()
        if self._channel is not None:
            # the followers replay this batch (serve/mesh.py)
            self._channel.send(("batch", batch))
        entry = self._entry(key, batch)
        with trace.span("serve.h2d_place", bucket=bucket):
            self._stage(entry, batch)
        t_host1 = time.perf_counter()
        # H2D is the feed path (any inference pays it, batched or not):
        # recorded on its own, NOT as batcher overhead
        self._h2d_ms.record((t_host1 - t_form) * 1e3)
        with trace.span("serve.infer", n=n, bucket=bucket):
            # the copy to the host waits for the step
            skel, leaves = self._infer(entry)
            leaves = [_host(a) for a in leaves]
        if fault_mode == "nan":
            # injected silent corruption: every float leaf becomes NaN
            # AFTER the device step (serve/faults.py)
            leaves = [np.full_like(a, np.nan)
                      if np.issubdtype(a.dtype, np.floating) else a
                      for a in leaves]
        if self._check_outputs and any(
                np.issubdtype(a.dtype, np.floating)
                and not np.all(np.isfinite(a)) for a in leaves):
            # non-finite output is a replica-health incident, not a
            # result: fail the batch with the RETRYABLE error (a fleet
            # re-serves it on a healthy replica); on_error feeds the
            # router's error-rate probe through the batcher
            self.metrics.counter("serve.nonfinite_batches").inc()
            raise ReplicaUnavailable(
                f"replica {self.replica_id!r} produced non-finite "
                f"output for a batch of {len(requests)} request(s)")
        t_step = time.perf_counter() - t_host1
        t_host2 = time.perf_counter()
        now = t_host2
        batched = [a.ndim >= 1 for a in leaves]
        delivered = 0
        n_late = 0
        for i, r in enumerate(requests):
            if r.deadline is not None and now > r.deadline:
                # the step itself overran the budget: "meet it or shed
                # it" — a late result is DROPPED, never delivered
                self.metrics.counter("serve.timeouts").inc()
                n_late += 1
                r._fail(DeadlineExceeded(
                    f"request {r.id} missed its deadline by "
                    f"{(now - r.deadline) * 1e3:.1f}ms during service"))
                continue
            r._complete(_unflatten(skel, [a[i] if s else a for a, s
                                          in zip(leaves, batched)]))
            delivered += 1
            self._latency.record((now - r.t_enqueue) * 1e3)
            trace.record_span(
                "serve.request", r.t_enqueue, now, id=r.id,
                batch=bucket, replica=self.replica_id,
                rid=(r.rec.key if r.rec is not None else r.id),
                hops=(len(r.rec.hops) if r.rec is not None else 1))
        if n_late:
            self._on_deadline_breach(n_late, where="service")
        self._completed.inc(delivered)
        self._batches.inc()
        self._occupancy.record(n / bucket)
        self._step_ms.record(t_step * 1e3)
        # the batching layer's own host cost on the dispatch path: batch
        # formation (stack, pad, signature lookup) + result split +
        # bookkeeping, beyond the feed copy and the device step
        self._batcher_ms.record(
            ((t_form - t_host0)
             + (time.perf_counter() - t_host2)) * 1e3)

    # -- exported prefill ------------------------------------------------------

    def prefill_only(self, feed: Dict[str, Any]):
        """Run ONLY the prefill of one request, on the caller's thread
        (the disaggregated prefill pool's unit of work). Returns
        ``(prepared_feed, prefix_key, request_state)``: the feed padded
        onto the program's fixed shapes, the radix key the result is
        cacheable under, and the request state — tensors the caller
        owns (the program's ``prefill_owned``: the same math, run
        eagerly, touching no buffer the serving loop replays into)."""
        if self._scheduler is None:
            raise ValueError(
                "prefill_only requires continuous-decode mode "
                "(program=...)")
        self._one_rank("prefill_only")
        prog = self._program
        if not hasattr(prog, "prefix_key"):
            raise ValueError(
                "prefill_only requires a program exposing prefix_key "
                "(the transfer protocol is keyed by it)")
        if self._faults is not None:
            # chaos hook: an armed crash on this replica fires on the
            # prefill path too (a kill mid-transfer)
            self._faults.on_dispatch(self.replica_id)
        if not self._scheduler.alive:
            raise ReplicaUnavailable(
                f"prefill replica {self.replica_id!r} is dead")
        prepared = prog.prepare_feed(feed)
        chunks = int(getattr(prog, "num_prefill_chunks", 1))
        with trace.span("serve.prefill_export", chunks=chunks):
            rs = prog.prefill_owned(self._params, prepared)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        return prepared, prog.prefix_key(prepared), rs

    def import_prefix_entry(self, tenant, key, request_state,
                            positions: int = 0) -> bool:
        """Install an externally prefilled request state into this
        session's prefix cache; see :meth:`~parallax_tpu_torch.serve.
        continuous.ContinuousScheduler.import_prefix`. Thread-safe."""
        if self._scheduler is None:
            raise ValueError(
                "import_prefix_entry requires continuous-decode mode "
                "(program=...)")
        self._one_rank("import_prefix_entry")
        return self._scheduler.import_prefix(tenant, key, request_state,
                                             positions=positions)

    # -- live weight swap ------------------------------------------------------

    def swap_params(self, params) -> None:
        """Replace the served parameters IN PLACE — the primitive under
        :meth:`ServeFleet.push_weights`.

        The new tree must match the served one in structure, leaf shapes
        and dtypes; a mismatch is refused (``ValueError``). The values
        are copied into the session's own leaves (and a program's cast
        copy is refreshed in place), so every captured graph keeps
        reading the same addresses and nothing is captured again
        (``serve.graph_captures`` and ``serve.recompiles`` do not move)
        — the counterpart of the JAX package's swap without recompiles.
        Quiesce first (:meth:`idle`) so no sequence mixes weights.
        Counted in ``serve.hotswaps``."""
        self._one_rank("swap_params")
        if self._borrowed:
            raise ValueError(
                "swap_params on a session serving a training state's own "
                "tensors (ParallaxSession.serve): they are the training "
                "state's to update; serve a copy (ServeSession(..., "
                "model=)) to swap weights")
        old = list(_leaves(self._params))
        new = list(_leaves(params))
        if [p for p, _ in old] != [p for p, _ in new]:
            raise ValueError(
                "swap_params: new params tree structure differs from the "
                f"served one ({[p for p, _ in new]} vs "
                f"{[p for p, _ in old]})")
        for (path, a), (_, b) in zip(old, new):
            b = torch.as_tensor(b)
            if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                raise ValueError(
                    f"swap_params: leaf {path} changed "
                    f"{tuple(a.shape)}/{a.dtype} -> "
                    f"{tuple(b.shape)}/{b.dtype}; the captured graphs "
                    f"would be invalidated — rebuild the session for a "
                    f"different architecture")
        with trace.span("serve.hotswap"), torch.no_grad():
            for (_, a), (_, b) in zip(old, new):
                a.copy_(torch.as_tensor(b))
            refresh = getattr(self._program, "refresh_params", None)
            if refresh is not None:
                refresh(self._params)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if self._scheduler is not None:
            self._scheduler.set_params(self._params)
        self.metrics.counter("serve.hotswaps").inc()
        parallax_log.info("serve: swapped params on replica %r in place "
                          "(%d leaves, no capture)", self.replica_id,
                          len(old))

    def _one_rank(self, what: str) -> None:
        if self.mesh.size > 1:
            raise NotImplementedError(
                f"{what} over a mesh of {self.mesh.size} ranks: it would "
                f"have to reach every rank's copy of the served state")

    # -- replica probes --------------------------------------------------------

    @property
    def alive(self) -> bool:
        """False once the dispatch loop died (a fatal fault); a dead
        replica sheds at admission (its queue is closed)."""
        if self._scheduler is not None:
            return self._scheduler.alive
        return self._batcher is None or self._batcher.alive

    @property
    def heartbeat(self) -> float:
        """``perf_counter`` time of the dispatch loop's last pass —
        stale while a step stalls (the router's straggler probe)."""
        if self._scheduler is not None:
            return self._scheduler.heartbeat
        return self._batcher.heartbeat

    def load(self) -> float:
        """Queued + in-flight work: a router's placement score."""
        n = float(len(self._queue))
        if self._scheduler is not None:
            n += self._scheduler._active() + len(self._scheduler._pending)
        elif self._batcher is not None and self._batcher.busy:
            n += 1.0
        return n

    def idle(self) -> bool:
        """Nothing queued and nothing in flight — the quiesced state a
        params swap requires."""
        if self._scheduler is not None:
            return self._scheduler.idle()
        return len(self._queue) == 0 and not (
            self._batcher is not None and self._batcher.busy)

    # -- introspection / teardown ------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """JSON-ready snapshot of every ``serve.*`` metric."""
        return {k: v for k, v in self.metrics.snapshot().items()
                if k.startswith("serve.")}

    def close(self, drain: bool = True) -> None:
        """Stop admission; with ``drain`` (default) serve the accepted
        queue to completion (bounded by ``ServeConfig.drain_timeout_s``),
        then fail whatever remains with :class:`ServeClosed`. A decode
        session releases its program. Idempotent."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        sc = self._config.serve_config
        self._queue.close()
        if not self.leader:
            # a follower ends with the leader's stop (its close)
            self._follower.join()
            if self._scheduler is not None:
                self._scheduler._release()
            self._release_mesh_graphs()
            if self._follow_error is not None:
                raise RuntimeError(
                    f"serving follower rank {self.rank} stopped before the "
                    f"leader's close") from self._follow_error
            return
        timeout = sc.drain_timeout_s if drain else 0.0
        if self._scheduler is not None:
            self._scheduler.drain(timeout)
        elif self._batcher is not None:
            self._batcher.drain(timeout)
        if self._channel is not None:
            self._channel.send(serve_mesh.STOP)
        n = self._queue.fail_all(ServeClosed("session closed"))
        if n:
            parallax_log.warning(
                "serve close: failed %d undrained request(s)", n)
        self._release_mesh_graphs()

    def _release_mesh_graphs(self) -> None:
        """Over more than one rank, destroy the graphs the warmup
        captured, once the serving loop has stopped: they record the
        mesh's NCCL collectives, and NCCL's destroy of a communicator
        (``destroy_process_group``) waits until every graph that holds
        it is gone, which a closed session kept alive by any reference
        would never let happen."""
        if self.mesh.size == 1:
            return
        loop = self._scheduler if self._scheduler is not None \
            else self._batcher
        thread = getattr(loop, "_thread", None)
        if thread is not None and thread.is_alive():
            parallax_log.warning(
                "serve close: the serving loop is still running; its "
                "graphs stay alive and destroy_process_group will wait "
                "for them")
            return
        if self._program is not None:
            release = getattr(self._program, "release_graphs", None)
            if release is not None:
                release()
            return
        sigs = [e for e in self._signatures.values() if e.graph is not None]
        if sigs and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for e in sigs:
            e.graph.release()
            e.graph = None

    def __enter__(self) -> "ServeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
