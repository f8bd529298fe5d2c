"""Numerics observatory — per-layer gradient/param health, NaN
provenance forensics, and kernel-drift sentinels (the JAX package's
``obs/numwatch.py``).

Three instruments, all riding the obs substrate:

**Per-layer tree stats** (``tree_prefix_stats`` / ``step_numerics``):
one reduction the engine adds to the step, computing per param-tree
prefix ("layer") the grad norm/absmax, non-finite count, bf16 underflow
fraction (nonzero grad entries below bf16 round-off of the layer's
absmax — entries a bf16 accumulation swallows), param norm, and update
ratio ``‖Δw‖/‖w‖``. The JAX package gates the sample inside its
compiled step with ``lax.cond``; a CUDA graph has no data-dependent
branch, so on the card the engine captures a SECOND graph of the step
per signature that also computes the stats (as one ``[layers, 6]``
tensor), and the host picks the graph by ``step % interval``
(core/engine.py). Off-steps output a host zeros tree with
``_sampled=0``, which the consumer drops without touching the card.

The JAX package also forces the sample on a non-finite step inside the
graph. Here the host learns of the trip only after the step; the
session's recovery path then computes the trip step's tree
(:meth:`Engine.trip_numerics`) from the gradients the step left in its
buffers (exact: the grad stats provenance reads), the poisoned
post-step parameters and the recovery snapshot as the pre-step
parameters (exact when the snapshot is of the step before; otherwise
``param_norm`` and ``update_ratio`` span the steps since the snapshot,
and the provenance detail says so). Without recovery the trip step is
not forced.

**NumericsMonitor**: the lazy host-side consumer (the same
park-then-drain discipline as ``obs/health.py`` — ``observe`` never
blocks dispatch on device values; a sample's ``[layers, 6]`` tensor is
copied ``non_blocking`` into pinned memory behind a CUDA event and
drains when the event completes or at the pending cap). Consumed
samples become ``numerics.<layer>.<stat>`` gauges, a bounded stats
*trail* (the forensics lead-in), chrome-trace lanes, and anomaly-
detector feeds over update-ratio / underflow trends (which in turn
drive ``HealthMonitor``'s instability score).

**NaN provenance** (``provenance_report``): when the auto-rollback
trips, the session sweeps in dataflow order — input feeds, then the
(pre-rollback, already-poisoned) param tree per prefix, then the trip
step's grad stats, then the loss — and names the FIRST non-finite item
(``feed/x``, ``param/w``, ``grad/decoder``, ``loss``). The counts run
on the tensors' device (one reduction a leaf) and only the totals come
to the host.

**Drift sentinels** (``DriftSentinel`` + the built-in pairs): shadow
evals comparing a hand-written kernel against its plain executor — the
LSTM forward with residuals and backward (B2/B3: at the pair's fp32
shape ``csrc/lstm_f32_sm90.cu`` and ``csrc/lstm.cu``) against the plain
backward on the weight
gradient, and the paged decode (B7, ``csrc/paged_attention.cu``)
against the plain gather on decode outputs — exporting rel-error /
argmax-flip gauges. Argmax flips are margin-aware: a flip only counts
where the reference's top-2 margin exceeds ``argmax_margin``. On the
CPU both sides run the plain versions. A kernel that fails to build or
launch raises out of ``check()``.

Everything here honors the process-wide killswitch: with
``PARALLAX_OBS=0`` the engine captures no second graph and outputs no
``numerics``, and the session constructs no monitor.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from parallax_tpu_torch.obs import _state, trace
from parallax_tpu_torch.obs.metrics import MetricsRegistry

# Per-prefix stat names, in the order they are documented. Keys of the
# inner dict of tree_prefix_stats(); also the gauge suffixes and the
# columns of the engine's [layers, 6] stats tensor.
STAT_NAMES = ("grad_norm", "grad_absmax", "nonfinite", "underflow_frac",
              "param_norm", "update_ratio")

# Flag leaf marking whether the step computed stats (1.0) or shipped
# the zeros tree (0.0).
SAMPLED_KEY = "_sampled"

_EPS = 1e-12
# bf16 round-off: nonzero grads below this fraction of the layer's
# absmax are swallowed by a bf16 accumulation against it
_BF16_ROUND = 2.0 ** -8


# ---------------------------------------------------------------------------
# prefix grouping
# ---------------------------------------------------------------------------

def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` of a nested dict/list tree with 'a/b/c'
    paths, dict keys in sorted order (the JAX package's
    ``tree_flatten_with_path`` order)."""
    if isinstance(tree, dict):
        items = sorted(tree.items(), key=lambda kv: str(kv[0]))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(flatten(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def prefix_of(path: str) -> str:
    """Layer name of one leaf: the first component of its tree path."""
    return path.split("/", 1)[0] if path else "<root>"


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.issubdtype(np.asarray(x).dtype, np.inexact)


def _t(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if device is not None and t.device != device:
        t = t.to(device)
    return t.detach().float()


def _grouped(params_before, params_after, grads):
    """Zip the three trees leaf-wise, grouped by top-level prefix
    (sorted). Non-float leaves carry no numerics signal and are
    skipped."""
    flat_b = flatten(params_before)
    flat_a = [v for _, v in flatten(params_after)]
    flat_g = [v for _, v in flatten(grads)]
    groups: Dict[str, List[Tuple[Any, Any, Any]]] = {}
    for (path, w0), w1, g in zip(flat_b, flat_a, flat_g):
        if not _is_float(w0):
            continue
        groups.setdefault(prefix_of(path), []).append((w0, w1, g))
    return dict(sorted(groups.items()))


def stat_prefixes(params) -> List[str]:
    """Static layer-name list ``step_numerics`` will emit for this
    param tree (sorted; prefixes whose leaves are all non-float are
    absent)."""
    return sorted(_grouped(params, params, params))


# ---------------------------------------------------------------------------
# the stats
# ---------------------------------------------------------------------------

def _reduce_split(values: List[torch.Tensor], groups: List[Any],
                  op) -> List[torch.Tensor]:
    """``values`` (one tensor a leaf) with each split leaf's reduced over
    its group (one collective a group, stacked); the rest as they are."""
    from parallax_tpu_torch.ops import collectives
    by_group: Dict[tuple, Tuple[Any, List[int]]] = {}
    for i, group in enumerate(groups):
        if group is not None and group.size > 1:
            by_group.setdefault(group.ranks, (group, []))[1].append(i)
    out = list(values)
    for group, idx in by_group.values():
        stacked = torch.stack([out[i] for i in idx])
        collectives.all_reduce_(stacked, group, op)
        for k, i in enumerate(idx):
            out[i] = stacked[k]
    return out


def stats_matrix(groups: Sequence[Sequence[Tuple]]) -> torch.Tensor:
    """The ``[layers, 6]`` float32 stats tensor (columns ``STAT_NAMES``)
    from, per layer, its leaves' ``(w_sq, d_sq, g[, group])``: the
    squared norm of the pre-update weights, the squared norm of the
    update, and the gradient (None: a leaf whose gradient is zero, as a
    sliced table's dense gradient is), of the whole leaf or, with a
    ``group`` (a ``core.mesh.Group`` of more than one rank), of this
    rank's part of a leaf split over that group: its terms are summed
    over the group, its gradient's absmax taken as the group's max, so
    every rank gets the whole leaf's stats. Device ops only: capturable
    into a graph."""
    import torch.distributed as dist
    leaves = [(li, item[0], item[1], item[2],
               item[3] if len(item) > 3 else None)
              for li, items in enumerate(groups) for item in items]
    if not leaves:
        return torch.zeros((0, len(STAT_NAMES)))
    split = [grp for *_, grp in leaves]
    # the layer's absmax first: the underflow threshold reads it
    maxima = [g.detach().abs().amax().float() if g is not None
              and g.numel() else torch.zeros((), device=w.device)
              for _, w, _, g, _ in leaves]
    if any(grp is not None for grp in split):
        maxima = _reduce_split(maxima, split, dist.ReduceOp.MAX)
    absmax: Dict[int, torch.Tensor] = {}
    for (li, _, _, g, _), m in zip(leaves, maxima):
        if g is None:
            continue
        absmax[li] = m if li not in absmax else torch.maximum(absmax[li], m)
    terms = []
    for li, w2, d2, g, _ in leaves:
        zero = torch.zeros((), device=w2.device)
        if g is None:
            terms.append(torch.stack([zero, zero, zero, zero, w2, d2]))
            continue
        gf = g.detach().float()
        nz = gf != 0
        thresh = absmax[li] * _BF16_ROUND
        terms.append(torch.stack([
            gf.square().sum(), (~torch.isfinite(gf)).sum().float(),
            nz.sum().float(), (nz & (gf.abs() < thresh)).sum().float(),
            w2, d2]))
    if any(grp is not None for grp in split):
        terms = _reduce_split(terms, split, dist.ReduceOp.SUM)
    rows = []
    for li, items in enumerate(groups):
        mine = [t for (lj, *_), t in zip(leaves, terms) if lj == li]
        g_sq, g_bad, g_nz, g_under, w_sq, d_sq = torch.stack(mine).sum(0)
        dev = items[0][0].device
        g_absmax = absmax.get(li, torch.zeros((), device=dev))
        w_norm = torch.sqrt(w_sq)
        rows.append(torch.stack([
            torch.sqrt(g_sq), g_absmax, g_bad,
            g_under / torch.clamp(g_nz, min=1.0), w_norm,
            torch.sqrt(d_sq) / (w_norm + _EPS)]))
    return torch.stack(rows)


def leaf_terms(w0, w1, g):
    """``(w_sq, d_sq, g)`` of one leaf for :func:`stats_matrix`, on
    ``w1``'s device (``w0`` may be a host copy)."""
    w1 = _t(w1)
    w0 = _t(w0, w1.device)
    norm = torch.linalg.vector_norm
    return (norm(w0).square(), norm(w1 - w0).square(),
            None if g is None else _t(g, w1.device))


def tree_prefix_stats(params_before, params_after, grads) -> Dict:
    """One reduction pass: {layer: {stat: float32 0-d tensor}}.

    Stat definitions (per prefix, over its float leaves):
      grad_norm       l2 norm of the gradient slice
      grad_absmax     max |g| (inf/nan propagate — that is the signal)
      nonfinite       count of non-finite gradient entries
      underflow_frac  fraction of NONZERO grad entries with
                      ``|g| < 2**-8 × layer absmax`` — entries a bf16
                      accumulation against the layer's dominant
                      magnitudes swallows entirely. Exact-zero grads
                      don't count, so a sparse layer reads 0.0.
      param_norm      l2 norm of the pre-update weights
      update_ratio    ‖w_after - w_before‖ / (‖w_before‖ + eps)
    """
    groups = _grouped(params_before, params_after, grads)
    names = list(groups)
    mat = stats_matrix([[leaf_terms(w0, w1, g) for w0, w1, g in items]
                        for items in groups.values()])
    return {p: {s: mat[i, j] for j, s in enumerate(STAT_NAMES)}
            for i, p in enumerate(names)}


def zeros_tree(prefixes: Sequence[str]) -> Dict:
    """The off-step tree: every stat 0.0 and ``_sampled`` 0.0 (host
    floats: nothing to wait for)."""
    t: Dict[str, Any] = {p: {s: 0.0 for s in STAT_NAMES} for p in prefixes}
    t[SAMPLED_KEY] = 0.0
    return t


def step_numerics(params_before, params_after, grads, *, step,
                  interval: int, force=None) -> Dict:
    """The stats tree under the sampling gate: computed when ``step %
    interval == 0`` or ``force`` (a non-finite loss/grad), else the
    structurally identical zeros tree; ``_sampled`` (1.0/0.0) says
    which. The gate is read on the host (the JAX package's runs in the
    graph)."""
    if interval <= 0:
        raise ValueError(f"numerics interval must be > 0, got {interval}")
    sampled = int(step) % int(interval) == 0
    if force is not None:
        sampled = sampled or bool(_host_float(force))
    if not sampled:
        return zeros_tree(stat_prefixes(params_before))
    t = tree_prefix_stats(params_before, params_after, grads)
    t[SAMPLED_KEY] = torch.tensor(1.0)
    return t


class StatsTree:
    """A sampled step's stats, on their way to the host: the
    ``[layers, 6]`` tensor copied ``non_blocking`` into pinned memory
    with a CUDA event after the copy (on the CPU, the tensor itself).
    Reads like the JAX package's stats tree (``tree[layer][stat]``,
    ``tree["_sampled"]``); ``is_ready()`` never blocks, any read waits
    for the copy."""

    __slots__ = ("prefixes", "_host", "_event", "_tree")

    def __init__(self, prefixes: Sequence[str], matrix: torch.Tensor):
        self.prefixes = list(prefixes)
        self._tree = None
        if matrix.is_cuda:
            self._host = torch.empty(matrix.shape, dtype=torch.float32,
                                     pin_memory=True)
            self._host.copy_(matrix, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(matrix.device))
        else:
            self._host = matrix.detach().float()
            self._event = None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def host(self) -> Dict:
        """{layer: {stat: float}, "_sampled": 1.0} (waits for the copy)."""
        if self._tree is None:
            if self._event is not None:
                self._event.synchronize()
            rows = self._host.tolist()
            t: Dict[str, Any] = {
                p: dict(zip(STAT_NAMES, row))
                for p, row in zip(self.prefixes, rows)}
            t[SAMPLED_KEY] = 1.0
            self._tree = t
        return self._tree

    def get(self, key, default=None):
        return self.host().get(key, default)

    def __getitem__(self, key):
        return self.host()[key]

    def __iter__(self):
        return iter(self.host())

    def items(self):
        return self.host().items()

    def __repr__(self):
        return "StatsTree(%s)" % (self.host() if self.is_ready()
                                  else "<pending>")


# ---------------------------------------------------------------------------
# host-side lazy consumer
# ---------------------------------------------------------------------------

def _tree_ready(tree) -> bool:
    is_ready = getattr(tree, "is_ready", None)
    if callable(is_ready):
        return bool(is_ready())
    return True


def _host_float(v) -> float:
    if isinstance(v, torch.Tensor):
        return float(v.detach().float().cpu())
    return float(v)


class NumericsMonitor:
    """Lazy consumer of the step samples (obs/health.py pattern).

    ``observe(step, outputs['numerics'])`` parks the tree and returns
    immediately; pending samples drain when their copies are ready (or,
    past ``max_pending``, blocking — bounded memory beats unbounded
    laziness). Consumed samples become ``numerics.<layer>.<stat>``
    gauges, a bounded trail (the forensics lead-in), one
    ``numerics.sample`` chrome lane per consume, and anomaly feeds on
    ``numerics.<layer>.update_ratio`` / ``.underflow_frac``.

    Bookkeeping (``total_samples`` / ``total_skipped``) is plain-int,
    NOT registry counters, so it stays correct if the killswitch
    toggles mid-run — same reasoning as HealthMonitor's.
    """

    def __init__(self, registry: MetricsRegistry, interval: int, *,
                 anomaly=None, on_sample: Optional[Callable] = None,
                 trail_capacity: int = 64, max_pending: int = 64):
        self.registry = registry
        self.interval = int(interval)
        self.anomaly = anomaly
        self.on_sample = on_sample
        self.total_samples = 0
        self.total_skipped = 0
        self.last_step: Optional[int] = None
        self.last_stats: Optional[Dict[str, Dict[str, float]]] = None
        self._trail: collections.deque = collections.deque(
            maxlen=trail_capacity)
        self._pending: collections.deque = collections.deque()
        self._max_pending = max_pending
        # gauge objects cached per (layer, stat): the consume path runs
        # on the dispatch thread every sampled step
        self._gauges: Dict[Tuple[str, str], Any] = {}
        # RLock: a flight provider can fire from inside a consume
        # callback path without deadlocking (HealthMonitor precedent)
        self._lock = threading.RLock()

    def observe(self, step: int, stats) -> None:
        if not _state.enabled or stats is None:
            return
        with self._lock:
            self._pending.append((int(step), stats))
            self._drain(block=len(self._pending) > self._max_pending)

    def poll(self, block: bool = False) -> None:
        """Drain pending samples; ``block=True`` waits for all."""
        if not _state.enabled:
            return
        with self._lock:
            self._drain(block=block)

    def _drain(self, block: bool) -> None:
        while self._pending:
            step, stats = self._pending[0]
            if not block and not _tree_ready(stats):
                return
            self._pending.popleft()
            try:
                self._consume(step, stats)
            except Exception:
                # one poisoned buffer must not wedge the trail
                self.total_skipped += 1

    def _consume(self, step: int, stats) -> None:
        t0 = time.perf_counter()
        # flag first: the off-step skip path (most steps) must touch
        # ONE value, not the whole zeros tree
        flag = stats.get(SAMPLED_KEY)
        if flag is not None and _host_float(flag) < 0.5:
            self.total_skipped += 1
            return
        host: Dict[str, Dict[str, float]] = {}
        for key, val in stats.items():
            if key != SAMPLED_KEY:
                host[key] = {s: _host_float(v) for s, v in val.items()}
        self.total_samples += 1
        self.last_step = step
        self.last_stats = host
        self._trail.append({"step": step, "stats": host})
        self.registry.counter("numerics.samples").inc()
        worst_ur = 0.0
        bad_layers = 0
        gauges = self._gauges
        for prefix, vals in host.items():
            for s, v in vals.items():
                g = gauges.get((prefix, s))
                if g is None:
                    g = gauges[(prefix, s)] = self.registry.gauge(
                        f"numerics.{prefix}.{s}")
                g.set(v)
            worst_ur = max(worst_ur, vals["update_ratio"])
            if vals["nonfinite"] > 0:
                bad_layers += 1
            if self.anomaly is not None:
                self.anomaly.observe(f"numerics.{prefix}.update_ratio",
                                     step, vals["update_ratio"])
                self.anomaly.observe(f"numerics.{prefix}.underflow_frac",
                                     step, vals["underflow_frac"])
        if self.on_sample is not None:
            self.on_sample(step, host)
        trace.record_span("numerics.sample", t0, time.perf_counter(),
                          step=step, layers=len(host),
                          worst_update_ratio=round(worst_ur, 6),
                          nonfinite_layers=bad_layers)

    # -- forensics / reporting ------------------------------------------

    def trail(self) -> List[Dict]:
        with self._lock:
            return list(self._trail)

    def trail_tail(self, n: int = 16) -> List[Dict]:
        with self._lock:
            return list(self._trail)[-n:]

    def report(self) -> Dict:
        """Blocking summary (close/CLI path): drains pending first."""
        self.poll(block=True)
        with self._lock:
            return {
                "interval": self.interval,
                "samples": self.total_samples,
                "skipped": self.total_skipped,
                "last_step": self.last_step,
                "layers": self.last_stats,
            }

    def snapshot_for_dump(self) -> Dict:
        """Non-blocking flight section — a dump on a wedged device
        must not hang draining pending samples."""
        with self._lock:
            return {
                "interval": self.interval,
                "samples": self.total_samples,
                "skipped": self.total_skipped,
                "pending": len(self._pending),
                "last_step": self.last_step,
                "trail": list(self._trail),
            }


# ---------------------------------------------------------------------------
# NaN provenance
# ---------------------------------------------------------------------------

def _count_nonfinite(leaf) -> Tuple[int, int, bool]:
    """(size, non-finite entries, is float) of one leaf, counted on its
    device."""
    if isinstance(leaf, torch.Tensor):
        size = leaf.numel()
        if not leaf.is_floating_point():
            return size, 0, False
        return size, int((~torch.isfinite(leaf.detach())).sum()), True
    a = np.asarray(leaf)
    if not np.issubdtype(a.dtype, np.floating):
        return int(a.size), 0, False
    return int(a.size), int(a.size - np.count_nonzero(np.isfinite(a))), True


def _scan_array(name: str, arr) -> Dict:
    size, bad, _ = _count_nonfinite(arr)
    entry = {"name": name, "size": int(size), "nonfinite": bad}
    if bad:
        entry["finite_frac"] = round(1.0 - bad / max(size, 1), 6)
    return entry


def provenance_report(*, feeds=None, params=None, trip_stats=None,
                      loss=None, step=None, kind=None) -> Dict:
    """Blast-radius report naming the first non-finite item.

    The sweep follows dataflow order — the earliest poisoned stage is
    the root cause, everything after it is blast radius:

      1. ``feed/<key>``  — the offending batch's input arrays
      2. ``param/<layer>`` — the live (pre-rollback, so already
         poisoned if the optimizer applied a NaN update) weight tree
      3. ``grad/<layer>`` — non-finite counts from the trip step's
         stats tree
      4. ``loss``

    Blocking (reads device counts) — this only runs on the incident
    path, where the rollback is already stalling dispatch.
    """
    checks: List[Dict] = []
    if feeds is not None:
        for path, leaf in sorted(flatten(feeds), key=lambda kv: kv[0]):
            checks.append(_scan_array(f"feed/{path}", leaf))
    if params is not None:
        groups: Dict[str, int] = {}
        sizes: Dict[str, int] = {}
        for path, leaf in flatten(params):
            size, bad, is_float = _count_nonfinite(leaf)
            if not is_float:
                continue
            p = prefix_of(path)
            groups[p] = groups.get(p, 0) + bad
            sizes[p] = sizes.get(p, 0) + size
        for p in sorted(groups):
            e = {"name": f"param/{p}", "size": sizes[p],
                 "nonfinite": groups[p]}
            if groups[p]:
                e["finite_frac"] = round(
                    1.0 - groups[p] / max(sizes[p], 1), 6)
            checks.append(e)
    trip_sampled = False
    if trip_stats is not None:
        host = {k: v for k, v in trip_stats.items() if k != SAMPLED_KEY}
        flag = trip_stats.get(SAMPLED_KEY)
        trip_sampled = flag is None or _host_float(flag) >= 0.5
        if trip_sampled:
            for prefix in sorted(host):
                bad = int(_host_float(host[prefix]["nonfinite"]))
                checks.append({"name": f"grad/{prefix}",
                               "nonfinite": bad,
                               "grad_absmax": _host_float(
                                   host[prefix]["grad_absmax"])})
    if loss is not None:
        checks.append(_scan_array("loss", loss))
    culprit = next((c["name"] for c in checks if c["nonfinite"] > 0), None)
    return {
        "step": step,
        "kind": kind,
        "order": "feeds -> params -> grads -> loss",
        "culprit": culprit,
        "blast_radius": sum(1 for c in checks if c["nonfinite"] > 0),
        "trip_stats_sampled": trip_sampled,
        "checks": checks,
    }


# ---------------------------------------------------------------------------
# drift sentinels
# ---------------------------------------------------------------------------

class DriftSentinel:
    """Shadow-eval one kernel against its plain executor.

    ``pair_fn()`` returns ``(candidate, reference)`` arrays computed on
    the pair's shapes; ``check()`` prices the disagreement:

      rel_err          max |cand - ref| / (max |ref| + eps)
      argmax_flip_frac fraction of rows (last axis) whose argmax
                       differs AND whose reference top-2 margin exceeds
                       ``argmax_margin`` — benign tie noise cannot flap
                       the gauge
      nonfinite        non-finite entries in the candidate

    A check is ``flagged`` when rel_err > rel_err_tol, any margin-aware
    argmax flips, or any non-finite output. Gauges land as
    ``numerics.drift.<name>.{rel_err, accuracy, argmax_flip_frac}``
    with check/alert counters; ``accuracy = 1/(1+rel_err)`` sits at
    ~1.0 and only moves on real drift.
    """

    def __init__(self, name: str, pair_fn: Callable[[], Tuple], *,
                 registry: Optional[MetricsRegistry] = None,
                 rel_err_tol: float = 1e-2,
                 argmax_axis: Optional[int] = None,
                 argmax_margin: float = 1e-4):
        self.name = name
        self.pair_fn = pair_fn
        self.registry = registry
        self.rel_err_tol = float(rel_err_tol)
        self.argmax_axis = argmax_axis
        self.argmax_margin = float(argmax_margin)
        self.last_result: Optional[Dict] = None

    def check(self) -> Dict:
        t0 = time.perf_counter()
        cand, ref = self.pair_fn()
        cand = np.asarray(cand, np.float64)
        ref = np.asarray(ref, np.float64)
        denom = float(np.max(np.abs(ref))) + _EPS
        diff = float(np.max(np.abs(cand - ref)))
        rel_err = diff / denom
        nonfinite = int(cand.size - np.count_nonzero(np.isfinite(cand)))
        flips = None
        if self.argmax_axis is not None and cand.ndim >= 1 \
                and cand.shape[self.argmax_axis] >= 2:
            ai_c = np.argmax(cand, axis=self.argmax_axis)
            ai_r = np.argmax(ref, axis=self.argmax_axis)
            srt = np.sort(ref, axis=self.argmax_axis)
            margin = (np.take(srt, -1, axis=self.argmax_axis)
                      - np.take(srt, -2, axis=self.argmax_axis))
            flips = float(np.mean((ai_c != ai_r)
                                  & (margin > self.argmax_margin)))
        flagged = bool((not np.isfinite(rel_err))
                       or rel_err > self.rel_err_tol
                       or (flips or 0.0) > 0.0
                       or nonfinite > 0)
        result = {
            "name": self.name,
            "rel_err": rel_err,
            "accuracy": 1.0 / (1.0 + rel_err),
            "argmax_flip_frac": flips,
            "nonfinite": nonfinite,
            "rel_err_tol": self.rel_err_tol,
            "flagged": flagged,
            "check_ms": round((time.perf_counter() - t0) * 1e3, 3),
        }
        self.last_result = result
        if self.registry is not None and _state.enabled:
            base = f"numerics.drift.{self.name}"
            self.registry.gauge(f"{base}.rel_err").set(rel_err)
            self.registry.gauge(f"{base}.accuracy").set(result["accuracy"])
            if flips is not None:
                self.registry.gauge(f"{base}.argmax_flip_frac").set(flips)
            self.registry.counter(f"{base}.checks").inc()
            if flagged:
                self.registry.counter(f"{base}.alerts").inc()
        trace.record_span(f"numerics.drift.{self.name}", t0,
                          time.perf_counter(),
                          rel_err=float(f"{rel_err:.3e}"),
                          flagged=flagged)
        return result


def lstm_drift_inputs(T: int = 6, B: int = 8, E: int = 16, H: int = 32,
                      P: int = 16, seed: int = 0):
    """The LSTM pair's numpy inputs (x, w, b, w_proj, g_out), drawn as
    the JAX package's pair draws them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, B, E)) * 0.2).astype(np.float32)
    w = (rng.standard_normal((E + P, 4 * H)) * 0.2).astype(np.float32)
    b = np.zeros((4 * H,), np.float32)
    wp = (rng.standard_normal((H, P)) * 0.2).astype(np.float32)
    g_out = rng.standard_normal((T, B, P)).astype(np.float32)
    return x, w, b, wp, g_out


def lstm_drift_pair(T: int = 6, B: int = 8, E: int = 16, H: int = 32,
                    P: int = 16, seed: int = 0, perturb: float = 0.0,
                    device="cuda") -> Callable[[], Tuple]:
    """The LSTM backward against its plain executor, compared on the
    weight gradient of ``sum(y * g_out)``: candidate B2 forward + B3
    backward (``lstm_scan(impl="kernel", bwd_impl="kernel")``),
    reference B2 forward + the plain backward (``bwd_impl="scan"``), as
    the JAX pair runs the Pallas forward under both backwards. At the
    pair's fp32 shape B2 takes the persistent fp32 forward
    (``csrc/lstm_f32_sm90.cu``) and B3 the first kernel
    (``csrc/lstm.cu``). ``perturb`` scales the candidate by ``1 +
    perturb`` — an injected drift that tests the sentinel itself."""

    def pair_fn():
        from parallax_tpu_torch.ops import lstm
        dev = torch.device(device)
        x, w, b, wp, g_out = lstm_drift_inputs(T, B, E, H, P, seed)
        X, Bt, WP, G = (torch.as_tensor(a, device=dev)
                        for a in (x, b, wp, g_out))

        def grad(bwd_impl):
            w_ = torch.tensor(w, device=dev, requires_grad=True)
            with torch.enable_grad():
                y = lstm.lstm_scan(X, w_, Bt, WP, impl="kernel",
                                   bwd_impl=bwd_impl)
                (gw,) = torch.autograd.grad((y * G).sum(), [w_])
            return gw.detach().cpu().numpy()

        cand = grad("kernel")
        ref = grad("scan")
        if perturb:
            cand = cand * (1.0 + perturb)
        return cand, ref

    return pair_fn


# the JAX pair's paged-attention case: S slots, G queries a slot, H
# heads, page size, pages a slot, pool pages; slot 3 has no live page
PAGED_PAIR = dict(S=4, G=3, H=2, page_size=4, P=4, pool=12)
# head dims: the JAX pair's 16 (D 32) on the CPU; B7 takes 64 and 128,
# so on the card the pair runs at the smallest, 64 (D 128)
PAGED_PAIR_HEAD_DIM = {"cpu": 16, "cuda": 64}


def paged_drift_inputs(seed: int = 0, head_dim: int = 16):
    """The paged pair's numpy inputs (q, k_pool, v_pool, pages, pos),
    drawn as the JAX package's pair draws them, and the count of slots
    with live pages. Pools are ``[pool, page_size, D]``; page id
    ``pool`` is the sentinel."""
    c = PAGED_PAIR
    S, G, ps, P, pool = c["S"], c["G"], c["page_size"], c["P"], c["pool"]
    D = c["H"] * head_dim
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, G, D)).astype(np.float32) * 0.3
    k_pool = rng.standard_normal((pool, ps, D)).astype(np.float32) * 0.3
    v_pool = rng.standard_normal((pool, ps, D)).astype(np.float32) * 0.3
    pages = np.full((S, P), pool, np.int32)
    pages[0, :4] = [0, 1, 2, 3]
    pages[1, :2] = [4, 5]
    pages[2, :1] = [6]
    pos = np.array([[13, 14, 15], [5, 6, 7], [1, 2, 3], [0, 1, 2]],
                   np.int32)
    return q, k_pool, v_pool, pages, pos, 3


def paged_attn_drift_pair(seed: int = 0, perturb: float = 0.0,
                          device="cuda", head_dim: Optional[int] = None
                          ) -> Callable[[], Tuple]:
    """The paged decode (B7 on the card) against the plain gather on
    decode outputs. Only slots with live pages are compared (a slot
    with none is defined zeros in both, a non-signal). The port's pools
    carry one spare page at index ``pool`` (ops/paged_attention.py),
    zero here."""
    dev = torch.device(device)
    hd = head_dim if head_dim is not None else PAGED_PAIR_HEAD_DIM.get(
        dev.type, 64)

    def pair_fn():
        from parallax_tpu_torch.ops import paged_attention as pa
        q, k_pool, v_pool, pages, pos, live = paged_drift_inputs(seed, hd)
        spare = np.zeros((1,) + k_pool.shape[1:], np.float32)
        args = [torch.as_tensor(a, device=dev) for a in (
            q, np.concatenate([k_pool, spare]),
            np.concatenate([v_pool, spare]), pages, pos)]
        kw = dict(num_heads=PAGED_PAIR["H"],
                  page_size=PAGED_PAIR["page_size"],
                  pool_pages=PAGED_PAIR["pool"])
        cand = pa.paged_decode_attention(*args, **kw)
        ref = pa.paged_decode_attention_plain(*args, **kw)
        cand = cand.detach().cpu().numpy()[:live]
        ref = ref.detach().cpu().numpy()[:live]
        if perturb:
            cand = cand * (1.0 + perturb)
        return cand, ref

    return pair_fn


def default_sentinels(registry: Optional[MetricsRegistry] = None,
                      perturb: float = 0.0,
                      device="cuda") -> List[DriftSentinel]:
    """The two built-in kernel A/Bs (names and tolerances are the JAX
    package's: the gauge keys)."""
    return [
        DriftSentinel("lstm_bwd", lstm_drift_pair(perturb=perturb,
                                                  device=device),
                      registry=registry, rel_err_tol=1e-3),
        DriftSentinel("paged_attn", paged_attn_drift_pair(perturb=perturb,
                                                          device=device),
                      registry=registry, rel_err_tol=1e-2,
                      argmax_axis=-1),
    ]
