"""Measured per-op / per-collective attribution from ``torch.profiler``
traces (``parallax_tpu/obs/xprof.py``, which reads ``jax.profiler``
captures; this one reads the Chrome trace Kineto writes).

Two halves:

* a **pure parser** over trace-event JSON: pick the device tracks (the
  ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events of a trace with
  CUDA activity; the ``cpu_op`` events of a CPU-only one, flagged in
  ``track_basis``), compute per-op *self* durations (nested events are
  resolved by interval containment, so nothing counts twice), merge
  overlapping intervals for the busy-time union, and bucket every op
  into compute / collective (all-reduce, all-gather, reduce-scatter,
  all-to-all, collective-permute) / copy / infeed / outfeed. The
  unattributed **residual**, device wall time inside the window where no
  tracked op ran, is always reported: ``coverage`` is the fraction the
  per-op account explains.
* **a scope join** in place of the JAX package's HLO metadata: the
  engine runs its parts under ``torch.profiler.record_function`` scopes
  named after their source files (``embedding.py``, ``sampled_softmax.py``
  and ``sparse_optim.py`` are the sparse path; the model's file, ``lstm.py``,
  ``engine.py``, ``optim.py`` dense), and :func:`build_scope_index` maps
  each kernel (or, on the CPU, each op) name of one eagerly run step to
  the scope it ran under: through the launch's correlation id to the
  host thread, the innermost enclosing scope there, and for the backward
  the forward op its ``fwdbwd`` flow names. A name seen under more than
  one scope, or under none, stays unmapped; ``layers`` and
  ``dense_sparse`` report its time as ``(unmapped)`` /
  ``unmapped_self_ms`` and never guess. The forward/backward split needs
  an op-name scope path the port does not record, so ``fwd_bwd`` is all
  unmapped.

Kinds the two tracks cannot tell apart: NCCL runs both an all-to-all
and a ring's permute as send/receive kernels (``SendRecv``), so both
count as ``collective-permute``.

The capture side is ``profiler.ProfileHook`` (``session.profile_steps``);
the session exports the parsed result as lazy ``profile.*`` gauges and a
Chrome-lane summary. Everything here is host-side JSON work.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

# the attribution taxonomy, in presentation order
CATEGORIES = ("compute", "collective", "copy", "infeed", "outfeed")

# source files whose ops are the sparse (row-sharded table) path — the
# paper's dense-vs-sparse variable split, measured per op
SPARSE_SOURCES = ("embedding.py", "sparse_optim.py",
                  "sampled_softmax.py")

# the Kineto event categories that are device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# collective kinds by a substring of the (lowercased, underscore-free)
# NCCL kernel or c10d/gloo op name, in match order
_COLLECTIVE_NAMES = (("allreduce", "all-reduce"),
                     ("allgather", "all-gather"),
                     ("reducescatter", "reduce-scatter"),
                     ("alltoall", "collective-permute"),
                     ("sendrecv", "collective-permute"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"),
                     ("broadcast", "collective-broadcast"))


def categorize(name: str) -> Tuple[str, Optional[str]]:
    """``(category, collective_kind)`` of one event name: a kernel or
    transfer of the CUDA track (``ncclDevKernel_AllReduce_Sum_f32_RING_LL``,
    ``Memcpy HtoD (Pageable -> Device)``), or an op of the CPU track
    (``aten::mm``, ``c10d::allreduce_``). NCCL kernels and c10d/gloo ops
    are collectives, a host-to-device copy is infeed, a device-to-host
    copy outfeed, the other copies and memsets copy; everything else is
    compute."""
    low = name.lower()
    if "nccl" in low or low.startswith(("c10d::", "gloo:")):
        flat = low.replace("_", "")
        for key, kind in _COLLECTIVE_NAMES:
            if key in flat:
                return "collective", kind
        return "collective", "other-collective"
    if low.startswith("memcpy"):
        if "htod" in low:
            return "infeed", None
        if "dtoh" in low:
            return "outfeed", None
        return "copy", None
    if low.startswith("memset") or low.startswith(
            ("aten::copy_", "aten::_to_copy", "aten::clone")):
        return "copy", None
    return "compute", None


def merge_intervals(intervals: Sequence[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """Union of half-open ``(start, end)`` intervals, sorted and
    overlap-merged — the busy-time primitive (a track running two
    overlapping ops is busy once, not twice)."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e < s:
            s, e = e, s
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _self_durations(events: List[dict]) -> List[float]:
    """Per-event self duration on ONE track: ``dur`` minus the direct
    children's ``dur`` (children = events fully contained by interval
    on the same track — an op event enclosing the ops it calls must not
    double-count them)."""
    order = sorted(range(len(events)),
                   key=lambda i: (events[i]["ts"], -events[i]["dur"]))
    child_sum = [0.0] * len(events)
    stack: List[int] = []
    for i in order:
        s = events[i]["ts"]
        e = s + events[i]["dur"]
        while stack and (events[stack[-1]]["ts"]
                         + events[stack[-1]]["dur"]) <= s:
            stack.pop()
        if stack:
            child_sum[stack[-1]] += events[i]["dur"]
        stack.append(i)
    return [max(0.0, ev["dur"] - c)
            for ev, c in zip(events, child_sum)]


def _envelope_wall(merged: List[Tuple[float, float]],
                   steps: Optional[int]) -> float:
    """The measured device step wall (µs) from the globally merged
    busy intervals: split at the ``steps - 1`` largest gaps (the
    inter-step host time) and sum the resulting per-step envelopes.
    Unknown ``steps`` (or a single island) keeps the raw span —
    conservative: coverage can only be under-reported, never
    inflated."""
    if not merged:
        return 0.0
    span = merged[-1][1] - merged[0][0]
    if not steps or steps < 2 or len(merged) < 2:
        return span
    gaps = sorted(
        ((merged[i + 1][0] - merged[i][1], i)
         for i in range(len(merged) - 1)), reverse=True)
    cut_after = {i for _, i in gaps[:steps - 1]}
    wall = 0.0
    start = merged[0][0]
    for i, (_s, e) in enumerate(merged):
        if i in cut_after or i == len(merged) - 1:
            wall += e - start
            if i + 1 < len(merged):
                start = merged[i + 1][0]
    return wall


def _complete(e: dict) -> bool:
    return e.get("ph") == "X" and e.get("dur", 0) > 0


def device_op_events(trace: Dict) -> Tuple[List[dict], str]:
    """The device-track events to attribute, and the basis used:
    ``"device"`` (the CUDA track's kernels, copies and memsets) or
    ``"cpu_op"`` (a trace with no device events: the host's ops)."""
    events = trace.get("traceEvents", [])
    ops = [e for e in events
           if _complete(e) and e.get("cat") in DEVICE_CATS]
    if ops:
        return ops, "device"
    return [e for e in events
            if _complete(e) and e.get("cat") == "cpu_op"], "cpu_op"


def kernel_counts(trace: Dict) -> Dict[str, int]:
    """{name: events} of the CUDA track's kernels."""
    out: Dict[str, int] = {}
    for e in trace.get("traceEvents", []):
        if _complete(e) and e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


@dataclasses.dataclass
class Attribution:
    """One capture window's parsed account. All times are
    milliseconds. ``wall_ms`` is the measured DEVICE step wall: the
    sum of per-step envelopes (op intervals clustered at the
    ``steps - 1`` largest inter-execution gaps when ``steps`` is
    known). ``attributed_ms`` is the overlap-merged union of op
    intervals, ``residual_ms = wall - attributed`` the device-wall time
    no tracked op explains — reported, never hidden; ``coverage`` their
    ratio. ``window_span_ms`` keeps the raw first-to-last span and
    ``inter_step_ms`` the excluded between-envelope host time.
    ``by_module`` groups the device track's self time by CUDA stream
    (the JAX package's groups it by executable).
    Category/op/layer totals are *self*-duration sums (device-seconds,
    so concurrent devices add), with ``share`` normalized over the
    self-time total."""

    steps: Optional[int]
    events: int
    tracks: int
    track_basis: str
    wall_ms: float
    window_span_ms: float
    inter_step_ms: float
    attributed_ms: float
    residual_ms: float
    coverage: Optional[float]
    by_category: Dict[str, Dict[str, Any]]
    collectives: Dict[str, Dict[str, Any]]
    top_ops: List[Dict[str, Any]]
    layers: Dict[str, float]
    dense_sparse: Dict[str, float]
    by_module: Dict[str, float]
    source: Optional[str] = None
    # forward-vs-backward self-time split: needs an op-name scope path
    # in the index (JAX's transpose(...) scopes); all unmapped without
    fwd_bwd: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def step_wall_ms(self) -> Optional[float]:
        if not self.steps or self.wall_ms <= 0:
            return None
        return self.wall_ms / self.steps

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["step_wall_ms"] = (round(self.step_wall_ms, 4)
                             if self.step_wall_ms else None)
        return d


def attribute(trace: Dict, steps: Optional[int] = None,
              scope_index: Optional[Dict[str, Dict]] = None,
              top: int = 20,
              source: Optional[str] = None) -> Attribution:
    """Parse one trace-event document into an :class:`Attribution`.

    Pure: ``trace`` is the loaded JSON, ``scope_index`` (optional) a
    :func:`build_scope_index` for the layer / dense-sparse mapping,
    ``steps`` the number of training steps the window covered (per-step
    numbers divide by it)."""
    ops, basis = device_op_events(trace)
    if not ops:
        return Attribution(
            steps=steps, events=0, tracks=0, track_basis=basis,
            wall_ms=0.0, window_span_ms=0.0, inter_step_ms=0.0,
            attributed_ms=0.0, residual_ms=0.0,
            coverage=None, by_category={}, collectives={}, top_ops=[],
            layers={}, dense_sparse={}, by_module={}, source=source)

    # per-track self durations (nesting resolved per thread / stream)
    by_track: Dict[Tuple, List[dict]] = {}
    for e in ops:
        by_track.setdefault((e.get("pid"), e.get("tid")),
                            []).append(e)
    self_us: Dict[int, float] = {}
    for tes in by_track.values():
        for e, s in zip(tes, _self_durations(tes)):
            self_us[id(e)] = s

    # busy union + per-step envelope wall across every device track
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in ops]
    merged = merge_intervals(intervals)
    busy_us = sum(e - s for s, e in merged)
    span_us = merged[-1][1] - merged[0][0]
    wall_us = _envelope_wall(merged, steps)

    cat_tot: Dict[str, float] = {}
    cat_n: Dict[str, int] = {}
    coll_tot: Dict[str, float] = {}
    coll_n: Dict[str, int] = {}
    op_tot: Dict[str, float] = {}
    op_n: Dict[str, int] = {}
    op_cat: Dict[str, str] = {}
    layer_tot: Dict[str, float] = {}
    split_tot = {"sparse_self_ms": 0.0, "dense_self_ms": 0.0,
                 "unmapped_self_ms": 0.0}
    dir_tot = {"forward_self_ms": 0.0, "backward_self_ms": 0.0,
               "unmapped_self_ms": 0.0}
    mod_tot: Dict[str, float] = {}
    for e in ops:
        s_ms = self_us[id(e)] / 1e3
        name = e.get("name", "?")
        cat, kind = categorize(name)
        cat_tot[cat] = cat_tot.get(cat, 0.0) + s_ms
        cat_n[cat] = cat_n.get(cat, 0) + 1
        if kind is not None:
            coll_tot[kind] = coll_tot.get(kind, 0.0) + s_ms
            coll_n[kind] = coll_n.get(kind, 0) + 1
        op_tot[name] = op_tot.get(name, 0.0) + s_ms
        op_n[name] = op_n.get(name, 0) + 1
        op_cat[name] = cat
        # by CUDA stream where the JAX package groups by executable
        stream = (e.get("args") or {}).get("stream")
        if stream is not None:
            mod = f"stream {stream}"
            mod_tot[mod] = mod_tot.get(mod, 0.0) + s_ms
        meta = (scope_index or {}).get(name)
        layer = layer_of(meta) if meta else None
        layer_tot[layer or "(unmapped)"] = \
            layer_tot.get(layer or "(unmapped)", 0.0) + s_ms
        split = sparse_split(meta) if meta else None
        key = {"sparse": "sparse_self_ms",
               "dense": "dense_self_ms"}.get(split,
                                             "unmapped_self_ms")
        split_tot[key] += s_ms
        direction = direction_of(meta) if meta else None
        dkey = {"forward": "forward_self_ms",
                "backward": "backward_self_ms"}.get(
                    direction, "unmapped_self_ms")
        dir_tot[dkey] += s_ms

    total_self = sum(cat_tot.values()) or 1.0
    by_category = {
        cat: {"self_ms": round(cat_tot.get(cat, 0.0), 4),
              "share": round(cat_tot.get(cat, 0.0) / total_self, 4),
              "events": cat_n.get(cat, 0)}
        for cat in CATEGORIES if cat in cat_tot}
    collectives = {
        kind: {"self_ms": round(v, 4), "events": coll_n[kind]}
        for kind, v in sorted(coll_tot.items(),
                              key=lambda kv: -kv[1])}
    top_ops = []
    for name, v in sorted(op_tot.items(),
                          key=lambda kv: -kv[1])[:int(top)]:
        meta = (scope_index or {}).get(name)
        top_ops.append({
            "op": name, "category": op_cat[name],
            "self_ms": round(v, 4), "count": op_n[name],
            "layer": layer_of(meta) if meta else None,
            "split": sparse_split(meta) if meta else None,
        })
    return Attribution(
        steps=steps, events=len(ops), tracks=len(by_track),
        track_basis=basis,
        wall_ms=round(wall_us / 1e3, 4),
        window_span_ms=round(span_us / 1e3, 4),
        inter_step_ms=round(max(0.0, span_us - wall_us) / 1e3, 4),
        attributed_ms=round(busy_us / 1e3, 4),
        residual_ms=round(max(0.0, wall_us - busy_us) / 1e3, 4),
        coverage=(round(busy_us / wall_us, 4) if wall_us > 0
                  else None),
        by_category=by_category, collectives=collectives,
        top_ops=top_ops,
        layers={k: round(v, 4)
                for k, v in sorted(layer_tot.items(),
                                   key=lambda kv: -kv[1])[:top]},
        dense_sparse={k: round(v, 4) for k, v in split_tot.items()},
        by_module={k: round(v, 4) for k, v in mod_tot.items()},
        source=source,
        fwd_bwd={k: round(v, 4) for k, v in dir_tot.items()})


# -- the scope join ------------------------------------------------------------


def _parents(events: List[dict]) -> Dict[int, Optional[dict]]:
    """{id(event): the innermost event of the same track containing it}
    (None for a top-level one)."""
    order = sorted(events, key=lambda e: (e["ts"], -e.get("dur", 0)))
    parent: Dict[int, Optional[dict]] = {}
    stack: List[dict] = []
    for e in order:
        while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) \
                <= e["ts"]:
            stack.pop()
        parent[id(e)] = stack[-1] if stack else None
        stack.append(e)
    return parent


def build_scope_index(trace: Dict) -> Dict[str, Dict[str, Any]]:
    """{kernel or op name: {"opcode": name, "source_file": scope}} from a
    trace of eagerly run steps whose parts ran under
    ``record_function`` scopes (``user_annotation`` events). A device
    event's scope is its launch's (the host event of the same
    ``correlation``); a host event's is the innermost scope around it on
    its thread, or, inside a backward node, the scope of the forward op
    its ``fwdbwd`` flow starts from. Names met under more than one scope,
    or under none, are left out: unmapped, never guessed."""
    events = trace.get("traceEvents", [])
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") not in DEVICE_CATS
            and e.get("cat") != "gpu_user_annotation"]
    by_track: Dict[Tuple, List[dict]] = {}
    for e in host:
        by_track.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    parent: Dict[int, Optional[dict]] = {}
    at: Dict[Tuple, dict] = {}
    for track, evs in by_track.items():
        parent.update(_parents(evs))
        for e in evs:
            # the outermost event at a timestamp: flows point at it or
            # at an event it contains, which resolves alike
            key = track + (e["ts"],)
            if key not in at or e.get("dur", 0) > at[key].get("dur", 0):
                at[key] = e
    flows: Dict[Any, Dict[str, Tuple]] = {}
    for e in events:
        if e.get("cat") == "fwdbwd" and e.get("ph") in ("s", "f"):
            flows.setdefault(e.get("id"), {})[e["ph"]] = (
                e.get("pid"), e.get("tid"), e.get("ts"))
    # backward node -> the forward op its flow starts from
    forward_of: Dict[int, dict] = {}
    for ends in flows.values():
        if "s" in ends and "f" in ends:
            src, dst = at.get(ends["s"]), at.get(ends["f"])
            if src is not None and dst is not None:
                forward_of[id(dst)] = src

    memo: Dict[int, Optional[str]] = {}

    def scope(e: Optional[dict], depth: int = 0) -> Optional[str]:
        if e is None or depth > 64:
            return None
        if id(e) in memo:
            return memo[id(e)]
        if e.get("cat") == "user_annotation":
            out = e["name"]
        elif id(e) in forward_of:
            out = scope(forward_of[id(e)], depth + 1)
        else:
            out = scope(parent.get(id(e)), depth + 1)
        memo[id(e)] = out
        return out

    launches = {(e.get("args") or {}).get("correlation"): e
                for e in host if e.get("cat") in ("cuda_runtime",
                                                  "cuda_driver")
                and (e.get("args") or {}).get("correlation") is not None}
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    seen: Dict[str, set] = {}
    if device:
        for e in device:
            corr = (e.get("args") or {}).get("correlation")
            seen.setdefault(e["name"], set()).add(
                scope(launches.get(corr)))
    else:
        for e in host:
            if e.get("cat") == "cpu_op":
                seen.setdefault(e["name"], set()).add(scope(e))
    return {name: {"opcode": name, "source_file": next(iter(scopes))}
            for name, scopes in seen.items()
            if len(scopes) == 1 and None not in scopes}


def layer_of(meta: Optional[Dict[str, Any]]) -> Optional[str]:
    """A readable layer label from one index entry: the ``op_name``
    scope path's component before the primitive, else the source file's
    basename (the port's scopes are source files)."""
    if not meta:
        return None
    op_name = meta.get("op_name") or ""
    parts = [p for p in op_name.split("/")
             if p and not p.startswith("jit(")
             and not p.startswith("transpose(")]
    if len(parts) > 1:
        return "/".join(parts[:-1])
    src = meta.get("source_file")
    if src:
        return os.path.basename(src)
    return parts[0] if parts else None


def direction_of(meta: Optional[Dict[str, Any]]) -> Optional[str]:
    """``"backward"`` when the entry's ``op_name`` scope path carries a
    ``transpose(...)`` component, ``"forward"`` for any other op_name,
    None when there is no op_name (every port index entry)."""
    if not meta:
        return None
    op_name = meta.get("op_name") or ""
    if not op_name:
        return None
    if any(p.startswith("transpose(") for p in op_name.split("/")):
        return "backward"
    return "forward"


def sparse_split(meta: Optional[Dict[str, Any]],
                 sparse_sources: Sequence[str] = SPARSE_SOURCES
                 ) -> Optional[str]:
    """``"sparse"`` when the op's source file is on the row-sharded
    table path, ``"dense"`` for any other known source, None when the
    entry carries no source."""
    if not meta:
        return None
    src = meta.get("source_file")
    if not src:
        return None
    base = os.path.basename(src)
    return "sparse" if base in tuple(sparse_sources) else "dense"


# -- trace loading -----------------------------------------------------------

def find_trace_file(outdir: str) -> Optional[str]:
    """Newest ``*.trace.json(.gz)`` under ``outdir`` (the layout the
    profile hook writes: ``plugins/profile/<ts>/<host>.pt.trace.json.gz``,
    as ``jax.profiler`` lays out its captures)."""
    paths = (glob.glob(os.path.join(outdir, "**", "*.trace.json.gz"),
                       recursive=True)
             + glob.glob(os.path.join(outdir, "**", "*.trace.json"),
                         recursive=True))
    if not paths:
        return None
    return max(paths, key=os.path.getmtime)


def load_trace(path_or_dir: str) -> Tuple[Dict, str]:
    """(trace JSON, file path) from a trace file or a capture dir.
    Raises FileNotFoundError when no trace exists there."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        found = find_trace_file(path_or_dir)
        if found is None:
            raise FileNotFoundError(
                f"no *.trace.json(.gz) under {path_or_dir!r}")
        path = found
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f), path


__all__ = [
    "Attribution", "CATEGORIES", "SPARSE_SOURCES", "attribute",
    "build_scope_index", "categorize", "device_op_events",
    "direction_of", "find_trace_file",
    "kernel_counts", "layer_of", "load_trace", "merge_intervals",
    "sparse_split",
]
