"""Analytic step-time model over (mesh shape, run option) plans
(``parallax_tpu/tune/costmodel.py``).

Pure: every function here but ``inputs_from_engine`` maps plain numbers
to plain numbers, so a candidate plan is priced before anything is
captured, from one probe engine's counts:

* the step's FLOPs and bytes (``Engine.step_cost_analysis``: its
  matmuls and the input and output bytes of its ops, counted on meta
  tensors);
* the dense-vs-sparse wire split from the engine's plan
  (``ShardingPlan.var_specs``) and the lookup records of
  ``ops/embedding.py``;
* the hand kernels' own byte models (``ops/lstm.py`` and
  ``ops/paged_attention.py`` ``kernel_hbm_bytes``, through their trace
  records);
* ``common.flops.device_peak_flops`` for the card's compute ceiling.

The prediction is a three-term roofline:

    step ~= max(compute, HBM) + interconnect

Compute and HBM overlap on the card (the binding ceiling wins);
collective traffic is serialized against them, except under
``sync=False`` plans, where the delayed-gradient exchange overlaps the
next step's compute and only the excess bills.

Wire terms per plan (N = dp * tp ranks; a ring all-reduce moves
``2 * bytes * (k-1)/k``, a one-way gather or scatter ``bytes *
(k-1)/k``):

* dense (non-table) gradients all-reduce over the whole mesh in every
  run option;
* ``SHARD`` also pays the all-gather of its row-sharded dense
  parameters, for the forward and the backward;
* tables: ``AR`` rings the whole dense [V, D] gradient; ``SHARD`` and
  ``HYBRID`` ship the sparse exchange, the probe's recorded bytes
  rescaled to the candidate's shard width, plus the cross-replica
  combine rescaled to its replica count (estimated from the dense
  shard-gradient ring when the probe had one replica row).

The default constants are the H100 SXM's published rates (NVIDIA's data
sheet): 989.4 TF/s bf16 dense, 3.35 TB/s of HBM3, 900 GB/s of NVLink 4
(``TuneConfig.ici_gbps`` keeps the JAX package's name for the link).
Absolute seconds are only as good as those constants: off the card they
rank plans, they are not times, and a calibration file
(tune/calibrate.py) replaces them with measured exchange rates.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from parallax_tpu_torch.common import consts
from parallax_tpu_torch.common.config import normalize_run_option
from parallax_tpu_torch.common.flops import H100_SXM_PEAK_BF16

# the constants a card the model knows no better about is priced with:
# the H100 SXM's data sheet. They set how many wire bytes cost as much as
# a FLOP; the plan ranking rests mostly on the byte terms, which are exact
NOMINAL_PEAK_FLOPS = H100_SXM_PEAK_BF16   # bf16 dense, FLOP/s
NOMINAL_HBM_BPS = 3.35e12                 # HBM3, bytes/s
NOMINAL_ICI_BPS = 900e9                   # NVLink 4 to the other cards


@dataclasses.dataclass(frozen=True)
class Plan:
    """One candidate configuration: mesh shape + run options.

    ``dp`` is the ``'repl'`` axis size (data-parallel replica rows),
    ``tp`` the ``'shard'`` axis size (the row-shard width, the
    reference's embedding partition count), ``pp`` the ``'pipe'`` axis
    size (pipeline stages; 1 is the two-axis mesh). ``virtual_stages`` /
    ``microbatches`` are the schedule knobs a ``pp > 1`` plan carries
    (copied from the model's ``pipeline_info``); both stay at their
    neutral defaults at ``pp = 1``. ``sync`` / ``local_aggregation``
    ride along from the session config, so the cache key, the cost
    breakdown and the decision record name the whole configuration.
    """

    dp: int
    tp: int
    run_option: str = consts.RUN_HYBRID
    sync: bool = True
    local_aggregation: bool = True
    pp: int = 1
    virtual_stages: int = 1
    microbatches: int = 0

    def __post_init__(self):
        if int(self.dp) < 1 or int(self.tp) < 1 or int(self.pp) < 1:
            raise ValueError(
                f"plan mesh axes must be >= 1, got dp={self.dp} "
                f"tp={self.tp} pp={self.pp}")
        if int(self.virtual_stages) < 1 or int(self.microbatches) < 0:
            raise ValueError(
                f"virtual_stages must be >= 1 and microbatches >= 0, "
                f"got virtual_stages={self.virtual_stages} "
                f"microbatches={self.microbatches}")
        if int(self.pp) == 1 and (int(self.virtual_stages) != 1
                                  or int(self.microbatches) != 0):
            raise ValueError(
                "pipeline knobs (virtual_stages/microbatches) require "
                "pp > 1")
        object.__setattr__(self, "dp", int(self.dp))
        object.__setattr__(self, "tp", int(self.tp))
        object.__setattr__(self, "pp", int(self.pp))
        object.__setattr__(self, "virtual_stages",
                           int(self.virtual_stages))
        object.__setattr__(self, "microbatches", int(self.microbatches))
        object.__setattr__(self, "run_option",
                           normalize_run_option(self.run_option))
        object.__setattr__(self, "sync", bool(self.sync))
        object.__setattr__(self, "local_aggregation",
                           bool(self.local_aggregation))

    @property
    def num_devices(self) -> int:
        return self.dp * self.tp * self.pp

    def mesh_shape(self) -> Tuple[int, ...]:
        """The ``build_mesh(shape=...)`` tuple: ``(dp, tp)`` at pp 1,
        ``(dp, tp, pp)`` otherwise."""
        if self.pp == 1:
            return (self.dp, self.tp)
        return (self.dp, self.tp, self.pp)

    def validate_for(self, num_devices: int) -> "Plan":
        """Refuse a plan whose dp*tp*pp does not tile the ranks."""
        if self.num_devices != int(num_devices):
            raise ValueError(
                f"plan {self.describe()} covers {self.num_devices} "
                f"devices but the mesh has {num_devices}; dp*tp*pp "
                f"must equal the device count")
        return self

    def cache_key(self) -> Tuple:
        """The engine-cache key prefix: every field that changes the
        built step, so two plans of one device count but another mesh
        shape or run option never share an engine."""
        return (self.dp, self.tp, self.run_option, self.sync,
                self.local_aggregation, self.pp, self.virtual_stages,
                self.microbatches)

    def describe(self) -> str:
        tags = [] if self.sync else ["async"]
        if not self.local_aggregation:
            tags.append("noagg")
        if self.pp > 1:
            if self.virtual_stages > 1:
                tags.append(f"v{self.virtual_stages}")
            if self.microbatches:
                tags.append(f"m{self.microbatches}")
            return (f"dp{self.dp}xtp{self.tp}xpp{self.pp}"
                    f"/{self.run_option}"
                    + ("".join("+" + t for t in tags)))
        return (f"dp{self.dp}xtp{self.tp}/{self.run_option}"
                + ("".join("+" + t for t in tags)))


@dataclasses.dataclass
class CostInputs:
    """What one probe engine yields; the same inputs price every
    candidate plan (the terms are rescaled analytically).

    Byte counts are per step and mesh-global. ``probe_dp`` /
    ``probe_tp`` name the mesh the sparse terms were recorded on.
    """

    flops: float = 0.0            # per-step global FLOPs
    hbm_bytes: float = 0.0        # per-step bytes accessed (all devices)
    dense_grad_bytes: int = 0     # non-table gradient bytes per step
    table_grad_bytes: int = 0     # tables' dense [V, D] gradient bytes
    sparse_fwd_bytes: int = 0     # sparse shard-exchange bytes at probe
    sparse_repl_bytes: int = 0    # cross-replica combine bytes at probe
    # the LSTM kernels' device-memory traffic (ops/lstm.kernel_hbm_bytes
    # through its trace records): the step's byte count skips the ops a
    # kernel's plain version runs in its place, so without these the
    # recurrence would score as free. ``lstm_stream_bytes`` is
    # mesh-global and scales with the global batch;
    # ``lstm_resident_bytes`` is the weights' fetch every device pays
    # once a call. Both fold into the HBM term.
    lstm_stream_bytes: float = 0.0
    lstm_resident_bytes: float = 0.0
    # the paged-decode kernel's traffic (ops/paged_attention.
    # kernel_hbm_bytes through its trace records, kernel route only),
    # priced at the page table's full width: occupancy is known only at
    # run time, and an upper bound keeps the roofline conservative
    attn_stream_bytes: float = 0.0
    probe_dp: int = 1
    probe_tp: int = 1
    num_devices: int = 1
    peak_flops: Optional[float] = None    # per device; None -> nominal
    hbm_bps: Optional[float] = None
    ici_bps: Optional[float] = None
    peak_is_nominal: bool = True  # False iff a real card peak resolved
    # per-term predicted/measured ratios of a calibration file
    # (tune/calibrate.py): {"on_chip": r, "wire": r}. Each predicted term
    # is divided by its ratio.
    calibration: Optional[Dict[str, float]] = None
    # the pipeline capability record, present iff the probed model
    # declared ``Model.pipeline_info``: ``schedule`` ('gpipe'|'1f1b'),
    # ``microbatches``, ``virtual_stages``, ``pinned_stages``,
    # ``num_layers``, ``act_bytes`` (global-batch activation bytes at one
    # stage boundary), ``global_batch``, and optionally ``layer_costs``.
    # pp > 1 plans are enumerated and priced only with it.
    pipeline: Optional[Dict[str, Any]] = None

    def resolved(self) -> "CostInputs":
        out = dataclasses.replace(self)
        if not out.peak_flops:
            out.peak_flops = NOMINAL_PEAK_FLOPS
            out.peak_is_nominal = True
        if not out.hbm_bps:
            out.hbm_bps = NOMINAL_HBM_BPS
        if not out.ici_bps:
            out.ici_bps = NOMINAL_ICI_BPS
        return out


@dataclasses.dataclass
class PlanCost:
    """Predicted step time for one plan, with the per-term breakdown
    that explains the decision (flight recorder, ``tune_summary``)."""

    plan: Plan
    total_s: float
    terms: Dict[str, float]
    # the per-term ratios that were applied, or None for a prediction
    # from the nominal constants
    calibration: Optional[Dict[str, float]] = None
    # pp > 1 plans only: the bubble fraction, the rounded microbatch
    # count and the balanced stage cut behind the score
    pipeline: Optional[Dict[str, Any]] = None

    def as_dict(self) -> Dict[str, Any]:
        out = {
            "plan": self.plan.describe(),
            "dp": self.plan.dp, "tp": self.plan.tp,
            "pp": self.plan.pp,
            "run_option": self.plan.run_option,
            "predicted_ms": round(self.total_s * 1e3, 6),
            "terms_ms": {k: round(v * 1e3, 6)
                         for k, v in self.terms.items()},
            "calibration": self.calibration,
        }
        if self.pipeline is not None:
            out["pipeline"] = self.pipeline
        return out


def ring_allreduce_bytes(payload_bytes: float, k: int) -> float:
    """Bytes a k-way ring all-reduce of ``payload_bytes`` moves
    (reduce-scatter + all-gather: about 2 x (k-1)/k)."""
    if k <= 1:
        return 0.0
    return 2.0 * payload_bytes * (k - 1) / k


def gather_bytes(payload_bytes: float, k: int) -> float:
    """One-way k-way all-gather / reduce-scatter wire bytes."""
    if k <= 1:
        return 0.0
    return float(payload_bytes) * (k - 1) / k


def _shard_fraction(k: int) -> float:
    """(k-1)/k: the share of a gathered payload that crosses the wire
    (each rank holds its own shard already)."""
    return 0.0 if k <= 1 else (k - 1) / k


def lookup_wire_bytes(table_shape: Sequence[int], n_ids: int,
                      n_cnt: int, repl_bytes: int,
                      elem_bytes: int) -> int:
    """Per-step wire bytes of one sharded lookup: the forward's id
    all-gather (4-byte ids, as the reference counts them) and row
    reduce-scatter, the backward's row-gradient all-gather in the
    table's dtype, the optional occurrence-count plane, and the recorded
    cross-replica combine bytes. The one source of
    ``Engine.sparse_wire_bytes_per_step`` and the BASELINE metric
    "sparse-grad bytes on wire"."""
    dim = int(np.prod(table_shape[1:])) if len(table_shape) > 1 else 1
    return int(n_ids * 4 + 2 * n_ids * dim * elem_bytes + n_cnt * 4
               + repl_bytes)


def dense_alternative_bytes(table_shape: Sequence[int],
                            elem_bytes: int) -> int:
    """Wire bytes of ring-all-reducing one table's whole [V, D] gradient
    (about 2 bytes moved per gradient byte)."""
    return int(2 * int(np.prod(table_shape)) * elem_bytes)


def wire_summary(wire: Dict[str, Any],
                 table_elem_bytes: int = 4) -> Dict[str, Any]:
    """Ratios of an ``Engine.sparse_wire_bytes_per_step()`` account. The
    fp32 reference rescales the dense alternative to 4-byte elements
    (the reference ships fp32 dense gradients whatever the table's
    dtype)."""
    sparse = int(wire.get("sparse_path_bytes") or 0)
    dense = int(wire.get("dense_allreduce_bytes") or 0)
    dense_fp32_ref = dense * 4 // int(table_elem_bytes)
    return {
        "sparse_over_dense": (sparse / dense) if dense else None,
        "dense_fp32_reference_bytes": dense_fp32_ref,
        "sparse_over_dense_fp32_ref": ((sparse / dense_fp32_ref)
                                       if dense_fp32_ref else None),
    }


def pipeline_bubble(microbatches: int, stages: int,
                    virtual_stages: int = 1) -> Dict[str, float]:
    """Bubble accounting of ``ops/pipeline.py``'s schedules. The
    interleaved schedule rounds M up to whole rounds of S
    (``ops.pipeline._rounded_microbatches``), and the padding runs masked
    bubble entries, so the rounded M is priced. Ticks = V*M_sched + S - 1,
    ideal = V*M:

        bubble_fraction = (S - 1) / (V*M_sched + S - 1)
        on_chip_scale   = (V*M_sched + S - 1) / (V*M)"""
    from parallax_tpu_torch.ops.pipeline import _rounded_microbatches
    M, S, V = int(microbatches), int(stages), int(virtual_stages)
    if M < 1 or S < 1 or V < 1:
        raise ValueError(
            f"pipeline_bubble needs M, S, V >= 1; got M={M} S={S} "
            f"V={V}")
    m_sched = _rounded_microbatches(M, S, V)
    ticks = V * m_sched + S - 1
    return {
        "bubble_fraction": (S - 1) / ticks,
        "on_chip_scale": ticks / (V * M),
        "microbatches_scheduled": m_sched,
        "ticks": ticks,
    }


def pipeline_wire_bytes(act_bytes: float, microbatches: int,
                        stages: int, virtual_stages: int = 1,
                        schedule: str = "gpipe", dp: int = 1,
                        tp: int = 1) -> Dict[str, float]:
    """Inter-stage bytes. ``act_bytes`` is the global batch's activation
    at one stage boundary; one hop carries one microbatch of one repl
    row, ``per_hop_bytes = act_bytes / (M * dp)``. Every rank hops every
    tick (a masked tick sends zeros), so the mesh's activation bytes are
    ``per_hop * dp * tp * S * ticks``; under 1F1B the cotangents double
    them."""
    M = int(microbatches)
    bub = pipeline_bubble(M, stages, virtual_stages)
    per_hop = float(act_bytes) / (M * max(int(dp), 1))
    sends_per_tick = max(int(dp), 1) * max(int(tp), 1) * int(stages)
    activation = per_hop * sends_per_tick * bub["ticks"]
    cotangent = activation if str(schedule) == "1f1b" else 0.0
    return {
        "per_hop_bytes": per_hop,
        "ticks": bub["ticks"],
        "bubble_fraction": bub["bubble_fraction"],
        "microbatches_scheduled": bub["microbatches_scheduled"],
        "activation_bytes": activation,
        "cotangent_bytes": cotangent,
        "total_bytes": activation + cotangent,
    }


def balanced_stage_cut(layer_costs: Sequence[float],
                       stages: int) -> Tuple[list, list]:
    """Contiguous partition of per-layer costs into ``stages`` groups
    minimizing the largest group sum (the linear-partition DP). Returns
    ``(boundaries, stage_sums)``: ``boundaries`` has ``stages + 1``
    entries, ``boundaries[s]:boundaries[s+1]`` the layers of stage s.
    The imbalance ``stages * max(sums) / sum(sums)`` scales the on-chip
    term (a balanced cut scores 1)."""
    costs = [float(c) for c in layer_costs]
    L, S = len(costs), int(stages)
    if S < 1 or L < S:
        raise ValueError(
            f"balanced_stage_cut needs 1 <= stages <= num_layers; "
            f"got stages={S} over {L} layer(s)")
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    def span(i, j):
        return prefix[j] - prefix[i]

    # dp[s][j] = the least largest group sum splitting costs[:j] into s
    INF = float("inf")
    dp_tab = [[INF] * (L + 1) for _ in range(S + 1)]
    cut = [[0] * (L + 1) for _ in range(S + 1)]
    dp_tab[0][0] = 0.0
    for s in range(1, S + 1):
        for j in range(s, L + 1):
            for i in range(s - 1, j):
                cand = max(dp_tab[s - 1][i], span(i, j))
                if cand < dp_tab[s][j]:
                    dp_tab[s][j] = cand
                    cut[s][j] = i
    bounds = [L]
    j = L
    for s in range(S, 0, -1):
        j = cut[s][j]
        bounds.append(j)
    bounds.reverse()
    sums = [span(bounds[s], bounds[s + 1]) for s in range(S)]
    return bounds, sums


def predict(plan: Plan, inputs: CostInputs) -> PlanCost:
    """Score one plan. Pure; the module docstring has the model."""
    inp = inputs.resolved()
    n = plan.num_devices

    # a pp > 1 plan scales its on-chip terms by the bubble (rounded-M
    # ticks over the ideal work) times the stage-cut imbalance, and adds
    # an inter-stage wire term; pp = 1 plans take none of this
    on_scale = 1.0
    wire_pp = 0.0
    pp_record = None
    if plan.pp > 1:
        pl = inp.pipeline
        if not pl:
            raise ValueError(
                f"plan {plan.describe()} has pp>1 but "
                "CostInputs.pipeline is missing — only models that "
                "declare pipeline_info can be priced for pipeline "
                "plans")
        S = plan.pp
        V = max(int(plan.virtual_stages), 1)
        M = int(plan.microbatches
                or pl.get("microbatches") or 1)
        schedule = str(pl.get("schedule") or "gpipe")
        layer_costs = pl.get("layer_costs")
        if not layer_costs and pl.get("num_layers"):
            layer_costs = [1.0] * int(pl["num_layers"])
        cut, sums, imbalance = None, None, 1.0
        if layer_costs:
            cut, sums = balanced_stage_cut(layer_costs, S)
            total_c = sum(sums)
            imbalance = (S * max(sums) / total_c) if total_c else 1.0
        bub = pipeline_bubble(M, S, V)
        on_scale = bub["on_chip_scale"] * imbalance
        act_bytes = float(pl.get("act_bytes") or 0.0)
        if not act_bytes:
            # one stage boundary carries the global batch's
            # [tokens, model_dim] activation
            act_bytes = (float(pl.get("global_batch") or 0)
                         * float(pl.get("model_dim") or 0)
                         * float(pl.get("act_itemsize") or 4))
        wires = pipeline_wire_bytes(
            act_bytes, M, S, V,
            schedule=schedule, dp=plan.dp, tp=plan.tp)
        wire_pp = wires["total_bytes"]
        pp_record = {
            "pp": S, "virtual_stages": V, "microbatches": M,
            "microbatches_scheduled": bub["microbatches_scheduled"],
            "schedule": schedule,
            "bubble_fraction": round(bub["bubble_fraction"], 6),
            "imbalance": round(imbalance, 6),
            "stage_cut": cut,
            "stage_costs": ([round(v, 6) for v in sums]
                            if sums else None),
        }

    compute_s = float(inp.flops) / (n * inp.peak_flops) * on_scale
    # kernel-aware HBM term: stream bytes split across devices like the
    # step's own bytes; resident (weight-fetch) bytes are paid per
    # device, so their mesh-global total is resident * n
    lstm_bytes = (float(inp.lstm_stream_bytes)
                  + float(inp.lstm_resident_bytes) * n)
    attn_bytes = float(inp.attn_stream_bytes)
    hbm_s = (float(inp.hbm_bytes) + lstm_bytes + attn_bytes) \
        / (n * inp.hbm_bps) * on_scale

    # dense (non-table) gradients: a ring over the whole mesh in every
    # run option (the batch spans the mesh)
    wire_dense = ring_allreduce_bytes(inp.dense_grad_bytes, n)
    # SHARD's row-sharded dense parameters, all-gathered for the forward
    # and the backward
    wire_zero = 0.0
    if plan.run_option == consts.RUN_SHARD:
        wire_zero = 2.0 * gather_bytes(inp.dense_grad_bytes, plan.tp)

    # tables: the dense ring under AR, the sparse exchange otherwise
    if plan.run_option == consts.RUN_AR:
        wire_table = ring_allreduce_bytes(inp.table_grad_bytes, n)
    else:
        # the shard exchange rescaled from the probe's width; zero at
        # tp 1 (rows are local, the lookup is a plain gather)
        f_probe = _shard_fraction(inp.probe_tp)
        fwd = (inp.sparse_fwd_bytes * _shard_fraction(plan.tp) / f_probe
               if f_probe > 0 else
               # a probe that never sharded: the dense shard-gradient
               # ring over tp stands in, an upper bound
               ring_allreduce_bytes(inp.table_grad_bytes / max(plan.tp, 1),
                                    plan.tp))
        f_repl_probe = _shard_fraction(inp.probe_dp)
        if inp.sparse_repl_bytes and f_repl_probe > 0:
            repl = (inp.sparse_repl_bytes
                    * _shard_fraction(plan.dp) / f_repl_probe)
        else:
            # the probe had one replica row and recorded nothing: each
            # shard's dense [rows/tp, D] gradient rung over the dp rows
            repl = ring_allreduce_bytes(
                inp.table_grad_bytes / max(plan.tp, 1), plan.dp)
        wire_table = fwd + repl

    wire_bytes = wire_dense + wire_zero + wire_table + wire_pp
    # a calibration file's ratios: each term divided by its measured
    # predicted/measured ratio (compute and HBM share the on_chip ratio:
    # a trace cannot split what the card overlaps)
    cal = inp.calibration or {}
    r_on = float(cal.get("on_chip", 1.0)) or 1.0
    r_wire = float(cal.get("wire", 1.0)) or 1.0
    compute_s /= r_on
    hbm_s /= r_on
    wire_s = wire_bytes / (n * inp.ici_bps) / r_wire
    # sync=False: the delayed-gradient exchange overlaps the next step's
    # compute; only the excess serializes
    hidden_s = min(wire_s, compute_s) if not plan.sync else 0.0
    total = max(compute_s, hbm_s) + (wire_s - hidden_s)
    terms = {
        "compute_s": compute_s,
        "hbm_s": hbm_s,
        # informational (included in hbm_s): the LSTM kernels' share
        "hbm_lstm_kernel_s": lstm_bytes / (n * inp.hbm_bps) / r_on,
        # informational (included in hbm_s): the paged-decode kernel's
        "hbm_attn_kernel_s": attn_bytes / (n * inp.hbm_bps) / r_on,
        "wire_dense_s": wire_dense / (n * inp.ici_bps) / r_wire,
        "wire_zero_shard_s": wire_zero / (n * inp.ici_bps) / r_wire,
        "wire_table_s": wire_table / (n * inp.ici_bps) / r_wire,
        "wire_hidden_s": hidden_s,
    }
    if plan.pp > 1:
        # the inter-stage stream (additive, part of wire_s)
        terms["wire_pp_s"] = wire_pp / (n * inp.ici_bps) / r_wire
        # informational (included in compute_s/hbm_s): what the bubble
        # and the cut's imbalance added
        terms["pp_bubble_s"] = (max(compute_s, hbm_s)
                                * (1.0 - 1.0 / on_scale))
    return PlanCost(plan=plan, total_s=total, terms=terms,
                    calibration=(dict(cal) if cal else None),
                    pipeline=pp_record)


def inputs_from_engine(engine, tune_config=None,
                       calibration: Optional[Dict[str, float]] = None
                       ) -> CostInputs:
    """``CostInputs`` of one built engine, before any step runs: its
    step counted on meta tensors (``Engine.step_cost_analysis``), its
    plan, its lookup records and the kernels' trace records for its
    mesh. Duck-typed, so this module imports without the engine."""
    import torch

    from parallax_tpu_torch.common import flops as flops_lib
    from parallax_tpu_torch.ops import lstm, paged_attention

    costs = engine.step_cost_analysis() or {}
    flops = float(costs.get("flops") or 0.0)
    hbm = float(costs.get("bytes accessed") or 0.0)

    dense_b = 0
    table_b = 0
    for vs in engine.plan.var_specs.values():
        elem = (torch.empty((), dtype=vs.dtype).element_size()
                if isinstance(vs.dtype, torch.dtype) else 4)
        nbytes = int(np.prod(vs.shape)) * elem if vs.shape else elem
        if vs.is_sparse:
            table_b += nbytes
        else:
            dense_b += nbytes

    sparse_fwd = 0
    sparse_repl = 0
    for tshape, n_ids, n_cnt, repl_bytes, _sparse_repl, elem in \
            getattr(engine, "_lookup_records", ()):
        sparse_fwd += lookup_wire_bytes(tshape, n_ids, n_cnt, 0, elem)
        sparse_repl += int(repl_bytes)

    mesh = engine.mesh
    # the LSTM kernels' traffic: the records are per traced signature, so
    # a layer seen at several batch sizes (buckets, an eval) collapses to
    # its largest batch, the step the roofline prices
    lstm_stream = 0.0
    lstm_resident = 0.0
    by_layer: Dict[Tuple, dict] = {}
    for rec in lstm.trace_records(mesh):
        key = (rec["T"], rec["E"], rec["H"], rec["P"],
               rec["x_itemsize"], rec["w_itemsize"],
               rec["n_shards"], rec["bwd"])
        if key not in by_layer or rec["B"] > by_layer[key]["B"]:
            by_layer[key] = rec
    for rec in by_layer.values():
        acct = lstm.kernel_hbm_bytes(
            rec["T"], rec["B"], rec["E"], rec["H"], rec["P"],
            rec["x_itemsize"], rec["w_itemsize"], bwd=rec["bwd"])
        lstm_stream += acct["stream_bytes"]
        lstm_resident += acct["resident_bytes_per_device"]
    # the paged-decode kernel's traffic, kernel route only, at the page
    # table's full width
    attn_stream = 0.0
    for rec in paged_attention.trace_records(mesh):
        if rec["impl"] != "kernel":
            continue
        acct = paged_attention.kernel_hbm_bytes(
            rec["S"], rec["G"], rec["D"], rec["page_size"],
            rec["S"] * rec["P"], rec["itemsize"])
        attn_stream += acct["total_bytes"]
    # the pipeline capability: a model that declares pipeline_info makes
    # pp > 1 plans enumerable; the boundary activation comes from the
    # probe's batch, [B, T] of its widest feed, over the ranks the batch
    # is split over
    pipeline = None
    pinfo = getattr(getattr(engine, "model", None), "pipeline_info", None)
    if pinfo:
        pipeline = dict(pinfo)
        shapes = getattr(engine, "_batch_shapes", None)
        lead = None
        if isinstance(shapes, dict):
            for name in sorted(shapes):
                shp = tuple(getattr(shapes[name], "shape", ()))
                if shp and (lead is None or len(shp) > len(lead)):
                    lead = shp
        if lead:
            group = getattr(engine, "_batch_group", None)
            b = int(lead[0]) * (group.size if group is not None else 1)
            tokens = b * int(lead[1]) if len(lead) > 1 else b
            pipeline.setdefault("global_batch", b)
            dim = int(pipeline.get("model_dim") or 0)
            elem = int(pipeline.get("act_itemsize") or 4)
            pipeline.setdefault("act_bytes", tokens * dim * elem)
    dev = engine.device
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""
    peak = flops_lib.device_peak_flops(dev.type, kind)
    tc = tune_config
    return CostInputs(
        flops=flops, hbm_bytes=hbm,
        dense_grad_bytes=dense_b, table_grad_bytes=table_b,
        sparse_fwd_bytes=sparse_fwd, sparse_repl_bytes=sparse_repl,
        lstm_stream_bytes=lstm_stream,
        lstm_resident_bytes=lstm_resident,
        attn_stream_bytes=attn_stream,
        probe_dp=int(mesh.repl), probe_tp=int(mesh.shard),
        num_devices=int(mesh.size),
        peak_flops=(tc.peak_flops if tc and tc.peak_flops else peak),
        hbm_bps=(tc.hbm_gbps * 1e9 if tc and tc.hbm_gbps else None),
        ici_bps=(tc.ici_gbps * 1e9 if tc and tc.ici_gbps else None),
        peak_is_nominal=not bool((tc and tc.peak_flops) or peak),
        calibration=calibration,
        pipeline=pipeline)
