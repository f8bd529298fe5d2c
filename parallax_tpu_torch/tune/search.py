"""MeshSearch: enumerate -> cost-model prune -> top-k measured trials
(``parallax_tpu/tune/search.py``).

The successor of ``parallel/partitions.PartitionSearch`` (which measures
1-D partition counts on a fixed mesh): enumerate every valid
``(dp x tp)`` factorization of the rank count crossed with the run
options, collapse placement-equivalent plans, score the rest with the
cost model (tune/costmodel.py) from one probe engine's counts, and hand
only the ``top_k`` shortlist to measured trials. ``ParallaxSession``
drives the trials as it drives the partition search (N timed steps a
candidate, an in-place replan between candidates), and its engine cache
(compile/cache.py, keyed by the whole plan) makes settling on a measured
candidate a lookup.

Equivalence pruning (recorded, never silent): at ``tp == 1`` the shard
axis is trivial (row-sharded specs collapse to replicated and
``embedding_lookup`` takes the plain gather), so every ``tp == 1`` plan
is placement-identical to ``AR@(dp=N, tp=1)``; and ``AR`` ignores the
shard axis, so only its ``tp == 1`` shape is kept. What survives is the
set of configurations that build distinct steps.

The settled winner carries its predicted-over-measured ratio, and the
whole decision record lands in the flight recorder and
``tune_summary()``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from parallax_tpu_torch.common import consts
from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.tune import costmodel
from parallax_tpu_torch.tune.costmodel import CostInputs, Plan, PlanCost


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _pipeline_pp_values(num_devices: int, max_pp: Optional[int],
                        pipeline: Optional[Dict]) -> List[int]:
    """Admissible ``pp > 1`` values for the 3-D lattice.

    Empty without a model-declared ``pipeline`` capability record or
    with ``max_pp <= 1`` — the pp dimension exists only when the model
    can execute it. Constraints: ``pp`` divides the device count and
    ``num_layers % (pp * virtual_stages) == 0`` (the stage stacking is
    an even reshape); a layer storage order baked for ``V > 1``
    (``pinned_stages``) pins ``pp`` to that stage count."""
    if not pipeline or not max_pp or int(max_pp) <= 1:
        return []
    layers = int(pipeline.get("num_layers") or 0)
    virtual = max(int(pipeline.get("virtual_stages") or 1), 1)
    pinned = pipeline.get("pinned_stages")
    micro = int(pipeline.get("microbatches") or 0)
    if layers < 1 or micro < 1:
        return []
    out = []
    for pp in _divisors(int(num_devices)):
        if pp == 1 or pp > int(max_pp):
            continue
        if virtual > 1 and pinned and pp != int(pinned):
            continue
        if layers % (pp * virtual):
            continue
        out.append(pp)
    return out


def enumerate_plans(num_devices: int,
                    run_options: Optional[Sequence[str]] = None,
                    sync: bool = True,
                    local_aggregation: bool = True,
                    min_tp: int = 1,
                    max_tp: Optional[int] = None,
                    max_pp: Optional[int] = None,
                    pipeline: Optional[Dict] = None) -> List[Plan]:
    """The FULL ``(dp x tp x pp) x run_option`` space: one plan per
    divisor ``tp`` of ``num_devices // pp`` per run option per
    admissible ``pp``, bounded by ``[min_tp, max_tp]``. The ``pp = 1``
    block comes first and is byte-identical to the pre-PR-18 2-D list;
    ``pp > 1`` blocks exist only when a ``pipeline`` capability record
    is given and ``max_pp > 1`` (see :func:`_pipeline_pp_values`). No
    equivalence pruning — see :func:`emittable_plans` for the deduped
    list."""
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    opts = tuple(run_options) if run_options else (
        consts.RUN_AR, consts.RUN_SHARD, consts.RUN_HYBRID)
    hi = min(int(max_tp), num_devices) if max_tp else num_devices
    out = []
    pp_values = [1] + _pipeline_pp_values(num_devices, max_pp, pipeline)
    for pp in pp_values:
        if pp == 1:
            virtual, micro = 1, 0
        else:
            virtual = max(int(pipeline.get("virtual_stages") or 1), 1)
            micro = int(pipeline.get("microbatches") or 1)
        gb = int(pipeline.get("global_batch") or 0) if pipeline else 0
        for tp in _divisors(num_devices // pp):
            if tp < int(min_tp) or tp > hi:
                continue
            dp = num_devices // pp // tp
            if pp > 1 and gb and (gb % dp
                                  or (gb // dp) % max(micro, 1)):
                # the schedule needs the per-replica batch to split
                # into whole microbatches — an inadmissible (dp, M)
                # pairing can never execute, so it never enumerates
                continue
            for opt in opts:
                out.append(Plan(dp=dp, tp=tp, run_option=opt,
                                sync=sync,
                                local_aggregation=local_aggregation,
                                pp=pp, virtual_stages=virtual,
                                microbatches=micro))
    return out


def emittable_plans(num_devices: int,
                    run_options: Optional[Sequence[str]] = None,
                    sync: bool = True,
                    local_aggregation: bool = True,
                    min_tp: int = 1,
                    max_tp: Optional[int] = None,
                    max_pp: Optional[int] = None,
                    pipeline: Optional[Dict] = None) -> List[Plan]:
    """The deduped plan list — every configuration the tuner can
    actually emit (and the list the multichip dryrun proves).

    Collapsed equivalences, applied independently per ``pp`` block:
    every ``tp == 1`` plan (AR included) is the same all-replicated
    program at that ``pp``, so exactly one survives per block; AR
    ignores the shard axis, so only its canonical ``tp == 1`` shape is
    kept (it survives ``min_tp`` — there is no other shape AR compiles
    distinctly at). With ``pp`` forced to 1 (the default) the list is
    byte-identical to the pre-PR-18 space."""
    opts = tuple(run_options) if run_options else (
        consts.RUN_AR, consts.RUN_SHARD, consts.RUN_HYBRID)
    plans = enumerate_plans(num_devices, opts, sync, local_aggregation,
                            min_tp=1, max_tp=max_tp, max_pp=max_pp,
                            pipeline=pipeline)
    out = []
    seen_replicated = set()   # pp values whose tp=1 canonical is kept
    for p in plans:
        if p.tp == 1:
            if p.pp in seen_replicated or (consts.RUN_AR not in opts
                                           and int(min_tp) > 1):
                continue
            seen_replicated.add(p.pp)
            out.append(p)
            continue
        if p.run_option == consts.RUN_AR:
            continue  # AR is shard-axis-blind: tp=1 is canonical
        if p.tp < int(min_tp):
            continue
        out.append(p)
    return out


class MeshSearch:
    """Cost-model-shortlisted measured search over plans.

    Protocol (mirrors PartitionSearch, with Plans for candidates):

    1. the session builds its base-plan engine and calls
       :meth:`begin` with that engine's :class:`CostInputs`;
    2. ``begin`` scores the space, records the shortlist, and returns
       the first candidate plan;
    3. per measured trial the session calls :meth:`report(plan,
       mean_step_time)` -> the next candidate, or None when done;
    4. :meth:`best_plan` is the measured argmin; :meth:`summary` is
       the full decision record (bench/flight artifacts).
    """

    def __init__(self, num_devices: int, tune_config,
                 base_plan: Plan):
        self.num_devices = int(num_devices)
        self.cfg = tune_config
        self.base_plan = base_plan.validate_for(num_devices)
        self.trial_warmup = int(tune_config.trial_warmup)
        self.trial_steps = int(tune_config.trial_steps)
        if not emittable_plans(self.num_devices,
                               tune_config.run_options,
                               min_tp=tune_config.min_tp,
                               max_tp=tune_config.max_tp):
            # the tp bounds can only be judged against the device
            # count, which TuneConfig.__post_init__ cannot know —
            # refuse at construction (parallel_run time), not at the
            # session's first run()
            raise ValueError(
                f"tune_config admits no plan on {self.num_devices} "
                f"device(s): run_options="
                f"{tuple(tune_config.run_options or ('AR', 'SHARD', 'HYBRID'))}, "
                f"min_tp={tune_config.min_tp}, "
                f"max_tp={tune_config.max_tp} — the [min_tp, max_tp] "
                f"range must contain a divisor of the device count "
                f"(or include AR, whose canonical tp=1 plan always "
                f"qualifies)")
        self._inputs: Optional[CostInputs] = None
        self._scored: List[PlanCost] = []
        self._shortlist: List[Plan] = []
        self._pruned_equivalent = 0
        self._pruned_by_cost = 0
        self._enumerated = 0
        # -- OOM preflight (obs/memwatch.py) ---------------------------
        # fn(plan) -> the captured step's peak bytes (or None =
        # unknowable); set by the session before begin(). Plans whose
        # peak exceeds budget * headroom are REFUSED before any measured
        # trial — recorded like pruned_equivalent, never silent.
        self._preflight = None
        self._hbm_budget: Optional[int] = None
        self._oom_refusals: List[Dict] = []
        self._preflight_checked = 0
        self._measured: Dict[Tuple, float] = {}
        self._order: List[Plan] = []
        self._idx = 0
        self._best: Optional[Plan] = None
        self._t0: Optional[float] = None
        self._t_done: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------

    @property
    def started(self) -> bool:
        return self._inputs is not None

    @property
    def done(self) -> bool:
        return self._best is not None

    def set_preflight(self, fn) -> None:
        """Install the peak probe (``fn(plan) -> bytes or None``) the
        shortlist is screened through; call before :meth:`begin`."""
        self._preflight = fn

    def begin(self, inputs: CostInputs) -> Plan:
        """Score the space from one probe engine's counts; returns the
        first shortlisted candidate to measure."""
        self._t0 = time.perf_counter()
        self._inputs = inputs
        cfg = self.cfg
        opts = cfg.run_options or (consts.RUN_AR, consts.RUN_SHARD,
                                   consts.RUN_HYBRID)
        # the FULL space is enumerated with min_tp=1 so the emittable
        # list (which keeps AR's canonical tp=1 shape through a
        # min_tp bound) is always a subset of it and the pruned count
        # can never go negative or undercount; the double enumeration
        # is O(divisors x options) — trivially cheap
        # the pp dimension opens only when the probed model
        # declared pipeline capability AND the config allows pp > 1 —
        # otherwise both lists are exactly the 2-D space
        max_pp = getattr(cfg, "max_pp", 1)
        full = enumerate_plans(
            self.num_devices, opts, sync=self.base_plan.sync,
            local_aggregation=self.base_plan.local_aggregation,
            min_tp=1, max_tp=cfg.max_tp, max_pp=max_pp,
            pipeline=inputs.pipeline)
        self._enumerated = len(full)
        plans = emittable_plans(
            self.num_devices, opts, sync=self.base_plan.sync,
            local_aggregation=self.base_plan.local_aggregation,
            min_tp=cfg.min_tp, max_tp=cfg.max_tp, max_pp=max_pp,
            pipeline=inputs.pipeline)
        # equivalence-collapsed AND bound-pruned plans both count here;
        # non-empty is guaranteed by the constructor's bounds check
        self._pruned_equivalent = len(full) - len(plans)
        self._scored = sorted(
            (costmodel.predict(p, inputs) for p in plans),
            key=lambda pc: pc.total_s)
        k = min(int(cfg.top_k), len(self._scored))
        self._shortlist = self._preflight_shortlist(k)
        self._pruned_by_cost = (len(self._scored)
                                - len(self._shortlist)
                                - len(self._oom_refusals))
        self._order = list(self._shortlist)
        self._idx = 0
        parallax_log.info(
            "mesh search: %d plan(s) enumerated, %d equivalent + %d "
            "cost-pruned + %d OOM-refused; trialing top-%d: %s",
            self._enumerated, self._pruned_equivalent,
            self._pruned_by_cost, len(self._oom_refusals),
            len(self._shortlist),
            [p.describe() for p in self._shortlist])
        return self._order[0]

    def _preflight_shortlist(self, k: int) -> List[Plan]:
        """The first ``k`` plans of the scored order whose step peak
        fits in the HBM budget (obs/memwatch.py). Walks PAST refused
        plans so the shortlist is backfilled from the scored tail — a
        refused front-runner costs a worse candidate a trial, never the
        whole search. No preflight installed, or no budget resolvable
        (the CPU with no TuneConfig.hbm_budget_gb): the plain top-k,
        with the skip recorded in summary(). An unknowable peak (an
        engine that captures no graph) passes — refusal requires
        EVIDENCE."""
        from parallax_tpu_torch.obs import memwatch
        self._hbm_budget = memwatch.hbm_budget_bytes(self.cfg)
        if self._preflight is None or not self._hbm_budget:
            return [pc.plan for pc in self._scored[:k]]
        limit = int(self._hbm_budget * float(self.cfg.hbm_headroom))
        kept: List[Plan] = []
        for pc in self._scored:
            if len(kept) >= k:
                break
            self._preflight_checked += 1
            try:
                peak = self._preflight(pc.plan)
            except Exception as e:
                parallax_log.warning(
                    "OOM preflight failed for %s (%s); plan passes "
                    "unchecked", pc.plan.describe(), e)
                peak = None
            if peak is not None and int(peak) > limit:
                refusal = {
                    "plan": pc.plan.describe(),
                    "compiled_peak_bytes": int(peak),
                    "hbm_budget_bytes": int(self._hbm_budget),
                    "headroom_limit_bytes": limit,
                    "over_by_bytes": int(peak) - limit,
                }
                self._oom_refusals.append(refusal)
                parallax_log.warning(
                    "mesh search: plan %s REFUSED before trial — "
                    "compiled peak %.2f GB exceeds %.2f GB "
                    "(budget %.2f GB x headroom %.2f)",
                    pc.plan.describe(), peak / 1e9, limit / 1e9,
                    self._hbm_budget / 1e9,
                    float(self.cfg.hbm_headroom))
                continue
            kept.append(pc.plan)
        if not kept:
            raise RuntimeError(
                f"every candidate plan's compiled peak exceeds the "
                f"HBM budget ({self._hbm_budget / 1e9:.2f} GB x "
                f"headroom {float(self.cfg.hbm_headroom)}): "
                f"{self._oom_refusals[:4]} — shrink the model/batch "
                f"or raise TuneConfig.hbm_budget_gb/hbm_headroom")
        return kept

    def first_candidate(self) -> Plan:
        if not self.started:
            raise RuntimeError("MeshSearch.begin(inputs) must run first")
        return self._order[0]

    def report(self, plan: Plan, mean_step_time: float
               ) -> Optional[Plan]:
        """Record one measured trial; next candidate or None at end."""
        self._measured[plan.cache_key()] = float(mean_step_time)
        parallax_log.info("mesh search: %s mean step %.4fs",
                          plan.describe(), mean_step_time)
        self._idx += 1
        if self._idx < len(self._order):
            return self._order[self._idx]
        best_key = min(self._measured, key=self._measured.get)
        self._best = next(p for p in self._order
                          if p.cache_key() == best_key)
        self._t_done = time.perf_counter()
        return None

    def best_plan(self) -> Plan:
        if self._best is None:
            raise RuntimeError("mesh search not finished")
        return self._best

    def tried_plans(self) -> List[Plan]:
        return list(self._order[:self._idx])

    def predicted(self, plan: Plan) -> Optional[PlanCost]:
        for pc in self._scored:
            if pc.plan.cache_key() == plan.cache_key():
                return pc
        return None

    # -- the decision record ----------------------------------------------

    def summary(self) -> Dict:
        """JSON-ready record of the whole decision: candidates
        enumerated/pruned/trialed, per-trial predicted-vs-measured,
        the winner's ratio, and search wall seconds. The
        predicted-vs-measured ratios are honest to the rig they ran
        on: CPU-relative whenever the model's peak was nominal."""
        trials = []
        for p in self.tried_plans():
            pc = self.predicted(p)
            m = self._measured.get(p.cache_key())
            trials.append({
                "plan": p.describe(),
                "predicted_ms": (round(pc.total_s * 1e3, 6)
                                 if pc else None),
                "measured_ms": (round(m * 1e3, 6)
                                if m is not None else None),
                "terms_ms": (pc.as_dict()["terms_ms"] if pc else None),
            })
        winner = None
        if self._best is not None:
            pc = self.predicted(self._best)
            m = self._measured[self._best.cache_key()]
            winner = {
                "plan": self._best.describe(),
                "dp": self._best.dp, "tp": self._best.tp,
                "pp": self._best.pp,
                "run_option": self._best.run_option,
                "predicted_ms": (round(pc.total_s * 1e3, 6)
                                 if pc else None),
                "measured_ms": round(m * 1e3, 6),
                "predicted_over_measured": (
                    round(pc.total_s / m, 6) if pc and m else None),
                # None on a 2-D winner; a pp>1 winner carries its
                # priced bubble so the bench tune block can gate it
                "bubble_fraction": (
                    (pc.pipeline or {}).get("bubble_fraction")
                    if pc else None),
            }
        inp = self._inputs
        basis = ("nominal-constants (CPU-relative ranking)"
                 if inp is None or inp.peak_is_nominal
                 else "device-peak")
        if inp is not None and inp.calibration:
            basis = f"calibrated({basis})"
        return {
            "num_devices": self.num_devices,
            "candidates_enumerated": self._enumerated,
            "pruned_equivalent": self._pruned_equivalent,
            "pruned_by_cost_model": self._pruned_by_cost,
            # OOM preflight: refusals are part of the
            # decision record, exactly like pruned_equivalent — a
            # plan that never got its trial must say why
            "pruned_oom": len(self._oom_refusals),
            "oom_refusals": self._oom_refusals or None,
            "hbm_budget_bytes": self._hbm_budget,
            "hbm_headroom": float(self.cfg.hbm_headroom),
            "preflight_checked": self._preflight_checked,
            # the pp dimension's gate state: whether the
            # probed model could pipeline at all, and the cap — so a
            # record with no pp>1 candidates explains itself
            "max_pp": int(getattr(self.cfg, "max_pp", 1) or 1),
            "pipeline_capable": bool(inp is not None
                                     and inp.pipeline),
            "top_k": int(self.cfg.top_k),
            "trials": trials,
            "trials_measured": len(self._measured),
            "winner": winner,
            "search_seconds": (
                round(self._t_done - self._t0, 3)
                if self._t0 is not None and self._t_done is not None
                else None),
            "cost_basis": basis,
            "calibration": (dict(inp.calibration)
                            if inp is not None and inp.calibration
                            else None),
            "scored": [pc.as_dict() for pc in self._scored],
        }
