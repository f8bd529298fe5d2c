"""The port's tuner (``parallax_tpu_torch/tune/``, ``parallel/``) held to
the JAX package's on the same inputs.

* ``predict``: the same ``CostInputs`` and ``Plan``s through both cost
  models, every term, the total, the pipeline record and the applied
  calibration equal within 1e-12 relative (the constants are passed
  explicitly: the packages' nominal ones differ by design, the H100's
  against a TPU's).
* ``enumerate_plans`` / ``emittable_plans`` equal for n in {1, 2, 4, 8}
  with ``max_pp`` 1 and 2, and under tp bounds and run-option subsets.
* ``MeshSearch`` and ``PartitionSearch`` fed the same scripted timings
  take the same decisions and give the same ``summary()`` (but its wall
  seconds); the OOM preflight refuses the same plans under the same
  peaks and budget.
* Calibration files round-trip across the packages.
* ``inputs_from_engine`` on a small LM1B: the same dense, table, sparse
  and LSTM-kernel bytes as the JAX engine's. The FLOPs are held to the
  LM1B matmul formula within 1 %, the tolerance of ``step_flops``: the
  JAX count on XLA:CPU comes from ``cost_analysis``, which prices a
  while loop's body once (the scan recurrence, or the Pallas kernel run
  in interpret mode), so it falls below the formula and rises less than
  linearly with T.
* Config and plan validation, ``get_partitioner`` and the session's
  plan-keyed engine cache and flight record.

No assertion uses a measured CPU time.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as pt
from parallax_tpu.common import config as jconfig
from parallax_tpu.core import engine as jengine
from parallax_tpu.core import mesh as jmesh
from parallax_tpu.models import lm1b as jlm1b
from parallax_tpu.obs import memwatch as jmemwatch
from parallax_tpu.parallel import partitions as jpartitions
from parallax_tpu.tune import calibrate as jcal
from parallax_tpu.tune import costmodel as jcm
from parallax_tpu.tune import search as jsearch
from parallax_tpu_torch.common import config as tconfig
from parallax_tpu_torch.common import flops as tflops
from parallax_tpu_torch.models import lm1b as tlm1b
from parallax_tpu_torch.obs import memwatch as tmemwatch
from parallax_tpu_torch.parallel import partitions as tpartitions
from parallax_tpu_torch.tune import calibrate as tcal
from parallax_tpu_torch.tune import costmodel as tcm
from parallax_tpu_torch.tune import search as tsearch

REL = 1e-12


def _pipeline(**kw):
    rec = dict(schedule="gpipe", microbatches=4, virtual_stages=1,
               pinned_stages=None, num_layers=8, model_dim=32,
               act_itemsize=4, act_bytes=1_000_000, global_batch=32)
    rec.update(kw)
    return rec


INPUTS = {
    "base": dict(flops=8e9, hbm_bytes=4e9, dense_grad_bytes=1_000_000,
                 table_grad_bytes=64_000_000, sparse_fwd_bytes=2_000_000,
                 sparse_repl_bytes=0, probe_dp=1, probe_tp=8,
                 num_devices=8),
    "repl_probe": dict(flops=3e10, hbm_bytes=1e9,
                       dense_grad_bytes=37_800_000,
                       table_grad_bytes=812_000_000,
                       sparse_fwd_bytes=201_867_264,
                       sparse_repl_bytes=5_000_000, probe_dp=2,
                       probe_tp=4, num_devices=8),
    "tp1_probe": dict(flops=1e9, hbm_bytes=2e9, dense_grad_bytes=500_000,
                      table_grad_bytes=8_000_000, sparse_fwd_bytes=0,
                      probe_dp=8, probe_tp=1, num_devices=8),
    "kernels": dict(flops=5e9, hbm_bytes=3e8, dense_grad_bytes=2_000_000,
                    table_grad_bytes=16_000_000,
                    sparse_fwd_bytes=1_000_000, lstm_stream_bytes=7.5e8,
                    lstm_resident_bytes=5.2e6, attn_stream_bytes=3e7,
                    probe_dp=1, probe_tp=8, num_devices=8),
    "calibrated": dict(flops=8e9, hbm_bytes=4e9,
                       dense_grad_bytes=1_000_000,
                       table_grad_bytes=64_000_000,
                       sparse_fwd_bytes=2_000_000, probe_dp=1, probe_tp=8,
                       num_devices=8,
                       calibration={"on_chip": 0.37, "wire": 12.5}),
    "pipeline": dict(flops=8e9, hbm_bytes=4e9, dense_grad_bytes=1_000_000,
                     table_grad_bytes=64_000_000,
                     sparse_fwd_bytes=2_000_000, probe_dp=1, probe_tp=8,
                     num_devices=8, pipeline=_pipeline()),
    "pipeline_1f1b": dict(flops=8e9, hbm_bytes=4e9,
                          dense_grad_bytes=1_000_000,
                          table_grad_bytes=64_000_000, probe_dp=1,
                          probe_tp=8, num_devices=8,
                          pipeline=_pipeline(
                              schedule="1f1b", virtual_stages=2,
                              microbatches=6, act_bytes=0,
                              layer_costs=[1, 3, 1, 1, 2, 1, 1, 1])),
}
CONSTANTS = dict(peak_flops=1e12, hbm_bps=1e11, ici_bps=1e10,
                 peak_is_nominal=False)


def _inputs(pkg, name, **extra):
    kw = dict(INPUTS[name], **CONSTANTS)
    kw.update(extra)
    return pkg.CostInputs(**kw)


def _plan_kws(pipeline):
    """Every emittable plan on 8 devices (pp 2 blocks with a pipeline
    record), under sync, sync=False and local_aggregation=False."""
    plans = jsearch.emittable_plans(8, max_pp=2, pipeline=pipeline)
    out = []
    for p in plans:
        for sync, agg in ((True, True), (False, True), (True, False)):
            out.append(dict(dp=p.dp, tp=p.tp, run_option=p.run_option,
                            sync=sync, local_aggregation=agg, pp=p.pp,
                            virtual_stages=p.virtual_stages,
                            microbatches=p.microbatches))
    return out


def _close(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _close(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{what}/{i}")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=REL, abs=0.0), (what, a, b)
    else:
        assert a == b, (what, a, b)


@pytest.mark.parametrize("name", list(INPUTS))
def test_predict_equals_jax(name):
    """Every plan of the space, each term within 1e-12 relative."""
    pipeline = INPUTS[name].get("pipeline")
    for kw in _plan_kws(pipeline):
        if kw["pp"] > 1 and pipeline is None:
            continue
        got = tcm.predict(tcm.Plan(**kw), _inputs(tcm, name))
        want = jcm.predict(jcm.Plan(**kw), _inputs(jcm, name))
        assert got.plan.describe() == want.plan.describe()
        assert got.plan.cache_key() == want.plan.cache_key()
        _close(got.terms, want.terms, f"{name}:{got.plan.describe()}")
        _close(got.total_s, want.total_s, "total")
        assert got.calibration == want.calibration
        _close(got.pipeline, want.pipeline, "pipeline")
        _close(got.as_dict(), want.as_dict(), "as_dict")


def test_default_constants_are_the_h100_data_sheet():
    """With no constants the port prices with the H100 SXM's rates
    (the JAX package's are a TPU's, so the two differ by design)."""
    inp = tcm.CostInputs(flops=1e12, hbm_bytes=1e9).resolved()
    assert inp.peak_flops == tflops.H100_SXM_PEAK_BF16 == 989.4e12
    assert inp.hbm_bps == 3.35e12
    assert inp.ici_bps == 900e9
    assert inp.peak_is_nominal


@pytest.mark.parametrize("M,S,V", [(4, 2, 1), (8, 4, 1), (5, 2, 2),
                                   (6, 4, 2), (3, 3, 3), (7, 2, 4)])
def test_pipeline_math_equals_jax(M, S, V):
    assert tcm.pipeline_bubble(M, S, V) == jcm.pipeline_bubble(M, S, V)
    for sched in ("gpipe", "1f1b"):
        assert tcm.pipeline_wire_bytes(1e6, M, S, V, sched, 2, 2) == \
            jcm.pipeline_wire_bytes(1e6, M, S, V, sched, 2, 2)


@pytest.mark.parametrize("costs,stages", [([1, 1, 1, 1], 2),
                                          ([3, 1, 1, 1, 2, 2], 3),
                                          ([5, 1, 1, 1, 1, 1, 1, 1], 4),
                                          ([1.5, 2.5, 0.5], 1)])
def test_balanced_stage_cut_equals_jax(costs, stages):
    assert tcm.balanced_stage_cut(costs, stages) == \
        jcm.balanced_stage_cut(costs, stages)


def test_wire_formulas_equal_jax():
    for k in (1, 2, 3, 8):
        assert tcm.ring_allreduce_bytes(1e6, k) == \
            jcm.ring_allreduce_bytes(1e6, k)
        assert tcm.gather_bytes(1e6, k) == jcm.gather_bytes(1e6, k)
        assert tcm._shard_fraction(k) == jcm._shard_fraction(k)
    wire = {"sparse_path_bytes": 201_867_264,
            "dense_allreduce_bytes": 1_624_000_000}
    for eb in (2, 4):
        assert tcm.wire_summary(wire, eb) == jcm.wire_summary(wire, eb)
    assert tcm.wire_summary({}) == jcm.wire_summary({})


# -- enumeration -------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("max_pp", [1, 2])
def test_plan_enumeration_equals_jax(n, max_pp):
    pipeline = _pipeline(global_batch=32)
    for fn in ("enumerate_plans", "emittable_plans"):
        got = getattr(tsearch, fn)(n, max_pp=max_pp, pipeline=pipeline)
        want = getattr(jsearch, fn)(n, max_pp=max_pp, pipeline=pipeline)
        assert [p.cache_key() for p in got] == \
            [p.cache_key() for p in want], fn
        assert [p.describe() for p in got] == [p.describe() for p in want]


@pytest.mark.parametrize("kw", [
    dict(min_tp=2), dict(max_tp=4), dict(min_tp=2, max_tp=4),
    dict(run_options=("AR", "SHARD")), dict(run_options=("HYBRID",)),
    dict(run_options=("SHARD",), min_tp=4),
    dict(sync=False, local_aggregation=False),
])
def test_bounded_enumeration_equals_jax(kw):
    for fn in ("enumerate_plans", "emittable_plans"):
        got = getattr(tsearch, fn)(8, **kw)
        want = getattr(jsearch, fn)(8, **kw)
        assert [p.cache_key() for p in got] == \
            [p.cache_key() for p in want], (fn, kw)


# -- the searches --------------------------------------------------------------


def _script(plan_desc: str) -> float:
    """A scripted trial time for a plan: deterministic, unrelated to the
    model's order, so the measured argmin is not the predicted one."""
    return 0.010 + (sum(map(ord, plan_desc)) % 97) * 1e-4


def _drive(pkg, tc, base, inputs, peaks=None):
    ms = pkg.MeshSearch(8, tc, base)
    if peaks is not None:
        ms.set_preflight(peaks)
    plan = ms.begin(inputs)
    order = []
    while plan is not None:
        order.append(plan.describe())
        plan = ms.report(plan, _script(plan.describe()))
    s = ms.summary()
    s.pop("search_seconds")
    return order, ms.best_plan().describe(), s


SEARCHES = {
    "top3": dict(top_k=3),
    "top1": dict(top_k=1),
    "top12": dict(top_k=12),
    "shard_hybrid_min2": dict(top_k=4, run_options=("SHARD", "HYBRID"),
                              min_tp=2),
    "ar_shard_max4": dict(top_k=3, run_options=("AR", "SHARD"), max_tp=4),
    "pp2": dict(top_k=5, max_pp=2),
}


@pytest.mark.parametrize("name", list(SEARCHES))
def test_mesh_search_decisions_equal_jax(name):
    kw = SEARCHES[name]
    inp = "pipeline" if kw.get("max_pp", 1) > 1 else "repl_probe"
    got = _drive(tsearch, tconfig.TuneConfig(**kw), tcm.Plan(1, 8),
                 _inputs(tcm, inp))
    want = _drive(jsearch, jconfig.TuneConfig(**kw), jcm.Plan(1, 8),
                  _inputs(jcm, inp))
    assert got[0] == want[0]
    assert got[1] == want[1]
    _close(got[2], want[2], name)


def _peaks(plan) -> int:
    """Every sharded plan needs 10 GB but dp8 ones."""
    return 1000 if plan.tp == 1 else int(10e9) if plan.dp < 4 else 5000


@pytest.mark.parametrize("budget,headroom", [(1.0, 0.9), (20.0, 0.4),
                                             (20.0, 1.0)])
def test_preflight_refusals_equal_jax(budget, headroom):
    kw = dict(top_k=3, hbm_budget_gb=budget, hbm_headroom=headroom)
    got = _drive(tsearch, tconfig.TuneConfig(**kw), tcm.Plan(1, 8),
                 _inputs(tcm, "base"), _peaks)
    want = _drive(jsearch, jconfig.TuneConfig(**kw), jcm.Plan(1, 8),
                  _inputs(jcm, "base"), _peaks)
    assert got == want
    assert (got[2]["pruned_oom"] > 0) == (budget * headroom < 10)


def test_preflight_all_refused_raises_alike():
    for pkg, cfg in ((tsearch, tconfig), (jsearch, jconfig)):
        ms = pkg.MeshSearch(8, cfg.TuneConfig(top_k=2, hbm_budget_gb=1.0),
                            (tcm if pkg is tsearch else jcm).Plan(1, 8))
        ms.set_preflight(lambda plan: int(10e9))
        with pytest.raises(RuntimeError, match="exceeds the HBM"):
            ms.begin(_inputs(tcm if pkg is tsearch else jcm, "base"))


def test_preflight_without_budget_is_skipped_alike(monkeypatch):
    monkeypatch.setattr(tmemwatch, "card_memory_bytes", lambda: None)
    got = _drive(tsearch, tconfig.TuneConfig(top_k=2), tcm.Plan(1, 8),
                 _inputs(tcm, "base"), lambda p: int(10e9))
    want = _drive(jsearch, jconfig.TuneConfig(top_k=2), jcm.Plan(1, 8),
                  _inputs(jcm, "base"), lambda p: int(10e9))
    assert got == want
    assert got[2]["hbm_budget_bytes"] is None and got[2]["pruned_oom"] == 0


def test_hbm_budget_resolution():
    assert tmemwatch.hbm_budget_bytes(tconfig.TuneConfig(
        hbm_budget_gb=2.0)) == jmemwatch.hbm_budget_bytes(
        jconfig.TuneConfig(hbm_budget_gb=2.0)) == int(2e9)
    assert tmemwatch.hbm_budget_bytes(None, total_fn=lambda: 4096) == 4096
    assert tmemwatch.hbm_budget_bytes(None, total_fn=lambda: None) is None


@pytest.mark.parametrize("n,min_p,curve", [
    (8, 1, "bowl"), (8, 2, "bowl"), (8, 1, "falling"), (8, 1, "rising"),
    (12, 1, "bowl"), (6, 4, "falling"), (4, 1, "flat")])
def test_partition_search_decisions_equal_jax(n, min_p, curve):
    def t(p):
        return {"bowl": 1.0 / p + 0.04 * (p - 1) + 0.1,
                "falling": 1.0 / p + 0.2,
                "rising": 0.1 * p,
                "flat": 0.5}[curve]

    def drive(mod):
        ps = mod.PartitionSearch(min_p, n)
        p, seen = ps.first_candidate(), []
        while p is not None:
            seen.append(p)
            p = ps.report(p, t(p))
        return seen, ps.best_partitions(), ps.tried_partitions()

    assert drive(tpartitions) == drive(jpartitions)
    assert tpartitions.divisors(n) == jpartitions.divisors(n)


def test_get_partitioner_equals_jax(monkeypatch):
    monkeypatch.delenv("PARALLAX_PARTITIONS", raising=False)
    assert tpartitions.get_partitioner(3) == jpartitions.get_partitioner(3)
    assert tpartitions.get_partitioner() == 1     # one rank, no group
    monkeypatch.setenv("PARALLAX_PARTITIONS", "4")
    assert tpartitions.get_partitioner(2) == \
        jpartitions.get_partitioner(2) == 4
    assert pt.get_partitioner is tpartitions.get_partitioner


# -- calibration ---------------------------------------------------------------


TERMS_S = {"compute_s": 0.01, "hbm_s": 0.004, "wire_dense_s": 0.002,
           "wire_zero_shard_s": 0.0005, "wire_table_s": 0.003,
           "wire_pp_s": 0.001, "wire_hidden_s": 0.0015}
ATTRIB = {"steps": 3, "by_category": {
    "compute": {"self_ms": 24.0}, "copy": {"self_ms": 1.5},
    "infeed": {"self_ms": 0.5}, "collective": {"self_ms": 6.0}}}


def test_calibration_terms_equal_jax():
    assert tcal.predicted_terms_from_cost(TERMS_S) == \
        jcal.predicted_terms_from_cost(TERMS_S)
    for n in (1, 2, 8):
        assert tcal.measured_terms_from_attribution(ATTRIB, n) == \
            jcal.measured_terms_from_attribution(ATTRIB, n)
    assert tcal.measured_terms_from_attribution({}, 1) is None
    assert (tcal.FORMAT, tcal.VERSION, tcal.TERMS) == \
        (jcal.FORMAT, jcal.VERSION, jcal.TERMS)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_calibration_files_round_trip_across_packages(tmp_path, writer):
    w, r = (tcal, jcal) if writer == "port" else (jcal, tcal)
    pred = w.predicted_terms_from_cost(TERMS_S)
    meas = w.measured_terms_from_attribution(ATTRIB, 2)
    rec = w.build_record(pred, meas, basis="device-peak on NVIDIA H100",
                         meta={"plan": "dp1xtp2/HYBRID"})
    path = w.save(str(tmp_path / "cal.json"), rec)
    loaded = r.load(path)
    assert loaded is not None and loaded["basis"] == rec["basis"]
    assert r.ratios(loaded) == w.ratios(rec)
    assert set(r.ratios(loaded)) == {"on_chip", "wire"}
    # the loaded ratios price plans alike in both packages
    tin = _inputs(tcm, "base", calibration=tcal.ratios(loaded))
    jin = _inputs(jcm, "base", calibration=jcal.ratios(loaded))
    _close(tcm.predict(tcm.Plan(2, 4), tin).terms,
           jcm.predict(jcm.Plan(2, 4), jin).terms, "calibrated")


def test_calibration_refusals_equal_jax(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    foreign = tmp_path / "foreign.json"
    foreign.write_text(json.dumps({"format": "other", "terms": {}}))
    insane = tmp_path / "insane.json"
    insane.write_text(json.dumps(tcal.build_record(
        {"on_chip": 1e9, "wire": 1.0}, {"on_chip": 1e-9, "wire": 0.0})))
    for path in (None, str(tmp_path / "missing.json"), str(bad),
                 str(foreign), str(insane)):
        assert tcal.load(path) is None and jcal.load(path) is None


# -- validation ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(top_k=0), dict(run_options=("BOGUS",)), dict(run_options=()),
    dict(trial_steps=4, trial_warmup=4), dict(min_tp=4, max_tp=2),
    dict(min_tp=0), dict(peak_flops=-1.0), dict(hbm_gbps=0.0),
    dict(hbm_budget_gb=-2.0), dict(hbm_headroom=0.0),
    dict(hbm_headroom=1.5), dict(max_pp=0), dict(trial_warmup=-1)])
def test_tune_config_refusals_equal_jax(kw):
    with pytest.raises(ValueError):
        jconfig.TuneConfig(**kw)
    with pytest.raises(ValueError):
        tconfig.TuneConfig(**kw)


def test_tune_config_fields_and_normalisation_equal_jax():
    import dataclasses
    tnames = [f.name for f in dataclasses.fields(tconfig.TuneConfig)]
    jnames = [f.name for f in dataclasses.fields(jconfig.TuneConfig)]
    assert tnames == jnames
    t = tconfig.TuneConfig(run_options=("MPI", "PS", "MPI", "hybrid"))
    j = jconfig.TuneConfig(run_options=("MPI", "PS", "MPI", "hybrid"))
    assert t.run_options == j.run_options == ("AR", "SHARD", "HYBRID")
    assert [f.name for f in dataclasses.fields(tconfig.ProfileConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.ProfileConfig)]
    cfg = tconfig.ParallaxConfig()
    jcfg = jconfig.ParallaxConfig()
    for name in ("search_partitions", "tune_config", "calibration_path"):
        assert getattr(cfg, name) == getattr(jcfg, name)


def test_parallax_config_refuses_a_non_tune_config():
    with pytest.raises(ValueError, match="TuneConfig"):
        tconfig.ParallaxConfig(tune_config={"top_k": 2})
    with pytest.raises(ValueError, match="TuneConfig"):
        jconfig.ParallaxConfig(tune_config={"top_k": 2})


@pytest.mark.parametrize("kw", [dict(dp=0, tp=1), dict(dp=1, tp=1, pp=0),
                                dict(dp=1, tp=1, virtual_stages=2),
                                dict(dp=1, tp=1, microbatches=4),
                                dict(dp=1, tp=1, run_option="BOGUS"),
                                dict(dp=2, tp=1, pp=2,
                                     virtual_stages=0)])
def test_plan_refusals_equal_jax(kw):
    with pytest.raises(ValueError):
        jcm.Plan(**kw)
    with pytest.raises(ValueError):
        tcm.Plan(**kw)


def test_plan_surface_equals_jax():
    for kw in (dict(dp=2, tp=4), dict(dp=1, tp=2, pp=4, virtual_stages=2,
                                       microbatches=8),
               dict(dp=4, tp=2, run_option="PS", sync=False,
                    local_aggregation=False)):
        t, j = tcm.Plan(**kw), jcm.Plan(**kw)
        assert (t.describe(), t.cache_key(), t.mesh_shape(),
                t.num_devices) == (j.describe(), j.cache_key(),
                                   j.mesh_shape(), j.num_devices)
    with pytest.raises(ValueError, match="device count"):
        tcm.Plan(2, 2).validate_for(8)
    for pkg, cfg in ((tsearch, tconfig), (jsearch, jconfig)):
        with pytest.raises(ValueError, match="admits no plan"):
            pkg.MeshSearch(8, cfg.TuneConfig(run_options=("SHARD",),
                                             min_tp=3, max_tp=3),
                           (tcm if pkg is tsearch else jcm).Plan(1, 8))


# -- the probe's cost inputs ---------------------------------------------------


@pytest.mark.parametrize("mode", ["slices", "dense"])
def test_inputs_from_engine_equal_jax_on_small_lm1b(mode):
    import jax
    jcfg = jlm1b.tiny_config(compute_dtype=jnp.float32, lstm_impl="pallas",
                             sparse_grad_mode=mode)
    batch = jlm1b.make_batch(np.random.default_rng(0), 16, 6,
                             jcfg.vocab_size)
    eng = jengine.Engine(
        jlm1b.build_model(jcfg),
        jmesh.build_mesh(jax.devices()[:1], shape=(1, 1)),
        jparallax.Config(search_partitions=False, run_option="HYBRID",
                         sparse_grad_mode=mode), batch)
    want = jcm.inputs_from_engine(eng)
    tcfg = tlm1b.tiny_config(compute_dtype=torch.float32,
                             lstm_impl="kernel", sparse_grad_mode=mode)
    sess, *_ = pt.parallel_run(
        tlm1b.build_model(tcfg), parallax_config=pt.Config(
            run_option="HYBRID", sparse_grad_mode=mode), device="cpu")
    try:
        sess.prepare(batch)
        got = tcm.inputs_from_engine(sess.engine)
    finally:
        sess.close()
    for k in ("dense_grad_bytes", "table_grad_bytes", "sparse_fwd_bytes",
              "sparse_repl_bytes", "lstm_stream_bytes",
              "lstm_resident_bytes", "attn_stream_bytes", "probe_dp",
              "probe_tp", "num_devices", "peak_flops", "peak_is_nominal",
              "pipeline", "calibration"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.lstm_stream_bytes > 0
    formula = tflops.lm1b_matmul_flops_per_word(tcfg) * 16 * 6
    assert got.flops == pytest.approx(formula, rel=1e-2)
    assert want.flops < got.flops      # XLA:CPU prices a loop body once
    assert got.hbm_bytes > 0


def test_lstm_trace_records_follow_the_kernel_route():
    """Records come from ``impl="kernel"`` calls alone, with the backward
    that serves them; a meta pass standing for the card records the
    kernel backward (``_cuda.meta_for``); one record a signature."""
    from parallax_tpu_torch.ops import _cuda, lstm
    lstm.reset_trace_records()
    T, B, E, H, P = 3, 4, 8, 8, 4
    x = torch.randn(T, B, E, requires_grad=True)
    w = torch.randn(E + P, 4 * H, requires_grad=True)
    b = torch.zeros(4 * H, requires_grad=True)
    wp = torch.randn(H, P, requires_grad=True)
    lstm.lstm_scan(x, w, b, wp, impl="scan")
    assert lstm.trace_records() == []
    lstm.lstm_scan(x, w, b, wp, impl="kernel")
    lstm.lstm_scan(x, w, b, wp, impl="kernel")
    assert lstm.trace_records() == [dict(T=T, B=B, E=E, H=H, P=P,
                                         x_itemsize=4, w_itemsize=4,
                                         n_shards=1, bwd="scan")]
    meta = [t.detach().to("meta").requires_grad_() for t in (x, w, b, wp)]
    with _cuda.meta_for("cuda"):
        lstm.lstm_scan(*meta, impl="kernel")
    assert sorted(r["bwd"] for r in lstm.trace_records()) == \
        ["kernel", "scan"]
    lstm.reset_trace_records()
    assert lstm.trace_records() == []


def test_paged_trace_records_name_the_route():
    from parallax_tpu_torch.ops import _cuda, paged_attention as pa
    pa.reset_trace_records()
    S, G, D, ps, P, pool = 2, 1, 128, 16, 3, 8
    q = torch.randn(S, G, D)
    kp = torch.randn(pool + 1, ps, D)
    pages = torch.tensor([[0, 1, pool], [2, pool, pool]], dtype=torch.int32)
    pos = torch.tensor([[20], [5]], dtype=torch.int32)
    pa.paged_decode_attention(q, kp, kp, pages, pos, num_heads=2,
                              page_size=ps, pool_pages=pool)
    with _cuda.meta_for("cuda"):
        pa.paged_decode_attention(
            q.to("meta"), kp.to("meta"), kp.to("meta"), pages.to("meta"),
            pos.to("meta"), num_heads=2, page_size=ps, pool_pages=pool)
    recs = pa.trace_records()
    assert [r["impl"] for r in recs] == ["einsum", "kernel"]
    assert recs[1] == dict(S=S, G=G, D=D, num_heads=2, page_size=ps, P=P,
                           pool_pages=pool, itemsize=4, impl="kernel")
    pa.reset_trace_records()


# -- the session -----------------------------------------------------------------


def _emb_model(V=32, D=8):
    from parallax_tpu_torch.core import optim
    from parallax_tpu_torch.ops import embedding

    def init_fn(gen, device):
        return {"emb": torch.randn((V, D), generator=gen).to(device) * 0.1}

    def loss_fn(params, batch):
        rows = embedding.embedding_lookup(params["emb"], batch["ids"])
        return (rows ** 2).mean()

    return pt.Model(init_fn, loss_fn, optimizer=optim.sgd(0.1))


def test_same_count_different_plan_gets_distinct_engines():
    """Plans of one device count but another run option key apart; an
    exact re-request is a hit on the same engine."""
    sess, *_ = pt.parallel_run(_emb_model(), parallax_config=pt.Config(
        run_option="HYBRID", eager_fetch=True), device="cpu")
    try:
        feed = {"ids": np.arange(16, dtype=np.int32) % 32}
        float(sess.run("loss", feed_dict=feed))
        first = sess.engine
        assert sess.plan.describe() == "dp1xtp1/HYBRID"
        sess._build_engine(feed, tcm.Plan(1, 1, "AR"))
        assert sess.engine is not first
        assert sess.engine.config.run_option == "AR"
        assert sess.plan.describe() == "dp1xtp1/AR"
        hits = sess.compile_stats()["engine_cache"]["hits"]
        sess._build_engine(feed, tcm.Plan(1, 1, "HYBRID"))
        assert sess.engine is first
        assert sess.compile_stats()["engine_cache"]["hits"] == hits + 1
        # the state moved onto the AR plan and back, unchanged
        float(sess.run("loss", feed_dict=feed))
    finally:
        sess.close()


def test_flight_dump_carries_the_tune_record(tmp_path):
    sess, *_ = pt.parallel_run(_emb_model(), parallax_config=pt.Config(
        run_option="HYBRID", eager_fetch=True,
        flight_dir=str(tmp_path / "flight"),
        tune_config=pt.TuneConfig(top_k=1, trial_steps=2, trial_warmup=0,
                                  run_options=("HYBRID",))), device="cpu")
    try:
        feed = {"ids": np.arange(16, dtype=np.int32) % 32}
        for _ in range(4):
            float(sess.run("loss", feed_dict=feed))
        assert sess._search is None, "top_k=1 search should settle"
        s = sess.tune_summary()
        assert s["winner"]["plan"] == sess.plan.describe() == \
            "dp1xtp1/HYBRID"
        assert s["cost_basis"] == "nominal-constants (CPU-relative ranking)"
        doc = json.loads(open(sess.dump_flight(
            str(tmp_path / "dump.json"))).read())
        assert doc["tune"]["winner"]["plan"] == "dp1xtp1/HYBRID"
        assert doc["tune"]["trials"][0]["predicted_ms"] is not None
        assert doc["tune"]["trials"][0]["measured_ms"] is not None
        kinds = [e["kind"] for e in sess.journal.tail(64)
                 if e["subsystem"] == "tune"]
        assert kinds == ["decision"]
        # the settled search triggers the tune_decision artifact
        art = [p for p in sess.flight.dump_paths if "tune_decision" in p]
        assert len(art) == 1
        assert json.loads(open(art[0]).read())["detail"]["winner"][
            "plan"] == "dp1xtp1/HYBRID"
    finally:
        sess.close()


def test_one_card_search_trials_the_ar_canonical_and_keeps_state():
    """On one rank the space is one plan a pp block, AR's canonical
    tp 1: a HYBRID session replans onto it and trains on, its state
    moved whole (the losses equal an AR session's from the same seed)."""
    def run(cfg_kw):
        sess, *_ = pt.parallel_run(_emb_model(), parallax_config=pt.Config(
            eager_fetch=True, **cfg_kw), device="cpu")
        feed = {"ids": np.arange(16, dtype=np.int32) % 32}
        losses = [float(sess.run("loss", feed_dict=feed)) for _ in range(6)]
        out = (losses, sess.plan.describe(), sess.tune_summary())
        sess.close()
        return out

    tuned = run(dict(run_option="HYBRID", tune_config=pt.TuneConfig(
        trial_steps=3, trial_warmup=1)))
    plain = run(dict(run_option="AR"))
    assert tuned[1] == "dp1xtp1/AR" and tuned[2]["trials_measured"] == 1
    assert tuned[2]["candidates_enumerated"] == 3
    assert tuned[2]["pruned_equivalent"] == 2
    np.testing.assert_array_equal(tuned[0], plain[0])


def test_partition_search_env_drives_the_session(monkeypatch):
    monkeypatch.setenv("PARALLAX_MIN_PARTITIONS", "1")
    monkeypatch.delenv("PARALLAX_PARTITIONS", raising=False)
    sess, *_ = pt.parallel_run(_emb_model(), parallax_config=pt.Config(
        run_option="HYBRID", eager_fetch=True), device="cpu")
    try:
        assert isinstance(sess._search, tpartitions.PartitionSearch)
        feed = {"ids": np.arange(16, dtype=np.int32) % 32}
        float(sess.run("loss", feed_dict=feed))
        assert sess.plan.describe() == "dp1xtp1/HYBRID"
    finally:
        sess.close()


def test_partition_search_settles_in_the_session(monkeypatch):
    """``PARALLAX_MIN_PARTITIONS`` on one rank: the reference's 100-step
    window (the mean of steps [50, 100)) ends in a decision for the only
    width, and the session keeps its engine."""
    from parallax_tpu_torch.common import consts
    monkeypatch.setenv("PARALLAX_MIN_PARTITIONS", "1")
    monkeypatch.delenv("PARALLAX_PARTITIONS", raising=False)
    sess, *_ = pt.parallel_run(_emb_model(), parallax_config=pt.Config(
        run_option="HYBRID"), device="cpu")
    try:
        feed = {"ids": np.arange(16, dtype=np.int32) % 32}
        for _ in range(consts.NUM_ITERATIONS_FOR_TEST - 1):
            sess.run("loss", feed_dict=feed)
        assert isinstance(sess._search, tpartitions.PartitionSearch)
        engine = sess.engine
        sess.run("loss", feed_dict=feed)
        assert sess._search is None and sess.engine is engine
        assert sess.plan.describe() == "dp1xtp1/HYBRID"
        assert (consts.NUM_ITERATIONS_FOR_WARMUP,
                consts.NUM_ITERATIONS_FOR_TEST) == (50, 100)
    finally:
        sess.close()
