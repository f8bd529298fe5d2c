"""The mesh auto-tuner on four gloo ranks against the JAX package.

A tiny LM1B (HYBRID, sparse slices, fp32) is planned by the port's
``MeshSearch`` (``TuneConfig(run_options=("HYBRID",), min_tp=2)``: the
plans dp2xtp2 and dp1xtp4, both trialed) on four spawned ranks (the
bodies in ``torch_dist_ranks.py``, which imports no JAX). Each rank's
trial times are scripted, not measured: three of the four ranks would
pick the second plan alone, but the times averaged over the ranks favour
the first, so every rank must replan back to it together. Held here:

* every rank runs every step on the same plan, settles on the same
  winner and records the same decision;
* the decision equals the JAX ``MeshSearch``'s, fed the JAX engine's
  cost inputs and the same averaged times;
* the probe's cost inputs equal the JAX engine's on the same (1, 4)
  mesh: dense, table, sparse-exchange and LSTM-kernel bytes;
* the losses across both replans, and the parameters after them, equal
  those of JAX engines run over the same plan sequence (the state moved
  by the JAX session's own ``_reshard_state``) within 1e-4, as
  ``test_torch_dist.py`` holds LM1B.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import parallax_tpu as jparallax
from parallax_tpu.common import config as jconfig
from parallax_tpu.core import engine as jengine
from parallax_tpu.core import mesh as jmesh
from parallax_tpu.models import lm1b as jlm1b
from parallax_tpu.ops import sampled_softmax as jss
from parallax_tpu.session import ParallaxSession as JSession
from parallax_tpu.tune import costmodel as jcm
from parallax_tpu.tune import search as jsearch
from test_torch_dist import _close, _flat, _params_close, run_ranks

WORLD = 4
STEPS = 8
TUNE = dict(run_options=("HYBRID",), min_tp=2, top_k=2, trial_steps=3,
            trial_warmup=1)
CFG = dict(num_partitions=8, keep_prob=1.0, sparse_grad_mode="slices")
# per rank: three steps of the first trial, three of the second
FIRST = [1.0, 1.0, 1.0, 1.0]
SECOND = [0.5, 0.5, 0.5, 3.0]
SCRIPT = [[FIRST[r]] * 3 + [SECOND[r]] * 3 for r in range(WORLD)]


def _batches(vocab):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        b = jlm1b.make_batch(rng, 16, 6, vocab)
        b["w"] = rng.uniform(0.25, 1.75, b["w"].shape).astype(np.float32)
        out.append(b)
    return out


def _candidates(cfg):
    base = jax.random.PRNGKey(1)
    return [np.asarray(jss.log_uniform_candidates(
        jax.random.split(jax.random.fold_in(base, step))[1],
        cfg.num_samples, cfg.vocab_size)) for step in range(STEPS)]


def _jax_config():
    return jparallax.Config(search_partitions=False, run_option="HYBRID",
                            sparse_grad_mode="slices")


def _jax_engine(model, shape, batch):
    mesh = jmesh.build_mesh(jax.devices()[:WORLD], shape=shape)
    return jengine.Engine(model, mesh, _jax_config(), batch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = jlm1b.tiny_config(compute_dtype=jnp.float32, lstm_impl="pallas",
                             **CFG)
    model = jlm1b.build_model(jcfg)
    batches = _batches(jcfg.vocab_size)
    base = _jax_engine(model, (1, 4), batches[0])
    init = jax.tree.map(np.asarray, base.init_state(0).params)
    ranks = run_ranks(tmp_path_factory.mktemp("tune"), WORLD, "tune_lm1b",
                      deadline_s=240, cfg_kw=CFG, tune_kw=TUNE, init=init,
                      batches=batches, candidates=_candidates(jcfg),
                      script=SCRIPT)
    return model, batches, base, ranks


def test_every_rank_takes_the_same_decision(runs):
    _, _, _, ranks = runs
    first = ranks[0]
    for r in ranks:
        assert r["plans"] == first["plans"]
        assert r["summary"] == first["summary"]
        assert r["final_plan"] == first["final_plan"]
    plans = first["plans"]
    assert len(set(plans[:3])) == 1 and len(set(plans[3:6])) == 1
    assert plans[0] != plans[3]
    # the averaged times favour the first trial: every rank replans
    # back to it, though three of the four measured the second faster
    assert plans[6:] == [plans[0]] * 2 == [first["final_plan"]] * 2
    w = first["summary"]["winner"]
    assert w["plan"] == plans[0]
    assert w["measured_ms"] == pytest.approx(np.mean(FIRST) * 1e3)
    assert [t["measured_ms"] for t in first["summary"]["trials"]] == \
        pytest.approx([np.mean(FIRST) * 1e3, np.mean(SECOND) * 1e3])
    # the losing candidate's engine is pruned at the end
    assert all(r["engines"] == 1 for r in ranks)


def test_decision_equals_jax_mesh_search(runs):
    _, _, base, ranks = runs
    ms = jsearch.MeshSearch(WORLD, jconfig.TuneConfig(**TUNE),
                            jcm.Plan(1, 4, "HYBRID"))
    plan = ms.begin(jcm.inputs_from_engine(base))
    order = []
    for t in (np.mean(FIRST), np.mean(SECOND)):
        order.append(plan.describe())
        plan = ms.report(plan, t)
    assert plan is None
    got = ranks[0]["summary"]
    assert [t["plan"] for t in got["trials"]] == order
    assert got["winner"]["plan"] == ms.best_plan().describe()
    want = ms.summary()
    for k in ("num_devices", "candidates_enumerated", "pruned_equivalent",
              "pruned_by_cost_model", "pruned_oom", "trials_measured",
              "top_k", "max_pp", "pipeline_capable", "cost_basis"):
        assert got[k] == want[k], k
    assert [s["plan"] for s in got["scored"]] == \
        [s["plan"] for s in want["scored"]]


def test_probe_cost_inputs_equal_jax(runs):
    _, _, base, ranks = runs
    want = jcm.inputs_from_engine(base)
    for r in ranks:
        got = r["inputs"]
        for k in ("dense_grad_bytes", "table_grad_bytes",
                  "sparse_fwd_bytes", "sparse_repl_bytes",
                  "lstm_stream_bytes", "lstm_resident_bytes", "probe_dp",
                  "probe_tp", "num_devices"):
            assert got[k] == getattr(want, k), k
        assert got["sparse_fwd_bytes"] > 0 and got["lstm_stream_bytes"] > 0


def test_losses_across_the_replans_equal_jax(runs):
    model, batches, base, ranks = runs
    engines = {}
    state, prev, losses = None, None, []
    for plan, b in zip(ranks[0]["plans"], batches):
        shape = tuple(int(x) for x in
                      plan.split("/")[0][2:].split("xtp"))
        eng = engines.get(shape)
        if eng is None:
            eng = engines[shape] = (base if shape == (1, 4) else
                                    _jax_engine(model, shape, batches[0]))
        if state is None:
            state = eng.init_state(0)
        elif eng is not prev:
            # the JAX session's own reshard onto the next plan
            state = JSession._reshard_state(
                types.SimpleNamespace(_engine=eng), state)
        state, out = eng.step(state, b)
        losses.append(float(out["loss"]))
        prev = eng
    final = _flat(state.params)
    for r in ranks:
        _close(r["losses"], losses, rtol=1e-4)
        _params_close(r["params"], final, rtol=1e-4)
