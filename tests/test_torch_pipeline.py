"""Pipeline parallelism, the three-axis mesh and cross-rank BatchNorm of
the port against the JAX package.

The ranks are gloo processes (bodies ``pipe_all`` in
``torch_dist_ranks.py``), two and four at once; the JAX side runs in this
process on the emulated CPU devices. fp32 throughout.

(a) ``ops.pipeline``: GPipe (``pipeline_apply``: the output and the
    gradients of ``sum(out * cot)``), 1F1B (``pipeline_value_and_grad``:
    loss, stage, head and input gradients) and interleaving (V 2, with a
    ragged round) on the meshes (1, 2), (1, 4), (2, 2) and the three-axis
    (1, 1, 2), (2, 1, 2) and (1, 2, 2) (stages over 'pipe', 'shard'
    running copies), against JAX's same functions on the same mesh of CPU
    devices, as ``tests/test_pipeline.py`` runs them. Each rank holds its
    stage rows and its repl row; JAX's gradients are the sum (GPipe, of a
    sum) or the mean (1F1B, of a mean) of the ranks' over 'repl'. Outputs
    within 2e-5, gradients within 1e-4 of their peak (an 8-stage tanh
    chain in another summation order). A GPipe forward makes one hop a
    tick (``pipeline_wire_bytes``' ticks) and one all-reduce.
(b) The schedule's arithmetic equal to JAX's: ``_decode_entry``,
    ``stage_order_permutation``, ``inflight_buffer_size``,
    ``tune.costmodel.pipeline_bubble`` and ``pipeline_wire_bytes``; the
    ragged warning once; the three-axis mesh's layout (rank ``(r * tp +
    s) * pp + q`` is the JAX mesh's device ``(r, s, q)``).
(c) ``LongContextConfig(parallelism='pipeline')``, GPipe and 1F1B, V 1
    and 2 (device-major storage), on (1, 2) and (2, 2), three steps with
    its own clip + Adam and again with SGD (lr 0.1, which shows a
    gradient scaled wrongly), against the JAX engine of the data-parallel
    model on one device from the same parameters: losses at rtol 1e-4 and
    every gathered parameter (``blocks_stacked`` in storage order) within
    1e-4 of its peak; each rank holds ``num_layers / S`` stage rows.
(d) Cross-rank BatchNorm: the small ResNet of ``test_torch_cnn.py`` under
    AR on (2, 1), each rank fed half of each batch of 8, against the JAX
    engine on 2 devices: three losses (the global batch's on each rank)
    at rtol 1e-4 and the accuracies equal, the parameters, momentum and
    ``batch_stats`` after within 1e-4 of their peak, the statistics
    equal on both ranks; and against the port's one-rank run on the
    whole batches (the same statistics) at the same tolerance. As in
    ``test_torch_cnn.py`` the fp32 comparison holds away from the ReLU
    kinks: the batches' every pre-activation stays above 1e-6 (with
    ``np.random.default_rng(0)``'s batches one lies at 9.4e-7, where
    the JAX 2-device program takes the other branch and moves the
    parameters by 1.1e-3 of their peak from JAX's own 1- and 4-device
    runs, which the port matches within 4e-5).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_ranks as bodies
from parallax_tpu.core import engine as jengine
from parallax_tpu.core import mesh as jmesh
from parallax_tpu.models import cnn as jcnn
from parallax_tpu.models import long_context as jlc
from parallax_tpu.models import resnet as jresnet
from parallax_tpu.ops import pipeline as jpp
from parallax_tpu.tune import costmodel as jcost
from parallax_tpu_torch.core import mesh as tmesh
from parallax_tpu_torch.models import long_context as tlc
from parallax_tpu_torch.ops import pipeline as tpp
from parallax_tpu_torch.tune import costmodel as tcost
from test_torch_dist import (_flat, _jax_config, join_ranks, shared,
                             start_ranks)

D = 8
SGD_LR = 0.1
# name: (mesh shape, V, M)
OPS = {"s2": ((1, 2), 1, 4),
       "s2_v2": ((1, 2), 2, 4),
       "s2_v2_ragged": ((1, 2), 2, 3),
       "s4": ((1, 4), 1, 4),
       "s4_v2_ragged": ((1, 4), 2, 6),
       "r2_s2": ((2, 2), 1, 4),
       "pipe_1x1x2": ((1, 1, 2), 2, 4),
       "pipe_2x1x2": ((2, 1, 2), 1, 4),
       "pipe_1x2x2": ((1, 2, 2), 1, 4)}
# name: (config kwargs, (repl, shard))
LC = {f"{sched}_v{v}_{r}x{s}": (dict(
          pipeline_schedule=sched, num_layers=4, max_len=16,
          num_microbatches=2,
          **(dict(virtual_stages=2, pipeline_stages=s) if v == 2 else {})),
          (r, s))
      for sched in ("gpipe", "1f1b") for v in (1, 2)
      for r, s in ((1, 2), (2, 2))}
OPTS = ("own", "sgd")
LC_STEPS, LC_BATCH, LC_SEQ = 3, 8, 16
BN_STEPS = 3


def _stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _mb_loss(head, out, y_mb):
    return jnp.mean((out @ head["wout"] - y_mb) ** 2)


def _ops_inputs(shape, V, M, seed):
    rng = np.random.default_rng(seed)
    S = shape[-1] if len(shape) == 3 else shape[1]
    B = shape[0] * M * 2

    def f32(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return (f32(S * V, D, D, scale=0.5), f32(S * V, D, scale=0.1),
            f32(B, D), f32(B, D), f32(D, D, scale=0.3), f32(B, D))


def _jax_ops(shape, V, M, w, b, x, y, wout, cot):
    mesh = jmesh.build_mesh(jax.devices()[:int(np.prod(shape))],
                            shape=shape)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}

    def apply(p, xx):
        return jpp.pipeline_apply(_stage, p, xx, mesh, M, virtual_stages=V)

    out = jax.jit(apply)(params, x)
    gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(apply(p, xx) * cot),
                              argnums=(0, 1)))(params, x)
    loss, (gs, gh, g1x) = jax.jit(
        lambda p, h, xx, yy: jpp.pipeline_value_and_grad(
            _stage, _mb_loss, p, xx, yy, mesh, M, head_params=h,
            virtual_stages=V))(params, {"wout": jnp.asarray(wout)}, x, y)
    return {"out": np.asarray(out), "gw": np.asarray(gp["w"]),
            "gb": np.asarray(gp["b"]), "gx": np.asarray(gx),
            "loss": float(loss), "g1w": np.asarray(gs["w"]),
            "g1b": np.asarray(gs["b"]), "g1head": np.asarray(gh["wout"]),
            "g1x": np.asarray(g1x),
            "devices": [d.id for d in mesh.devices.reshape(-1)]}


def _jax_lc(batches, sgd):
    cfg = jlc.tiny_config(compute_dtype=jnp.float32, parallelism="data",
                          num_layers=4, max_len=16)
    model = jlc.build_model(cfg)
    if sgd:
        model.optimizer = optax.sgd(SGD_LR)
    mesh = jmesh.build_mesh(jax.devices()[:1], shape=(1, 1))
    eng = jengine.Engine(model, mesh, _jax_config(run_option="HYBRID"),
                         batches[0])
    state = eng.init_state(0)
    init = jax.tree.map(np.asarray, state.params)
    losses = []
    for b in batches:
        state, out = eng.step(state, b)
        losses.append(float(out["loss"]))
    return init, losses, jax.tree.map(np.asarray, state.params)


def _jax_bn(batches):
    name = "tiny_resnet_pipeline_test"
    jcnn.MODEL_REGISTRY[name] = (
        lambda **kw: jresnet.ResNet(stage_sizes=[1, 1, 1, 1], num_filters=8,
                                    dtype=jnp.float32, **kw), 32)
    try:
        model = jcnn.build_model(name, num_classes=10, image_size=32)
    finally:
        del jcnn.MODEL_REGISTRY[name]
    mesh = jmesh.build_mesh(jax.devices()[:2], shape=(2, 1))
    eng = jengine.Engine(model, mesh, _jax_config(run_option="AR"),
                         batches[0])
    state = eng.init_state(0)
    init = {"params": jax.tree.map(np.asarray, state.params),
            "batch_stats": jax.tree.map(
                np.asarray, state.model_state["batch_stats"])}
    outs = []
    for b in batches:
        state, out = eng.step(state, b)
        outs.append([float(out["loss"]), float(out["accuracy"])])
    return init, outs, {"params": _flat(state.params),
                        "stats": _flat(state.model_state),
                        "trace": _flat(state.opt_state[1][0].trace)}


def _runs(tmp):
    ops_cases = [(name, shape, V, M) + _ops_inputs(shape, V, M, i)
                 for i, (name, (shape, V, M)) in enumerate(OPS.items())]
    rng = np.random.default_rng(7)
    lc_batches = [jlc.make_batch(rng, LC_BATCH, LC_SEQ, 512)
                  for _ in range(LC_STEPS)]
    oracle = {opt: _jax_lc(lc_batches, opt == "sgd") for opt in OPTS}
    init = oracle["own"][0]
    runs = [(f"{name}/{opt}", kw, shape, SGD_LR if opt == "sgd" else None,
             init, lc_batches)
            for name, (kw, shape) in LC.items() for opt in OPTS]
    bn_rng = np.random.default_rng(1)
    bn_batches = [jcnn.make_batch(bn_rng, 8, 32, 10)
                  for _ in range(BN_STEPS)]
    bn_init, bn_outs, bn_final = _jax_bn(bn_batches)
    handles = [start_ranks(tmp, world, "pipe_all", deadline_s=300,
                           ops_cases=ops_cases, model_runs=runs,
                           bn=(bn_init, bn_batches) if world == 2 else None)
               for world in (2, 4)]
    jops = {c[0]: _jax_ops(*c[1:]) for c in ops_cases}
    bn_one = bodies.cnn_bn(0, 1, bn_init, bn_batches)
    ranks = {world: join_ranks(h) for world, h in zip((2, 4), handles)}
    return {"ops": jops, "lc": oracle, "bn": (bn_outs, bn_final),
            "bn_one": bn_one, "ranks": ranks}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared(tmp_path_factory, "pipeline", _runs)


def _close(got, want, what, rel=1e-4, atol=0.0):
    want = np.asarray(want)
    peak = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * peak + atol,
                               err_msg=what)


# -- (a) the schedules on gloo ranks ------------------------------------------


@pytest.mark.parametrize("name", list(OPS))
def test_pipeline_ops_match_jax_mesh(runs, name):
    shape, V, M = OPS[name]
    want = runs["ops"][name]
    world = int(np.prod(shape))
    got = [r["ops"][name] for r in runs["ranks"][world]]
    R = shape[0]
    S = shape[-1] if len(shape) == 3 else shape[1]
    n = want["out"].shape[0] // R
    gw = np.asarray(want["gw"]).reshape((S, V) + want["gw"].shape[1:])
    gb = np.asarray(want["gb"]).reshape((S, V) + want["gb"].shape[1:])
    g1w = want["g1w"].reshape(gw.shape)
    g1b = want["g1b"].reshape(gb.shape)
    sums = {}
    for k, g in enumerate(got):
        r, col, q = g["coords"]
        s = q if len(shape) == 3 else col
        # rank k is the JAX mesh's device at the same place
        assert want["devices"] == list(range(world))
        assert g["coords"] == tuple(int(i) for i in np.unravel_index(
            k, shape + (1,) * (3 - len(shape))))
        assert g["stage"] == (S, s)
        assert g["shape"] == dict(zip(("repl", "shard", "pipe"), shape))
        assert g["axes"] == tuple(g["shape"])
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(g["out"], want["out"][rows], rtol=0,
                                   atol=2e-5)
        _close(g["gx"], want["gx"][rows], f"{name} gx")
        _close(g["g1x"] / R, want["g1x"][rows], f"{name} 1f1b gx")
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=2e-5)
        key = (col if len(shape) == 3 else 0, s)
        acc = sums.setdefault(key, [0, 0, 0, 0, 0])
        for i, v in enumerate((g["gw"], g["gb"], g["g1w"], g["g1b"],
                               g["g1head"])):
            acc[i] = acc[i] + v
        # one hop a tick and one all-reduce of the outputs (a one-rank
        # ring makes no hop)
        ticks = jcost.pipeline_wire_bytes(1.0, M, S, V)["ticks"]
        assert g["counts"]["collective_permute"] == ticks
        assert g["counts"]["all_reduce"] == 1
    assert len(sums) == world // R
    for (col, s), (sw, sb, s1w, s1b, s1h) in sums.items():
        _close(sw, gw[s], f"{name} gpipe w[{s}]")
        _close(sb, gb[s], f"{name} gpipe b[{s}]")
        _close(s1w / R, g1w[s], f"{name} 1f1b w[{s}]")
        _close(s1b / R, g1b[s], f"{name} 1f1b b[{s}]")
        _close(s1h / R, want["g1head"], f"{name} 1f1b head")


# -- (b) the schedule's arithmetic --------------------------------------------


def test_tick_math_equals_jax():
    for S in (1, 2, 3, 4):
        for V in (1, 2, 3):
            assert tpp.stage_order_permutation(S, V) == \
                jpp.stage_order_permutation(S, V)
            for M in range(1, 10):
                assert tpp.inflight_buffer_size(S, M, V) == \
                    jpp.inflight_buffer_size(S, M, V)
                n = V * tpp._rounded_microbatches(M, S, V)
                for reverse in (False, True):
                    for k in range(-S - 1, n + 2):
                        a, v, m = jpp._decode_entry(jnp.asarray(k), S, V, M,
                                                    reverse=reverse)
                        assert tpp._decode_entry(k, S, V, M, reverse) == \
                            (bool(a), int(v), int(m)), (S, V, M, k)
    stacked = np.arange(12.0).reshape(6, 2)
    mesh = tmesh.Mesh(torch.device("cpu"), repl=1, shard=3, rank=2)
    rows = tpp.stage_rows({"w": torch.tensor(stacked)}, mesh, 2)
    np.testing.assert_array_equal(rows["w"].numpy(), stacked[4:6])
    with pytest.raises(ValueError, match="num_stages\\*virtual_stages"):
        tpp.stage_rows({"w": torch.tensor(stacked)}, mesh, 3)


@pytest.mark.parametrize("M,S,V,schedule,dp,tp", [
    (4, 4, 1, "gpipe", 1, 1), (8, 2, 1, "1f1b", 2, 1), (4, 4, 2, "1f1b", 1, 2),
    (6, 4, 2, "gpipe", 2, 2), (3, 2, 3, "1f1b", 1, 1), (1, 1, 1, "gpipe", 4, 1)])
def test_pipeline_bubble_and_wire_bytes_equal_jax(M, S, V, schedule, dp, tp):
    assert tcost.pipeline_bubble(M, S, V) == jcost.pipeline_bubble(M, S, V)
    assert tcost.pipeline_wire_bytes(1 << 20, M, S, V, schedule, dp, tp) == \
        jcost.pipeline_wire_bytes(1 << 20, M, S, V, schedule, dp, tp)
    with pytest.raises(ValueError, match="M, S, V >= 1"):
        tcost.pipeline_bubble(0, S)


def test_ragged_interleaved_warns_once(caplog):
    tpp._ragged_warned.discard((3, 2, 2))
    with caplog.at_level(logging.WARNING, logger="PARALLAX"):
        for _ in range(3):
            tpp._warn_ragged(3, 2, 2)
        tpp._warn_ragged(4, 2, 2)
        tpp._warn_ragged(3, 2, 1)
    ragged = [r for r in caplog.records if "pads to" in r.getMessage()]
    assert len(ragged) == 1
    assert "pads to 4 entries" in ragged[0].getMessage()
    assert tcost.pipeline_bubble(3, 2, 2)["microbatches_scheduled"] == 4


def test_three_axis_mesh_layout():
    one = tmesh.build_mesh("cpu", shape=(1, 1, 1))
    assert one.axis_names == ("repl", "shard") and one.pipe == 1
    with pytest.raises(ValueError, match="dp\\*tp\\*pp"):
        tmesh.build_mesh("cpu", shape=(2, 2, 3))
    with pytest.raises(ValueError, match="\\(dp, tp, pp\\)"):
        tmesh.build_mesh("cpu", shape=(1, 1, 1, 1))
    jm = jmesh.build_mesh(shape=(2, 2, 2))
    pos = {d.id: idx for idx, d in np.ndenumerate(jm.devices)}
    for k, dev in enumerate(jm.devices.reshape(-1)):
        m = tmesh.Mesh(torch.device("cpu"), repl=2, shard=2, rank=k, pipe=2)
        r, s, q = pos[dev.id]
        assert (m.coords, m.pipe_index) == ((r, s), q)
        assert tmesh.pipeline_axis(m) == jmesh.pipeline_axis(jm) == "pipe"
        assert tmesh.pipeline_stage_count(m) == \
            jmesh.pipeline_stage_count(jm) == 2
        assert tmesh.pipeline_index(m) == q
    assert m.shape == {"repl": 2, "shard": 2, "pipe": 2} and m.size == 8
    two = tmesh.Mesh(torch.device("cpu"), repl=4, shard=2, rank=3)
    assert tmesh.pipeline_axis(two) == "shard"
    assert tmesh.pipeline_stage_count(two) == 2
    assert tmesh.pipeline_index(two) == 1
    assert tmesh.resolve_spec(tmesh.P("pipe")) == tmesh.P("shard")


# -- (c) the long-context LM in pipeline mode ---------------------------------


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("name", list(LC))
def test_lc_pipeline_session_matches_jax(runs, name, opt):
    kw, (repl, shard) = LC[name]
    _, want_losses, want_params = runs["lc"][opt]
    cfg = tlc.tiny_config(parallelism="pipeline", **kw)
    order = tlc._layer_storage_order(cfg)
    stacked = {p: np.stack([_flat(want_params["blocks"][i])[p]
                            for i in order])
               for p in _flat(want_params["blocks"][0])}
    want = {p: v for p, v in _flat(want_params).items()
            if not p.startswith("blocks/")}
    want.update({f"blocks_stacked/{p}": v for p, v in stacked.items()})
    for k, r in enumerate(runs["ranks"][repl * shard]):
        got = r["models"][f"{name}/{opt}"]
        assert got["mesh"] == (repl, shard, divmod(k, shard))
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4,
                                   err_msg=name)
        assert got["tokens"] == [LC_BATCH * (LC_SEQ - 1)] * LC_STEPS
        assert got["layout"] == "repl"
        assert got["placements"]["blocks_stacked/wqkv"] == "stage_sharded"
        assert got["placements"]["emb"] == "replicated"
        assert got["local_shapes"]["blocks_stacked/wqkv"] == \
            (cfg.num_layers // shard, 32, 96)
        assert set(got["params"]) == set(want)
        for path, w in want.items():
            _close(got["params"][path], w, f"{name}/{opt} {path}")


def test_lc_pipeline_model_surface():
    for sched in ("gpipe", "1f1b"):
        for v in (1, 2):
            kw = dict(pipeline_schedule=sched, num_layers=4)
            if v == 2:
                kw.update(virtual_stages=2, pipeline_stages=2)
            tm = tlc.build_model(tlc.tiny_config(parallelism="pipeline", **kw))
            jm = jlc.build_model(jlc.tiny_config(parallelism="pipeline", **kw))
            assert (tm.value_and_grad_fn is None) == \
                (jm.value_and_grad_fn is None) == (sched == "gpipe")
            info = dict(tm.pipeline_info)
            assert info.pop("act_itemsize") == 2
            jinfo = dict(jm.pipeline_info)
            jinfo.pop("act_itemsize")
            assert info == jinfo
            assert tuple(tm.batch_specs["ids"]) == ("repl", None)
            assert tuple(tm.param_specs["blocks_stacked/*"]) == ("pipe",)
    cfg = tlc.tiny_config(parallelism="pipeline", num_layers=4,
                          virtual_stages=2, pipeline_stages=2)
    assert tlc._layer_storage_order(cfg) == [0, 2, 1, 3]
    meta = tlc.init_params(cfg, torch.Generator(), "meta")
    assert "blocks" not in meta
    assert tuple(meta["blocks_stacked"]["ln1"]["s"].shape) == (4, 32)


# -- (d) cross-rank BatchNorm -------------------------------------------------


def test_cross_rank_batch_norm_matches_jax_engine(runs):
    want_outs, want = runs["bn"]
    got = [r["bn"] for r in runs["ranks"][2]]
    for g in got:
        np.testing.assert_allclose([o[0] for o in g["outs"]],
                                   [o[0] for o in want_outs], rtol=1e-4)
        assert [o[1] for o in g["outs"]] == [o[1] for o in want_outs]
        assert set(g["params"]) == set(want["params"])
        for path, w in want["params"].items():
            _close(g["params"][path], w, path)
        for path, w in want["trace"].items():
            _close(g["trace"][path], w, path)
        assert set(g["stats"]) == set(want["stats"])
        for path, w in want["stats"].items():
            _close(g["stats"][path], w, path)
        assert g["margin"] > 1e-6, g["margin"]
    for path in want["stats"]:
        np.testing.assert_array_equal(got[0]["stats"][path],
                                      got[1]["stats"][path])
    one = runs["bn_one"]
    for section in ("params", "stats", "trace"):
        for path, w in one[section].items():
            _close(got[0][section][path], w, path)
