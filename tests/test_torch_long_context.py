"""The port's long-context causal LM against the JAX package.

fp32 throughout, ``tiny_config`` (vocab 512, D 32, 2 heads, MLP 64, 2
layers, max_len 64), weights carried from the JAX initial tree.

(a) One rank: the loss, ``tokens`` and every gradient of the port's
    ``loss_fn`` against ``jax.value_and_grad`` of the JAX ``loss_fn`` on
    the same batch (4 x 16), within 1e-5 of each leaf's peak, for the
    plain core (``parallelism='data'``), ``use_pallas_attention`` (the
    flash path; Pallas interpret mode on the JAX side) and the default
    ring under a one-rank mesh (JAX: a (1, 1) mesh), where the ring has
    one block.
(b) Three ``sess.run`` steps on gloo ranks (``torch_dist_ranks.
    lc_models``), rank ``r * shard + s`` holding the JAX mesh's device
    ``(r, s)``, of the ring at (1, 2), (1, 4) and (2, 2), contiguous and
    zig-zag (each rank of a shard group fed its repl row's whole
    natural-order rows), tensor parallelism at (1, 2) and (2, 2) with the
    vocab-parallel head, with and without ``tp_sequence_parallel``, and
    data parallelism at (2, 1), batches of 8 x 16. With the model's own
    optimizer (clip + Adam) each run is held to the JAX engine of the
    same model on the same mesh of CPU devices, from its initial
    parameters: losses at rtol 1e-4 and every parameter of
    ``gather_params()`` within 1e-4 of its peak. Adam hides a gradient
    scaled by a constant, so each run goes again with SGD (lr 0.1), held
    to the JAX data-parallel run on one device at the same tolerances:
    a gradient summed over the wrong ranks fails there. ``tokens`` is
    8 x 15 every step on every rank; the engine reads the ring's spec as
    the sequence layout.
(c) ``remat=True`` equals ``remat=False`` within 1e-6 over three steps.
(d) The refusals: every JAX ``ValueError`` of ``build_model`` and of the
    loss, ``'pipeline'`` (``NotImplementedError``), and the engine's
    reading of ``P('repl', 'shard')``: the sequence layout, never "the
    batch on 'repl' alone"; any other spec with 'shard' past dim 0
    raises ``NotImplementedError``.
(e) Weights: a TP rank's leaves (the fused ``wqkv`` as its heads' q, k
    and v columns, ``out_w`` its vocabulary columns) and the shape checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import parallax_tpu_torch as tpt
from parallax_tpu.core import engine as jengine
from parallax_tpu.core import mesh as jmesh
from parallax_tpu.models import long_context as jlc
from parallax_tpu.ops import embedding as jemb
from parallax_tpu_torch import weights
from parallax_tpu_torch.core import engine as tengine, mesh as tmesh, optim
from parallax_tpu_torch.core.classify import flatten
from parallax_tpu_torch.models import long_context as tlc
from parallax_tpu_torch.ops import collectives
from test_torch_dist import (_flat, _jax_config, join_ranks, shared,
                             start_ranks)

STEPS = 3
SGD_LR = 0.1
BATCH, SEQ = 8, 16


def _jax_params(cfg):
    params = jlc.build_model(cfg).init_fn(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _close(got, want, what, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


# -- (a) one rank -------------------------------------------------------------

ONE_RANK = {"plain": dict(parallelism="data"),
            "flash": dict(parallelism="data", use_pallas_attention=True),
            "ring1": {}}


@pytest.mark.parametrize("name", list(ONE_RANK))
def test_loss_and_gradients_match_jax(name):
    kw = ONE_RANK[name]
    jcfg = jlc.tiny_config(compute_dtype=jnp.float32, **kw)
    init = _jax_params(jcfg)
    batch = jlc.make_batch(np.random.default_rng(0), 4, 16, jcfg.vocab_size)
    jmodel = jlc.build_model(jcfg)

    def f(p):
        return jmodel.loss_fn(p, batch, jax.random.PRNGKey(1))

    vag = jax.jit(jax.value_and_grad(f, has_aux=True))
    if name == "ring1":
        mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                    ("repl", "shard"))
        with jemb.sharded_lookup_scope(mesh, []):
            (jloss, jaux), jgrads = vag(init)
    else:
        (jloss, jaux), jgrads = vag(init)

    tcfg = tlc.tiny_config(compute_dtype=torch.float32, **kw)
    params = weights.long_context_params_from_jax(init, tcfg, "cpu")
    leaves = dict(flatten(params))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = tlc.build_model(tcfg)
    if name == "ring1":
        with collectives.mesh_scope(tmesh.Mesh(torch.device("cpu"))):
            loss, aux = model.loss_fn(params, tbatch)
    else:
        loss, aux = model.loss_fn(params, tbatch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    _close(float(loss), float(jloss), "loss", rtol=1e-6, atol=0)
    assert float(aux["tokens"]) == float(jaux["tokens"]) == 4 * 15
    want = _flat(jgrads)
    assert set(want) == set(leaves)
    for (path, _), g in zip(leaves.items(), grads):
        peak = max(float(np.abs(want[path]).max()), 1e-30)
        _close(g.numpy(), want[path], path, rtol=0, atol=1e-5 * peak)


# -- (b) trajectories on gloo ranks -------------------------------------------

# name: (config kwargs, (repl, shard), feed layout)
RUNS = {
    "ring_1x2": (dict(zigzag=False), (1, 2), "repl"),
    "ring_zig_1x2": (dict(zigzag=True), (1, 2), "repl"),
    "ring_1x4": (dict(zigzag=False), (1, 4), "repl"),
    "ring_zig_1x4": (dict(zigzag=True), (1, 4), "repl"),
    "ring_2x2": (dict(zigzag=False), (2, 2), "repl"),
    "ring_zig_2x2": (dict(), (2, 2), "repl"),
    "tensor_1x2": (dict(parallelism="tensor"), (1, 2), "repl"),
    "tensor_sp_1x2": (dict(parallelism="tensor", tp_sequence_parallel=True),
                      (1, 2), "repl"),
    "tensor_2x2": (dict(parallelism="tensor"), (2, 2), "repl"),
    "tensor_sp_2x2": (dict(parallelism="tensor", tp_sequence_parallel=True),
                      (2, 2), "repl"),
    "data_2x1": (dict(parallelism="data"), (2, 1), "all"),
}
OPTS = ("own", "sgd")


def _batches(vocab):
    rng = np.random.default_rng(7)
    return [jlc.make_batch(rng, BATCH, SEQ, vocab) for _ in range(STEPS)]


def _jax_run(cfg_kw, shape, batches, sgd=False):
    """Losses and final parameters of the JAX engine on a ``shape`` mesh
    of CPU devices, and its initial parameters."""
    cfg = jlc.tiny_config(compute_dtype=jnp.float32, **cfg_kw)
    model = jlc.build_model(cfg)
    if sgd:
        model.optimizer = optax.sgd(SGD_LR)
    mesh = jmesh.build_mesh(jax.devices()[:shape[0] * shape[1]],
                            shape=shape)
    eng = jengine.Engine(model, mesh, _jax_config(run_option="HYBRID"),
                         batches[0])
    state = eng.init_state(0)
    init = jax.tree.map(np.asarray, state.params)
    losses = []
    for b in batches:
        state, out = eng.step(state, b)
        losses.append(float(out["loss"]))
    return init, losses, _flat(state.params)


def _model_runs(tmp):
    batches = _batches(512)
    # the JAX engines of one seed start from the same parameters (to an
    # ulp: each jits its own init); the port's runs start from the first's
    oracle = {"sgd": _jax_run(dict(parallelism="data"), (1, 1), batches,
                              sgd=True)}
    init = oracle["sgd"][0]
    runs = []
    for name, (kw, shape, feed) in RUNS.items():
        for opt in OPTS:
            runs.append((f"{name}/{opt}", kw, shape, feed,
                         SGD_LR if opt == "sgd" else None, init, batches))
    handles = [start_ranks(tmp, world, "lc_models", deadline_s=240,
                           runs=runs) for world in (2, 4)]
    for name, (kw, shape, _) in RUNS.items():
        oracle[name] = _jax_run(kw, shape, batches)
    ranks = {}
    for world, handle in zip((2, 4), handles):
        ranks[world] = join_ranks(handle)
    return oracle, ranks


@pytest.fixture(scope="module")
def model_runs(tmp_path_factory):
    return shared(tmp_path_factory, "lc_models", _model_runs)


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("name", list(RUNS))
def test_trajectory_matches_jax(model_runs, name, opt):
    oracle, ranks = model_runs
    kw, (repl, shard), _ = RUNS[name]
    _, want_losses, want_params = oracle[name if opt == "own" else "sgd"]
    for k, r in enumerate(ranks[repl * shard]):
        got = r[f"{name}/{opt}"]
        assert got["mesh"] == (repl, shard, divmod(k, shard))
        _close(got["losses"], want_losses, "losses", rtol=1e-4, atol=0)
        assert got["tokens"] == [BATCH * (SEQ - 1)] * STEPS
        assert set(got["params"]) == set(want_params)
        for path, w in want_params.items():
            peak = max(float(np.abs(w).max()), 1e-30)
            _close(got["params"][path], w, path, rtol=0, atol=1e-4 * peak)
        mode = kw.get("parallelism", "ring")
        assert got["layout"] == {"ring": "sequence", "tensor": "repl",
                                 "data": "batch"}[mode]
        if mode == "tensor":
            assert got["placements"]["out_w"] == "tp_column"
            assert got["local_shapes"]["out_w"] == (32, 512 // shard)
            assert got["local_shapes"]["blocks/0/wqkv"] == (32, 96 // shard)
            assert got["local_shapes"]["blocks/1/w2"] == (64 // shard, 32)
        else:
            assert set(got["placements"].values()) == {"replicated"}


# -- (c) remat ----------------------------------------------------------------


def test_remat_matches_no_remat():
    batches = _batches(512)
    out = {}
    for remat in (False, True):
        cfg = tlc.tiny_config(compute_dtype=torch.float32, remat=remat)
        sess, *_ = tpt.parallel_run(
            tlc.build_model(cfg), device="cpu",
            parallax_config=tpt.Config(run_option="HYBRID"))
        losses = [float(sess.run("loss", feed_dict=b)) for b in batches]
        out[remat] = (losses, {p: v.detach().numpy().copy() for p, v in
                               flatten(sess.state.params)})
        sess.close()
    _close(out[True][0], out[False][0], "losses", rtol=1e-6, atol=0)
    for path, w in out[False][1].items():
        peak = max(float(np.abs(w).max()), 1e-30)
        _close(out[True][1][path], w, path, rtol=0, atol=1e-6 * peak)


# -- (d) refusals -------------------------------------------------------------

ERRORS = [
    (dict(parallelism="data", zigzag=True), "zigzag"),
    (dict(tp_sequence_parallel=True), "tp_sequence_parallel"),
    (dict(parallelism="tensor", use_pallas_attention=True),
     "use_pallas_attention"),
    (dict(virtual_stages=2), "virtual_stages"),
    (dict(parallelism="pipeline", virtual_stages=2), "pipeline_stages"),
    (dict(parallelism="pipeline", virtual_stages=2, pipeline_stages=3),
     "num_layers"),
    (dict(parallelism="sequence"), "unknown parallelism"),
    (dict(pipeline_schedule="zb"), "unknown pipeline_schedule"),
]


@pytest.mark.parametrize("kw,match", ERRORS, ids=[m for _, m in ERRORS])
def test_build_model_raises_what_jax_raises(kw, match):
    with pytest.raises(ValueError, match=match):
        jlc.build_model(jlc.tiny_config(**kw))
    with pytest.raises(ValueError, match=match):
        tlc.build_model(tlc.tiny_config(**kw))


def test_pipeline_and_loss_refusals():
    jlc.build_model(jlc.tiny_config(parallelism="pipeline"))
    with pytest.raises(NotImplementedError, match="Queue A item 5.3"):
        tlc.build_model(tlc.tiny_config(parallelism="pipeline"))
    assert tlc.tiny_config(use_ring_attention=False).parallelism == "data"
    assert tlc.tiny_config(use_ring_attention=True).use_ring_attention
    cfg = tlc.LongContextConfig()
    want = jlc.LongContextConfig()
    for field in ("vocab_size", "model_dim", "num_heads", "mlp_dim",
                  "num_layers", "max_len", "learning_rate", "parallelism",
                  "zigzag", "remat"):
        assert getattr(cfg, field) == getattr(want, field), field
    assert cfg.compute_dtype == torch.bfloat16
    tiny = tlc.tiny_config(compute_dtype=torch.float32)
    model = tlc.build_model(tiny)
    params = tlc.init_params(tiny, torch.Generator(), "cpu")
    too_long = {"ids": torch.ones((1, tiny.max_len + 1),
                                  dtype=torch.int32)}
    with pytest.raises(ValueError, match="exceeds max_len"):
        model.loss_fn(params, too_long)
    zig = tlc.build_model(tlc.tiny_config(zigzag=True))
    two = tmesh.Mesh(torch.device("cpu"), repl=1, shard=2)
    with collectives.mesh_scope(two), \
            pytest.raises(ValueError, match="2\\*ring=4"):
        zig.loss_fn(params, {"ids": torch.ones((1, 6), dtype=torch.int32)})


def test_engine_reads_the_sequence_layout():
    """``P('repl', 'shard')`` is the sequence layout, not "the batch on
    'repl' alone" (the parent's ``_batch_on_repl`` read dim 0 only and
    returned True); any other spec with 'shard' past dim 0 raises."""
    P = tmesh.P
    model = tlc.build_model(tlc.tiny_config())
    batch = {"ids": np.ones((2, 8), np.int32)}
    assert model.batch_specs == {"ids": P("repl", "shard")}
    assert tengine._batch_layout(model, batch) == "sequence"
    for spec in (P("repl", None, "shard"), P(None, "shard"),
                 P("shard", "shard"), P(("repl", "shard"), "shard"),
                 P("repl", "repl")):
        model.batch_specs = {"ids": spec}
        with pytest.raises(NotImplementedError, match="ported"):
            tengine._batch_layout(model, batch)
    model.batch_specs = {"ids": P("repl", "shard"), "w": P("repl", None)}
    with pytest.raises(NotImplementedError, match="different layouts"):
        tengine._batch_layout(model, {**batch, "w": batch["ids"]})


# -- (e) weights --------------------------------------------------------------


def test_tensor_parallel_rank_weights():
    jcfg = jlc.tiny_config(parallelism="tensor")
    init = _jax_params(jcfg)
    cfg = tlc.tiny_config(parallelism="tensor")
    mesh = tmesh.Mesh(torch.device("cpu"), repl=1, shard=2, rank=1)
    eng = tengine.Engine(tlc.build_model(cfg), mesh,
                         tpt.Config(run_option="HYBRID"),
                         {"ids": np.ones((2, 8), np.int32)})
    got = dict(flatten(weights.long_context_params_from_jax(
        init, cfg, "cpu", engine=eng)))
    D = cfg.model_dim
    w = init["blocks"][0]["wqkv"]
    want = np.concatenate([w[:, j * D + D // 2:(j + 1) * D]
                           for j in range(3)], axis=1)
    np.testing.assert_array_equal(got["blocks/0/wqkv"].numpy(), want)
    np.testing.assert_array_equal(got["out_w"].numpy(),
                                  init["out_w"][:, cfg.vocab_size // 2:])
    np.testing.assert_array_equal(got["blocks/0/wo"].numpy(),
                                  init["blocks"][0]["wo"][D // 2:])
    np.testing.assert_array_equal(got["emb"].numpy(), init["emb"])
    bad = dict(init, pos=init["pos"][:-1])
    with pytest.raises(ValueError, match="pos"):
        weights.long_context_params_from_jax(bad, cfg, "cpu")
    short = dict(init, blocks=init["blocks"][:1])
    with pytest.raises(ValueError, match="blocks"):
        weights.long_context_params_from_jax(short, cfg, "cpu")
    assert dataclasses.asdict(cfg)["parallelism"] == "tensor"
