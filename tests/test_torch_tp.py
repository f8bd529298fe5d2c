"""The port's tensor parallelism against the JAX package.

Ranks are spawned gloo processes (``test_torch_dist.run_ranks``; bodies
in ``torch_dist_ranks.py``, which imports no JAX), rank ``r * shard +
s`` holding the JAX mesh's device ``(r, s)``. fp32 throughout.

(a) ``ops/tensor_parallel.py`` at meshes (1, 2) and (1, 4), each rank
    holding its parts of the weights, against the JAX functions with no
    mesh (the unsharded math): ``column_parallel`` into ``row_parallel``,
    ``tp_attention`` with fused ``wqkv`` (causal; padding mask) and with
    separate ``wq``/``wk``/``wv`` over another key sequence (masked),
    ``tp_attention`` with 2 heads (on 4 ranks the replicated core),
    ``tp_mlp``, and the Megatron block of ``tests/test_tensor_parallel.py``
    (attention and MLP with their residuals) without and with sequence
    parallelism: the output, the inputs' gradients and the whole weights'
    gradients (each rank's part put back in place) within rtol 1e-5, atol
    1e-5. ``count_collectives`` of the block's forward: two all-reduces
    and nothing else without SP; two all-gathers, two reduce-scatters and
    no all-reduce with SP. ``global_norm`` over a replicated leaf and the
    ranks' tensor-parallel parts equals optax's over the whole arrays;
    the specs resolve as JAX's ``resolve_spec`` and place as the plan
    says.
(b) Three ``sess.run`` steps of tiny BERT (4 heads) with
    ``tensor_parallel`` at (1, 4) and (2, 2), with
    ``tp_sequence_parallel`` at (1, 4), and without TP under HYBRID at
    (2, 2) (``word_emb`` row-sharded across ranks), and of tiny NMT with
    ``tensor_parallel`` at (2, 2), each rank of a shard group feeding its
    repl row's rows. With the model's own optimizer (AdamW, Adam) each
    run is held to the JAX engine of the same model on the same mesh of
    4 CPU devices, from that engine's initial parameters: losses at rtol
    1e-4, every parameter of ``gather_params()`` within 1e-4 of its peak,
    and the wire bytes integer for integer (each id crosses the wire
    once; NMT's dense alternative less JAX's ``pos``, which the JAX
    classifier finds sparse). Adam's update hardly moves when a
    gradient is scaled, so each run goes again with plain SGD (lr 0.1),
    held to the JAX data-parallel run on one device (which
    ``tests/test_tensor_parallel.py:201-230`` holds equal to TP): only
    these show a gradient averaged over the wrong group (off by the
    shard or repl width). Each TP run holds the local shard shapes of
    ``tests/test_tensor_parallel.py:224-228`` and ``:255-259``.

The JAX reference red ``tests/test_model_collectives.py::
test_bert_full_model_backward_collective_pattern`` pins XLA HLO counts
of the JAX BERT step; it has no port counterpart. The port's pattern is
held by (a)'s counts instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from parallax_tpu.core import engine as jengine
from parallax_tpu.core import mesh as jmesh
from parallax_tpu.models import bert as jbert
from parallax_tpu.models import nmt as jnmt
from parallax_tpu.ops import tensor_parallel as jtp
from test_torch_dist import (_flat, _jax_config, join_ranks, run_ranks,
                             shared, start_ranks)

B, T, D, H, M = 4, 8, 32, 4, 64


def _op_cases():
    """(name, body function, inputs, {weight: (whole, kind, groups)},
    kwargs, output cotangent)."""
    rng = np.random.default_rng(0)

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x, x_kv = r(B, T, D), r(B, 6, D)
    mask = rng.random((B, T)) > 0.3
    mask[:, 0] = True
    mask_kv = rng.random((B, 6)) > 0.3
    mask_kv[:, 0] = True
    wqkv, wo = r(D, 3 * D, s=0.1), r(D, D, s=0.1)
    wq, wk, wv = r(D, D, s=0.1), r(D, D, s=0.1), r(D, D, s=0.1)
    w1, w2 = r(D, M, s=0.1), r(M, D, s=0.1)
    cot = r(B, T, D)
    fused = {"wqkv": (wqkv, "col", 3), "wo": (wo, "row", 1)}
    block = {**fused, "w1": (w1, "col", 1), "w2": (w2, "row", 1)}
    return [
        ("column_row", "column_row", {"x": x},
         {"w1": (w1, "col", 1), "w2": (w2, "row", 1)}, {}, cot),
        ("attn_fused_causal", "attention", {"x": x}, fused,
         dict(heads=H, causal=True), cot),
        ("attn_fused_masked", "attention", {"x": x}, fused,
         dict(heads=H, kv_mask=mask), cot),
        ("attn_separate_cross", "attention", {"x": x, "x_kv": x_kv},
         {"wq": (wq, "col", 1), "wk": (wk, "col", 1), "wv": (wv, "col", 1),
          "wo": (wo, "row", 1)}, dict(heads=H, kv_mask=mask_kv), cot),
        ("attn_two_heads", "attention", {"x": x}, fused,
         dict(heads=2, causal=True), cot),
        ("mlp", "mlp", {"x": x}, {"w1": (w1, "col", 1),
                                  "w2": (w2, "row", 1)}, {}, cot),
        ("block", "block", {"x": x}, block, dict(heads=H, causal=True), cot),
        ("block_sp", "block", {"x": x}, block,
         dict(heads=H, causal=True, sequence_parallel=True), cot),
    ]


def _jax_case(case):
    """The unsharded JAX function's output and its gradients (inputs and
    whole weights) for the cotangent."""
    _, fn_name, inputs, weights, kw, cot = case
    heads = kw.get("heads")
    causal = kw.get("causal", False)
    mask = kw.get("kv_mask")
    mask = None if mask is None else jnp.asarray(mask)
    names_x, names_w = list(inputs), list(weights)

    def f(*args):
        xs = dict(zip(names_x, args[:len(names_x)]))
        ws = dict(zip(names_w, args[len(names_x):]))
        if fn_name == "column_row":
            return jtp.row_parallel(jtp.column_parallel(xs["x"], ws["w1"]),
                                    ws["w2"])
        if fn_name == "mlp":
            return jtp.tp_mlp(xs["x"], ws["w1"], ws["w2"])
        attn = {k: ws[k] for k in ("wqkv", "wq", "wk", "wv", "wo")
                if k in ws}
        if fn_name == "attention":
            return jtp.tp_attention(xs["x"], xs.get("x_kv", xs["x"]), attn,
                                    heads, causal=causal, kv_mask=mask)
        y = xs["x"] + jtp.tp_attention(xs["x"], xs["x"], attn, heads,
                                       causal=causal)
        return y + jtp.tp_mlp(y, ws["w1"], ws["w2"])

    args = [jnp.asarray(inputs[k]) for k in names_x] + \
        [jnp.asarray(weights[k][0]) for k in names_w]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(cot))
    return (np.asarray(out),
            {k: np.asarray(g) for k, g in zip(names_x, grads)},
            {k: np.asarray(g) for k, g in zip(names_w,
                                              grads[len(names_x):])})


def _whole(parts, kind, groups):
    """A whole weight from the ranks' parts, in rank order."""
    if kind == "row":
        return np.concatenate(parts, axis=0)
    blocks = [p.reshape(p.shape[:-1] + (groups, -1)) for p in parts]
    whole = np.concatenate(blocks, axis=-1)
    return whole.reshape(whole.shape[:-2] + (-1,))


def _close(got, want, what, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _norm_leaves():
    """A replicated leaf, a fused column shard and a row shard."""
    rng = np.random.default_rng(1)
    return {"ln": (rng.standard_normal((D,)).astype(np.float32), "rep", 1),
            "wqkv": (rng.standard_normal((D, 3 * D)).astype(np.float32),
                     "col", 3),
            "w2": (rng.standard_normal((M, D)).astype(np.float32), "row",
                   1)}


@pytest.fixture(scope="module", params=[2, 4], ids=["1x2", "1x4"])
def op_runs(request, tmp_path_factory):
    world = request.param
    cases = _op_cases()
    ranks = shared(tmp_path_factory, f"tp_ops{world}", lambda tmp: run_ranks(
        tmp, world, "tp_ops", cases=cases, norm_leaves=_norm_leaves()))
    return world, {c[0]: c for c in cases}, ranks


def test_global_norm_sums_tensor_parallel_shards(op_runs):
    """``clip_by_global_norm``'s norm of a tree with tensor-parallel parts
    (named in ``sharded_scope``, as the engine names them) is the whole
    tree's, on every rank (optax.global_norm of the whole arrays)."""
    _, _, ranks = op_runs
    want = float(optax.global_norm({k: jnp.asarray(w) for k, (w, _, _)
                                    in _norm_leaves().items()}))
    for r in ranks:
        np.testing.assert_allclose(r["global_norm"], want, rtol=1e-6)


def test_specs_resolve_and_place_as_jax():
    """The port's specs resolve as JAX's ``resolve_spec`` on a mesh
    without a pipe axis, and the plan places each layout."""
    from jax.sharding import PartitionSpec as JP

    from parallax_tpu_torch.core import engine as tengine, mesh as tmesh
    from parallax_tpu_torch.ops import tensor_parallel as ttp
    jm = jmesh.build_mesh(jax.devices()[:4], shape=(2, 2))
    for entries in ((None, "shard"), ("shard", None), ("pipe", None),
                    (("repl", "pipe"), None), ("repl",), ()):
        got = tmesh.resolve_spec(tmesh.P(*entries))
        assert tuple(got) == tuple(jmesh.resolve_spec(JP(*entries), jm))
    assert tmesh.dim0_axes(tmesh.P("repl", None)) == ("repl",)
    # the port's TP specs keep their kind: a TP row spec is used as its
    # part, a plain row spec is gathered for use
    want = {k: tuple(v) for k, v in jtp.attention_param_specs(
        "blocks/*").items()}
    got = ttp.attention_param_specs("blocks/*")
    assert {k: tuple(v) for k, v in got.items()} == want
    assert got["blocks/*/wqkv"].groups == 3
    place = tengine._spec_placement
    assert place(got["blocks/*/wo"], (8, 8), 2, "wo") == tengine.TP_ROW
    assert place(tmesh.P("shard", None), (8, 8), 2, "t") == \
        tengine.ROW_SHARDED
    assert place(tmesh.P(None, "shard"), (8, 8), 2, "w") == \
        tengine.TP_COLUMN
    assert place(got["blocks/*/wqkv"], (8, 24), 1, "w") == \
        tengine.REPLICATED
    with pytest.raises(ValueError, match="does not split"):
        place(got["blocks/*/wqkv"], (8, 21), 2, "w")
    with pytest.raises(NotImplementedError, match="ported"):
        place(tmesh.P(None, "shard", None), (2, 4, 6), 2, "x")


@pytest.mark.parametrize("name", [c[0] for c in _op_cases()])
def test_tp_ops_match_the_unsharded_jax_functions(op_runs, name):
    world, cases, ranks = op_runs
    case = cases[name]
    want_out, want_x, want_w = _jax_case(case)
    sp = case[4].get("sequence_parallel", False)
    assert [r["coords"] for r in ranks] == [(0, s) for s in range(world)]
    got = [r[name] for r in ranks]
    if sp:
        # each rank holds its T/world of the sequence
        _close(np.concatenate([g["out"] for g in got], axis=1), want_out,
               "out")
        for k, w in want_x.items():
            _close(np.concatenate([g["x_grads"][k] for g in got], axis=1),
                   w, f"d{k}")
    else:
        for g in got:
            _close(g["out"], want_out, "out")
            for k, w in want_x.items():
                _close(g["x_grads"][k], w, f"d{k}")
    for k, (_, kind, groups) in case[3].items():
        _close(_whole([g["w_grads"][k] for g in got], kind, groups),
               want_w[k], f"d{k}")
    counts = got[0]["counts"]
    if name == "block":
        assert counts == {"all_reduce": 2, "all_gather": 0,
                          "reduce_scatter": 0, "all_to_all": 0,
                          "collective_permute": 0}
    if name == "block_sp":
        assert counts["all_reduce"] == 0
        assert counts["all_gather"] == 2 and counts["reduce_scatter"] == 2
    if name == "attn_two_heads" and world == 4:
        # 2 heads on 4 ranks: q, k and v gathered for the replicated core
        assert counts["all_gather"] == 3 and counts["all_reduce"] == 1


# -- (b) trajectories --------------------------------------------------------

STEPS = 3
SGD_LR = 0.1
BERT = dict(num_heads=4, num_partitions=4, learning_rate=1e-3)
NMT = dict(num_partitions=8, warmup_steps=1)
OPTS = ("own", "sgd")
# name: (family, config kwargs, num_partitions of the 4 ranks, feeds)
RUNS = {
    "bert_tp_1x4": ("bert", dict(tensor_parallel=True), 4, "repl"),
    "bert_tp_2x2": ("bert", dict(tensor_parallel=True), 2, "repl"),
    "bert_tp_sp_1x4": ("bert", dict(tensor_parallel=True,
                                    tp_sequence_parallel=True), 4, "repl"),
    "bert_hybrid_2x2": ("bert", {}, 2, "all"),
    "nmt_tp_2x2": ("nmt", dict(tensor_parallel=True), 2, "repl"),
}


def _bert_batches(cfg):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        b = jbert.make_batch(rng, 8, 32, 4, cfg.vocab_size)
        b["input_ids"][:, -3:] = 0
        b["input_ids"][1, 20:] = 0
        out.append(b)
    return out


def _nmt_batches(cfg):
    rng = np.random.default_rng(6)
    out = []
    for _ in range(STEPS):
        b = jnmt.make_batch(rng, 8, 10, 10, cfg.vocab_size)
        b["src"][1, 6:] = jnmt.PAD_ID
        b["src"][5, 3:] = jnmt.PAD_ID
        out.append(b)
    return out


def _jax_engine(model, shape, batches):
    """A JAX engine on the first devices of a ``shape`` mesh, its initial
    state and its initial parameters (numpy)."""
    mesh = jmesh.build_mesh(jax.devices()[:shape[0] * shape[1]],
                            shape=shape)
    eng = jengine.Engine(model, mesh, _jax_config(run_option="HYBRID"),
                         batches[0])
    state = eng.init_state(0)
    return eng, state, jax.tree.map(np.asarray, state.params)


def _jax_steps(eng, state, batches):
    """(losses, final params, wire bytes) of ``batches`` steps."""
    losses = []
    for b in batches:
        state, out = eng.step(state, b)
        losses.append(float(out["loss"]))
    return losses, _flat(state.params), eng.sparse_wire_bytes_per_step()


def _model_runs(tmp):
    """The ranks' runs and, meanwhile, their JAX oracles: each model's own
    optimizer against the JAX engine of the same model (tensor-parallel
    where the port's is) on the same mesh of 4 CPU devices, from that
    engine's initial parameters; SGD against the JAX data-parallel run
    on one device."""
    data = {"bert": _bert_batches(jbert.tiny_config(**BERT)),
            "nmt": _nmt_batches(jnmt.tiny_config(**NMT))}
    families = {"bert": (jbert, BERT), "nmt": (jnmt, NMT)}
    engines, runs = {}, []
    for name, (family, kw, parts, _) in RUNS.items():
        mod, base = families[family]
        model = mod.build_model(mod.tiny_config(compute_dtype=jnp.float32,
                                                **base, **kw))
        engines[name, "own"] = _jax_engine(model, (4 // parts, parts),
                                           data[family])
    for family, (mod, base) in families.items():
        model = mod.build_model(mod.tiny_config(compute_dtype=jnp.float32,
                                                **base))
        model.optimizer = optax.sgd(SGD_LR)
        engines[family, "sgd"] = _jax_engine(model, (1, 1), data[family])
    for name, (family, kw, parts, feed) in RUNS.items():
        base = families[family][1]
        for opt in OPTS:
            init = engines[name if opt == "own" else family, opt][2]
            runs.append((f"{name}/{opt}", family, {**base, **kw}, parts,
                         feed, SGD_LR if opt == "sgd" else None, init,
                         data[family]))
    handle = start_ranks(tmp, 4, "tp_models", deadline_s=300, runs=runs)
    oracle = {}
    for key, (eng, state, _) in engines.items():
        family = RUNS[key[0]][0] if key[0] in RUNS else key[0]
        oracle[key] = _jax_steps(eng, state, data[family])
    return oracle, join_ranks(handle)


@pytest.fixture(scope="module")
def model_runs(tmp_path_factory):
    return shared(tmp_path_factory, "tp_models", _model_runs)


def _bert_shapes(p):
    Dt, Mt = 32, 64
    return {"blocks/0/wqkv": (Dt, 3 * Dt // p), "blocks/0/wo": (Dt // p, Dt),
            "blocks/0/w1": (Dt, Mt // p), "blocks/0/w2": (Mt // p, Dt)}


def _nmt_shapes(p):
    Dt = 32
    return {"enc/0/attn/wq": (Dt, Dt // p), "enc/0/attn/wo": (Dt // p, Dt),
            "dec/0/cross/wv": (Dt, Dt // p)}


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("name", list(RUNS))
def test_trajectory_matches_jax(model_runs, name, opt):
    oracle, ranks = model_runs
    family, kw, parts, feed = RUNS[name]
    want_losses, want_params, want_wire = oracle[
        name if opt == "own" else family, opt]
    for k, r in enumerate(ranks):
        got = r[f"{name}/{opt}"]
        assert got["mesh"] == (4 // parts, parts, divmod(k, parts))
        _close(got["losses"], want_losses, "losses", rtol=1e-4, atol=0)
        assert set(got["params"]) == set(want_params)
        for path, w in want_params.items():
            peak = max(float(np.abs(w).max()), 1e-30)
            _close(got["params"][path], w, path, rtol=0, atol=1e-4 * peak)
        table = "word_emb" if family == "bert" else "emb"
        assert got["placements"][table] == "row_sharded"
        V = want_params[table].shape[0]
        assert got["local_shapes"][table][0] == V // parts
        if kw.get("tensor_parallel"):
            want = (_bert_shapes if family == "bert" else _nmt_shapes)(parts)
            for path, shape in want.items():
                assert got["local_shapes"][path] == shape, path
            assert got["placements"][next(iter(want))] == "tp_column"
        else:
            assert got["local_shapes"]["blocks/0/wqkv"] == (32, 96)
    # the lookups ship each id once (JAX's shard_map takes the ids over
    # ('repl', 'shard')): the wire bytes equal the JAX engine's on the
    # same mesh, whether the batch rides 'repl' alone or both axes
    rows = 8 * (32 if family == "bert" else 10)
    for r in ranks:
        wire = r[f"{name}/{opt}"]["wire"]
        assert all(w["ids_on_wire"] == rows for w in wire["per_lookup"])
        if opt == "own":
            assert wire["per_lookup"] == want_wire["per_lookup"]
            assert wire["sparse_path_bytes"] == \
                want_wire["sparse_path_bytes"]
            # the JAX classifier also finds NMT's sliced `pos` sparse and
            # counts its dense alternative (test_torch_nmt_train.py)
            assert wire["dense_allreduce_bytes"] == \
                want_wire["dense_allreduce_bytes"] - (
                    0 if family == "bert" else 16 * 32 * 4 * 2)
