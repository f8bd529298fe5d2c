"""The port's multi-rank engine against the JAX package's mesh.

The ranks are spawned processes in a gloo process group (a FileStore
under ``tmp_path``: no ports), one thread each, each with a deadline;
their bodies are in ``torch_dist_ranks.py``, which imports no JAX. Rank
``r * shard + s`` feeds the share of the batch that the JAX mesh gives
device ``(r, s)``. The JAX side runs in this process on the first
devices of the 8 emulated CPU devices: the same inputs, made from a
numpy seed, and the JAX initial parameters carried into the port. fp32
throughout; rtol 1e-5 / atol 1e-6, and 1e-4 for LM1B and NMT steps (as
``test_torch_train.py``).

(a) the sharded lookup, forward and table gradient, at meshes (1, 4) and
    (2, 2), over local aggregation, duplicate averaging, the sparse and
    dense cross-replica combine and a guarded ``dedup_capacity`` with one
    overflowing lookup; out-of-range ids included; the lookup records
    equal JAX's.
(b) the toy model of ``test_hybrid_e2e.py`` for 5 steps under AR, SHARD,
    HYBRID, HYBRID with ``replicate_variables=False``, HYBRID at
    ``num_partitions=3`` (snapped to a (2, 2) mesh) and HYBRID with a
    guarded ``dedup_capacity``: losses, metrics and the whole parameters
    after the steps; a row-sharded table read by another gather is
    refused at build.
(c) tiny LM1B, HYBRID slices, at (2, 2), 3 steps, with ``w`` sums that
    differ between ranks.
(d) tiny LM1B in dense mode with ``max_touched_rows`` at (1, 2), with
    overflowing steps counted as JAX counts them.
(e) ``sync=False`` at staleness 1 and 2.
(f) ``sparse_wire_bytes_per_step()`` against JAX's, integer for integer.
(g) tiny NMT, HYBRID, at (1, 2), 2 steps.
(h) the rank layout, ``shard()``, the resource grammar, and
    ``parallel_run``'s master path starting two CPU workers.
"""

import fcntl
import multiprocessing
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import parallax_tpu as jparallax
import torch_dist_ranks as bodies
from parallax_tpu.core import classify as jclassify
from parallax_tpu.core import engine as jengine
from parallax_tpu.core import mesh as jmesh
from parallax_tpu.models import lm1b as jlm1b
from parallax_tpu.models import nmt as jnmt
from parallax_tpu.ops import embedding as jemb
from parallax_tpu.ops import sampled_softmax as jss
from parallax_tpu_torch import shard as tshard
from parallax_tpu_torch.common import lib as tlib
from parallax_tpu_torch.core import mesh as tmesh

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6
DEADLINE_S = 90


def start_ranks(tmp_path, world, fn_name, deadline_s=DEADLINE_S,
                **kwargs):
    """Spawn ``world`` ranks running ``bodies.<fn_name>``; returns the
    handle ``join_ranks`` takes (the caller may work meanwhile)."""
    run_dir = Path(tmp_path) / f"{fn_name}_{time.monotonic_ns()}"
    run_dir.mkdir()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=bodies.run_rank,
                         args=(r, world, str(run_dir / "store"), fn_name,
                               kwargs, str(run_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    return (fn_name, procs, run_dir, deadline_s,
            time.monotonic() + deadline_s)


def join_ranks(handle):
    """The ranks' results in rank order. Fails on a rank's error or past
    the deadline."""
    fn_name, procs, run_dir, deadline_s, deadline = handle
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{fn_name}: ranks still running after {deadline_s}s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * len(procs), f"{fn_name}: rank exit codes {codes}"
    out = []
    for r in range(len(procs)):
        with open(run_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def run_ranks(tmp_path, world, fn_name, **kwargs):
    """Spawn ``world`` ranks running ``bodies.<fn_name>``; their results
    in rank order. Fails on a rank's error or past the deadline."""
    return join_ranks(start_ranks(tmp_path, world, fn_name, **kwargs))


def shared(tmp_path_factory, name, compute):
    """``compute()`` once per test session: the first pytest-xdist
    worker to ask computes it under a file lock and leaves the result
    for the others, so the ranks are spawned once however the workers
    split the tests."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent          # shared by this session's workers
    path = root / f"torch_dist_{name}.pkl"
    with open(root / f"torch_dist_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            out = compute(tmp_path_factory.mktemp(name))
            with open(path, "wb") as f:
                pickle.dump(out, f)
            return out
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _devices(shape):
    return jax.devices()[:shape[0] * shape[1]]


def _flat(tree):
    return {jclassify._pathname(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _params_close(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for path, w in want.items():
        _close(got[path], w, rtol, atol, path)


# -- (a) the sharded lookup ---------------------------------------------------

V_LOOKUP, D_LOOKUP = 8, 4
LOOKUP_CASES = {
    "raw": dict(local_aggregation=False),
    "dedup": dict(local_aggregation=True),
    "average": dict(average_duplicates=True),
    "average_raw": dict(average_duplicates=True, local_aggregation=False),
    "xrepl_sparse": dict(cross_replica_sparse=True),
    "xrepl_dense": dict(cross_replica_sparse=False,
                        average_duplicates=True),
    "guarded": dict(dedup_capacity=3),
}


def _lookup_inputs():
    """Per case, two lookups of 16 x 3 ids (12 a rank at 4 ranks) with
    out-of-range ids: the second of the guarded case has more than 3
    distinct ids on some rank, the first never does."""
    rng = np.random.default_rng(7)
    table = rng.standard_normal((V_LOOKUP, D_LOOKUP)).astype(np.float32)
    steps = []
    for i in range(2):
        ids = rng.integers(-1, V_LOOKUP + 2, size=(16, 3)).astype(np.int32)
        cot = rng.standard_normal((16, 3, D_LOOKUP)).astype(np.float32)
        steps.append((ids, cot))
    few = np.array([0, 5, -1], np.int32)[rng.integers(0, 3, (16, 3))]
    guarded = [(few, steps[0][1]), steps[1]]
    return table, {name: (guarded if name == "guarded" else steps)
                   for name in LOOKUP_CASES}


def _jax_lookup(shape, table, ids, cot, kw):
    mesh = jmesh.build_mesh(_devices(shape), shape=shape)
    records = []
    kw = dict(kw)
    avg = kw.pop("average_duplicates", False)
    with jemb.sharded_lookup_scope(mesh, [table.shape], avg,
                                   records=records, **kw):
        def f(t):
            rows = jemb.embedding_lookup(t, jnp.asarray(ids))
            return jnp.sum(rows * cot), rows

        (_, rows), grad = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jnp.asarray(table))
    return np.asarray(rows), np.asarray(grad), records


@pytest.fixture(scope="module")
def lookup_runs(tmp_path_factory):
    table, inputs = _lookup_inputs()
    cases = [(name, LOOKUP_CASES[name], inputs[name])
             for name in LOOKUP_CASES]
    ranks = shared(tmp_path_factory, "lookup", lambda tmp: run_ranks(
        tmp, 4, "lookup", shapes=[(1, 4), (2, 2)], table=table,
        cases=cases))
    return table, inputs, {shape: [r[shape] for r in ranks]
                           for shape in ((1, 4), (2, 2))}


@pytest.mark.parametrize("case", sorted(LOOKUP_CASES))
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_sharded_lookup_matches_jax(lookup_runs, shape, case):
    table, inputs, runs = lookup_runs
    ranks = runs[shape]
    p = shape[1]
    rows_here = V_LOOKUP // p
    for i, (ids, cot) in enumerate(inputs[case]):
        want_rows, want_grad, want_records = _jax_lookup(
            shape, table, ids, cot, LOOKUP_CASES[case])
        got_rows = np.concatenate([r[case][i]["rows"] for r in ranks])
        _close(got_rows, want_rows, what=f"{case} rows {i}")
        for r in ranks:
            _, s = r["coords"]
            _close(r[case][i]["grad"],
                   want_grad[s * rows_here:(s + 1) * rows_here],
                   what=f"{case} grad {i} at {r['coords']}")
            assert r[case][i]["records"] == want_records
            assert r[case][i]["guarded"] == (["emb"] if case == "guarded"
                                             else [])
    assert [r["coords"] for r in ranks] == [divmod(k, p) for k in range(4)]


def test_guarded_case_overflows_once():
    """The guarded case's first lookup fits the declared capacity on
    every rank and its second does not, so both branches ran."""
    _, inputs = _lookup_inputs()
    fits, over = inputs["guarded"]

    def worst(ids):
        return max(len(set(np.clip(ids[k * 4:(k + 1) * 4].ravel(), -1,
                                   V_LOOKUP)))
                   for k in range(4))

    assert worst(fits[0]) <= 3 < worst(over[0])


# -- (b), (e), (f): the toy model ---------------------------------------------

V, D, H, B = 32, 8, 4, 16


def _jax_toy_model(lr=0.1):
    def init_fn(rng):
        r1, r2 = jax.random.split(rng)
        return {"emb": jax.random.normal(r1, (V, D)) * 0.1,
                "proj": {"w": jax.random.normal(r2, (D, H)) * 0.1}}

    def loss_fn(params, batch):
        rows = jemb.embedding_lookup(params["emb"], batch["ids"])
        h = rows @ params["proj"]["w"]
        return jnp.mean((h - batch["y"]) ** 2), {"h_norm":
                                                 jnp.mean(h ** 2)}

    return jparallax.Model(init_fn, loss_fn, optimizer=optax.sgd(lr))


def _toy_batches(n):
    rng = np.random.default_rng(42)
    return [{"ids": rng.integers(0, V, size=(B,)).astype(np.int32),
             "y": rng.standard_normal((B, H)).astype(np.float32)}
            for _ in range(n)]


def _jax_engine_run(model, shape, config, batches, num_partitions=None):
    """(initial params, losses, metrics by step, final params, wire) of a
    JAX engine on the first devices."""
    n = shape[0] * shape[1]
    if num_partitions is None:
        mesh = jmesh.build_mesh(jax.devices()[:n], shape=shape)
    else:
        mesh = jmesh.build_mesh(jax.devices()[:n],
                                num_partitions=num_partitions)
    eng = jengine.Engine(model, mesh, config, batches[0])
    state = eng.init_state(0)
    init = jax.tree.map(np.asarray, state.params)
    outs = []
    for b in batches:
        state, out = eng.step(state, b)
        outs.append({k: np.asarray(v) for k, v in out.items()})
    return init, outs, _flat(state.params), \
        eng.sparse_wire_bytes_per_step()


def _jax_config(sync=True, **kw):
    ps = kw.pop("ps", None)
    cfg = jparallax.Config(search_partitions=False, **kw)
    cfg.set_sync(sync)
    for k, v in (ps or {}).items():
        setattr(cfg.communication_config.ps_config, k, v)
    return cfg


TOY_RUNS = {
    # name: (Config kwargs, num_partitions)
    "AR": (dict(run_option="AR"), None),
    "SHARD": (dict(run_option="SHARD"), None),
    "HYBRID": (dict(run_option="HYBRID"), None),
    "HYBRID_no_replicate": (dict(run_option="HYBRID",
                                 ps=dict(replicate_variables=False)),
                            None),
    "HYBRID_snapped_2x2": (dict(run_option="HYBRID"), 3),
    # 2 slots for 4 ids a rank: guarded, and most steps overflow
    "HYBRID_guarded": (dict(run_option="HYBRID",
                            ps=dict(dedup_capacity=2)), None),
}
TOY_STEPS = 5


def _toy_runs(tmp):
    batches = _toy_batches(TOY_STEPS)
    jax_out, runs = {}, []
    for name, (cfg_kw, parts) in TOY_RUNS.items():
        init, outs, final, wire = _jax_engine_run(
            _jax_toy_model(), (1, 4), _jax_config(**cfg_kw), batches,
            num_partitions=parts if parts else 4)
        jax_out[name] = (outs, final, wire)
        runs.append((name, cfg_kw,
                     {"num_partitions": parts} if parts else {}))
    return jax_out, run_ranks(tmp, 4, "toy", runs=runs, init=init,
                              batches=batches)


@pytest.fixture(scope="module")
def toy_runs(tmp_path_factory):
    return shared(tmp_path_factory, "toy", _toy_runs)


@pytest.mark.parametrize("name", list(TOY_RUNS))
def test_toy_model_matches_jax_session(toy_runs, name):
    jax_out, ranks = toy_runs
    outs, final, _ = jax_out[name]
    for r in ranks:
        got = r[name]
        _close(got["losses"], [float(o["loss"]) for o in outs])
        _close(got["h_norm"], [float(o["h_norm"]) for o in outs])
        _params_close(got["params"], final)
    assert [r[name]["returned"] for r in ranks] == \
        [(4, k, 1) for k in range(4)]
    placements = ranks[0][name]["placements"]
    want = {"AR": ("replicated", "replicated"),
            "SHARD": ("row_sharded", "row_sharded"),
            "HYBRID": ("row_sharded", "replicated"),
            "HYBRID_no_replicate": ("row_sharded", "row_sharded"),
            "HYBRID_snapped_2x2": ("row_sharded", "replicated"),
            "HYBRID_guarded": ("row_sharded", "replicated")}[name]
    assert (placements["emb"], placements["proj/w"]) == want
    # a guarded capacity reads its overflow flag on the host each step:
    # those steps run eagerly, and compile_stats says so
    eager = ranks[0][name]["eager_steps"]
    assert (eager is not None) == (name == "HYBRID_guarded")
    assert eager is None or "['emb']" in eager
    p = 2 if name == "HYBRID_snapped_2x2" else 4
    for k, r in enumerate(ranks):
        repl, shard, coords, row, col = r[name]["mesh"]
        assert (repl, shard, coords) == (4 // p, p, divmod(k, p))
        assert row == tuple(range(k - k % p, k - k % p + p))
        assert col == tuple(range(k % p, 4, p))
        shapes = r[name]["local_shapes"]
        assert shapes["emb"] == ((V // p, D) if want[0] == "row_sharded"
                                 else (V, D))
        assert shapes["proj/w"] == ((D // p, H) if want[1] == "row_sharded"
                                    else (D, H))


@pytest.mark.parametrize("name", list(TOY_RUNS))
def test_sparse_wire_bytes_equal_jax(toy_runs, name):
    jax_out, ranks = toy_runs
    want = jax_out[name][2]
    for r in ranks:
        got = r[name]["wire"]
        assert got["sparse_path_bytes"] == want["sparse_path_bytes"]
        assert got["dense_allreduce_bytes"] == want["dense_allreduce_bytes"]
        assert got["per_lookup"] == want["per_lookup"]
    if name != "AR":
        assert want["sparse_path_bytes"] > 0


def _async_runs(tmp):
    batches = _toy_batches(7)
    jax_out, runs = {}, []
    for k in (1, 2):
        init, outs, final, _ = _jax_engine_run(
            _jax_toy_model(), (1, 2),
            _jax_config(sync=False, run_option="HYBRID", staleness=k),
            batches)
        jax_out[k] = (outs, final)
        runs.append((f"k{k}", dict(run_option="HYBRID", staleness=k),
                     {"sync": False}))
    return jax_out, run_ranks(tmp, 2, "toy", runs=runs, init=init,
                              batches=batches)


@pytest.fixture(scope="module")
def async_runs(tmp_path_factory):
    return shared(tmp_path_factory, "async", _async_runs)


@pytest.mark.parametrize("k", [1, 2])
def test_sync_false_delayed_gradients_match_jax(async_runs, k):
    """``sync=False``: each step applies the gradients of ``k`` steps
    earlier, zeros for the first ``k`` (tests/test_hybrid_e2e.py:224-306,
    here against the JAX engine on 2 devices)."""
    jax_out, ranks = async_runs
    outs, final = jax_out[k]
    for r in ranks:
        _close(r[f"k{k}"]["losses"], [float(o["loss"]) for o in outs])
        _params_close(r[f"k{k}"]["params"], final)


# -- (c), (d): LM1B ----------------------------------------------------------

LM_STEPS = 3


def _lm1b_batches(vocab, world, unequal=True):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(LM_STEPS):
        b = jlm1b.make_batch(rng, 16, 6, vocab)
        if unequal:
            b["w"] = rng.uniform(0.25, 1.75, b["w"].shape).astype(
                np.float32)
            b["w"][:3] = 0.0          # rank 0 counts far fewer words
        out.append(b)
    return out


def _jax_candidates(cfg):
    base = jax.random.PRNGKey(1)
    return [np.asarray(jss.log_uniform_candidates(
        jax.random.split(jax.random.fold_in(base, step))[1],
        cfg.num_samples, cfg.vocab_size)) for step in range(LM_STEPS)]


def _lm1b_case(tmp_path, shape, cfg_kw, config_kw):
    world = shape[0] * shape[1]
    jcfg = jlm1b.tiny_config(compute_dtype=jnp.float32, **cfg_kw)
    batches = _lm1b_batches(jcfg.vocab_size, world)
    init, outs, final, wire = _jax_engine_run(
        jlm1b.build_model(jcfg), shape, _jax_config(**config_kw), batches)
    ranks = run_ranks(tmp_path, world, "lm1b", cfg_kw=cfg_kw,
                      config_kw=config_kw, shape=shape, init=init,
                      batches=batches, candidates=_jax_candidates(jcfg))
    return jcfg, batches, outs, final, wire, ranks


def test_lm1b_hybrid_slices_2x2_unequal_words(tmp_path):
    cfg_kw = dict(num_partitions=8, keep_prob=1.0, sparse_grad_mode="slices")
    config_kw = dict(run_option="HYBRID", sparse_grad_mode="slices")
    jcfg, batches, outs, final, wire, ranks = _lm1b_case(
        tmp_path, (2, 2), cfg_kw, config_kw)
    # the ranks' shares of w differ, so per-rank normalisation would not
    # give the global loss
    local = [r["local_words"][0] for r in ranks]
    assert len(set(local)) == 4
    for r in ranks:
        assert r["mesh"] == (2, 2)
        assert r["placements"]["emb"] == "row_sharded"
        assert r["placements"]["lstm/w"] == "replicated"
        _close(r["losses"], [float(o["loss"]) for o in outs], rtol=1e-4)
        _close(r["words"], [float(b["w"].sum()) for b in batches],
               rtol=1e-6)
        _params_close(r["params"], final, rtol=1e-4)
    # every lookup ships what the JAX one does: each rank looks up its
    # labels with its 1/n of the step's candidates, as each JAX device
    # takes a 1/n slice of the labels and candidates together
    got = ranks[0]["wire"]["per_lookup"]
    want = wire["per_lookup"]
    assert [g["table_shape"] for g in got] == \
        [w["table_shape"] for w in want]
    assert got == want
    assert ranks[0]["wire"]["sparse_path_bytes"] == \
        wire["sparse_path_bytes"]
    assert ranks[0]["wire"]["dense_allreduce_bytes"] == \
        wire["dense_allreduce_bytes"]


def test_lm1b_hybrid_slices_uneven_candidates(tmp_path):
    """S = 63 candidates over 2 ranks: each looks up 32, the last slice
    padded with an id no shard owns. The JAX lookup refuses ids that do
    not split over the mesh, so the reference is the JAX engine on one
    device, which no split touches: losses and parameters within 1e-4.
    The candidate lookups ship the labels and n ceil(S / n) ids."""
    cfg_kw = dict(num_partitions=8, keep_prob=1.0, sparse_grad_mode="slices",
                  num_samples=63)
    config_kw = dict(run_option="HYBRID", sparse_grad_mode="slices")
    jcfg = jlm1b.tiny_config(compute_dtype=jnp.float32, **cfg_kw)
    batches = _lm1b_batches(jcfg.vocab_size, 2)
    init, outs, final, _ = _jax_engine_run(
        jlm1b.build_model(jcfg), (1, 1), _jax_config(**config_kw), batches)
    ranks = run_ranks(tmp_path, 2, "lm1b", cfg_kw=cfg_kw,
                      config_kw=config_kw, shape=(1, 2), init=init,
                      batches=batches, candidates=_jax_candidates(jcfg))
    n, S, N = 2, 63, batches[0]["y"].size
    for r in ranks:
        assert r["placements"]["softmax_w"] == "row_sharded"
        _close(r["losses"], [float(o["loss"]) for o in outs], rtol=1e-4)
        _params_close(r["params"], final, rtol=1e-4)
    per_lookup = ranks[0]["wire"]["per_lookup"]
    assert per_lookup[0]["ids_on_wire"] == N
    assert len(per_lookup) == 3
    for g in per_lookup[1:]:
        assert g["ids_on_wire"] == N + n * -(-S // n)


def test_lm1b_dense_max_touched_rows_counts_overflow(tmp_path):
    cfg_kw = dict(num_partitions=8, keep_prob=1.0, max_touched_rows=48)
    config_kw = dict(run_option="HYBRID")
    jcfg, batches, outs, final, _, ranks = _lm1b_case(
        tmp_path, (1, 2), cfg_kw, config_kw)
    want = 0
    # the JAX optimizer state's overflow counters (row_sparse_adagrad)
    from parallax_tpu.ops import sparse_optim as jso
    model = jlm1b.build_model(jcfg)
    mesh = jmesh.build_mesh(_devices((1, 2)), shape=(1, 2))
    eng = jengine.Engine(model, mesh, _jax_config(**config_kw), batches[0])
    state = eng.init_state(0)
    for b in batches:
        state, _ = eng.step(state, b)
    want = jso.collect_overflow_steps(state.opt_state)
    assert want > 0
    for r in ranks:
        assert r["placements"]["emb"] == "row_sharded"
        assert r["overflow"] == want
        _close(r["losses"], [float(o["loss"]) for o in outs], rtol=1e-4)
        _params_close(r["params"], final, rtol=1e-4)


# -- (g): NMT ----------------------------------------------------------------


def test_nmt_hybrid_1x2(tmp_path):
    cfg_kw = dict(num_partitions=8, warmup_steps=1,
                  use_pallas_attention=False)
    jcfg = jnmt.tiny_config(compute_dtype=jnp.float32, **cfg_kw)
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(2):
        b = jnmt.make_batch(rng, 8, 12, 10, jcfg.vocab_size)
        b["src"][1, 7:] = jnmt.PAD_ID
        batches.append(b)
    init, outs, final, _ = _jax_engine_run(
        jnmt.build_model(jcfg), (1, 2), _jax_config(run_option="HYBRID"),
        batches)
    ranks = run_ranks(tmp_path, 2, "nmt", cfg_kw=cfg_kw, init=init,
                      batches=batches)
    for r in ranks:
        assert r["placements"]["emb"] == "row_sharded"
        _close(r["losses"], [float(o["loss"]) for o in outs], rtol=1e-4)
        _close(r["words"], [float(o["words"]) for o in outs])
        _params_close(r["params"], final, rtol=1e-4, atol=1e-6)


# -- (h): layout, shard(), resources, the launcher ---------------------------


def test_snap_and_resource_grammar():
    assert [tmesh.snap_to_divisor(p, 4) for p in (1, 2, 3, 4, 5, 0)] == \
        [1, 2, 2, 4, 4, 1]
    assert [tmesh.snap_to_divisor(p, 6) for p in (4, 5)] == [3, 3]
    for p in range(1, 9):
        assert tmesh.snap_to_divisor(p, 8) == jmesh.snap_to_divisor(p, 8)
    hosts = tlib.parse_resource_info("localhost: 0,1; 127.0.0.2:3")
    assert hosts == [tlib.HostInfo("localhost", (0, 1)),
                     tlib.HostInfo("127.0.0.2", (3,))]
    assert tlib.deserialize_resource_info(
        tlib.serialize_resource_info(hosts)) == hosts
    assert tlib.rank_layout(hosts) == [("localhost", 0), ("localhost", 1),
                                       ("127.0.0.2", 3)]
    assert tlib.rank_layout([tlib.HostInfo("localhost")], "cpu") == \
        [("localhost", 0)]
    with pytest.raises(NotImplementedError, match="remote hosts"):
        tlib.rank_layout(tlib.parse_resource_info("localhost:0;b:0"))
    with pytest.raises(ValueError, match="duplicate host"):
        tlib.parse_resource_info("a:0;a:1")
    # the pipe axis builds; pp = 1 is the two-axis mesh
    assert tmesh.build_mesh("cpu", shape=(1, 1, 1)).axis_names == \
        ("repl", "shard")
    with pytest.raises(ValueError, match="tile"):
        tmesh.build_mesh("cpu", shape=(1, 1, 2))
    with pytest.raises(ValueError, match="tile"):
        tmesh.build_mesh("cpu", shape=(2, 1))
    one = tmesh.build_mesh("cpu", num_partitions=4)
    assert (one.shape, one.coords, one.distributed) == \
        ({"repl": 1, "shard": 1}, (0, 0), False)


def test_shard_keeps_the_mod_filter():
    data = list(range(10))
    assert list(tshard.shard(data, 3, 1)) == [1, 4, 7]
    tshard._install(4, 2)
    try:
        assert tshard.create_num_shards_and_shard_id() == (4, 2)
        assert list(tshard.shard(data)) == [2, 6]
    finally:
        tshard._install(1, 0)
    with pytest.raises(ValueError):
        tshard._install(2, 2)


SCRIPT = '''
import json, os, sys
import numpy as np
import parallax_tpu_torch as pt
from parallax_tpu_torch import shard
from parallax_tpu_torch.models import simple

sess, world, rank, nrep = pt.parallel_run(
    simple.build_model(0.1), resource_info="localhost:0,1", device="cpu")
rng = np.random.default_rng(0)
batch = simple.make_batch(rng, 8)
mine = {k: v[rank * 4:(rank + 1) * 4] for k, v in batch.items()}
loss = float(sess.run("loss", feed_dict=mine))
out = {"world": world, "rank": rank, "nrep": nrep, "loss": loss,
       "shard": list(shard.shard(range(6))),
       "w": float(sess.state.params["w"][0])}
with open(os.path.join(sys.argv[1], f"out{rank}.json"), "w") as f:
    json.dump(out, f)
'''


def test_parallel_run_master_starts_the_workers(tmp_path):
    script = tmp_path / "train.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               PARALLAX_DIST_TIMEOUT="60")
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json
    outs = [json.loads((tmp_path / f"out{r}.json").read_text())
            for r in range(2)]
    assert [(o["world"], o["rank"], o["nrep"]) for o in outs] == \
        [(2, 0, 1), (2, 1, 1)]
    assert [o["shard"] for o in outs] == [[0, 2, 4], [1, 3, 5]]
    # one global loss and one replicated update on both ranks
    assert outs[0]["loss"] == outs[1]["loss"]
    assert outs[0]["w"] == outs[1]["w"]
    # a rank that fails makes the master exit non-zero
    bad = tmp_path / "bad.py"
    bad.write_text(SCRIPT.replace("loss = float(", "assert rank == 0\n"
                                  "loss = float("))
    proc = subprocess.run([sys.executable, str(bad), str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=DEADLINE_S)
    assert proc.returncode != 0


def test_row_sharded_table_read_outside_the_lookup_is_refused():
    """A rank holds only its rows of a row-sharded table: a loss that
    reads one through another gather is refused when the engine is
    built (on meta tensors, no process group needed)."""
    import torch

    import parallax_tpu_torch as pt
    from parallax_tpu_torch.core import engine as tengine

    good = bodies.toy_model()

    def loss_fn(params, batch):
        rows = torch.index_select(params["emb"], 0, batch["ids"].long())
        return ((rows @ params["proj"]["w"] - batch["y"]) ** 2).mean()

    bad = pt.Model(good.init_fn, loss_fn)
    batch = _toy_batches(1)[0]
    two = tmesh.Mesh(torch.device("cpu"), repl=1, shard=2)
    config = pt.Config(run_option="HYBRID")
    with pytest.raises(ValueError, match="other than through "
                                         "embedding_lookup.*emb"):
        tengine.Engine(bad, two, config, batch)
    eng = tengine.Engine(good, two, config, batch)
    assert eng.plan.sharded_tables == ["emb"] and eng._guarded == []
    # on one shard nothing is row-sharded, so nothing is checked
    one = tmesh.Mesh(torch.device("cpu"))
    assert tengine.Engine(bad, one, config, batch).plan.sharded_tables == []
