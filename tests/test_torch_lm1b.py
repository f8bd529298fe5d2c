"""The port's LM1B pieces against the JAX package's: the model's own
plain scan, sampled softmax and its grads, ``SliceAdagrad``, the dense
optimizer chain, the classifier and the parameter carry-over.

Inputs come from numpy seeds. Where the JAX function draws sampled-
softmax candidates from its threefry stream, the test draws them with
JAX and hands the same ids to the port's sampler (``monkeypatch``).
Tolerances: fp32 1e-5 relative (1e-4 on gradients, summed in another
order); bf16 compute 2e-2 of the JAX value's peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parallax_tpu.core import classify as jclassify
from parallax_tpu.models import lm1b as jlm1b
from parallax_tpu.ops import sampled_softmax as jss
from parallax_tpu.ops import sparse_optim as jso
from parallax_tpu_torch.core import classify as tclassify
from parallax_tpu_torch.core import optim as toptim
from parallax_tpu_torch.models import lm1b as tlm1b
from parallax_tpu_torch.ops import sampled_softmax as tss
from parallax_tpu_torch.ops import sparse_optim as tso
from parallax_tpu_torch.weights import lm1b_params_from_jax

TINY = dict(num_partitions=8, keep_prob=1.0)


def _cfgs(**kw):
    jdt = kw.pop("jdtype", jnp.float32)
    tdt = kw.pop("tdtype", torch.float32)
    return (jlm1b.tiny_config(**TINY, compute_dtype=jdt, **kw),
            tlm1b.tiny_config(**TINY, compute_dtype=tdt, **kw))


def _fixed_candidates(monkeypatch, ids_list):
    """The port's sampler returns the given id arrays in order (the meta
    pass of the classifier gets zeros and consumes none)."""
    it = iter(ids_list)

    def fake(gen, num_samples, vocab_size, device=None):
        if device is not None and torch.device(device).type == "meta":
            return torch.zeros((num_samples,), dtype=torch.long,
                               device="meta")
        ids = torch.tensor(np.asarray(next(it)), dtype=torch.long)
        assert ids.shape == (num_samples,)
        return ids.to(device)

    monkeypatch.setattr(tss, "log_uniform_candidates", fake)


def _jax_candidates(rng_key, cfg):
    _drop, samp = jax.random.split(rng_key)
    return np.asarray(jss.log_uniform_candidates(samp, cfg.num_samples,
                                                 cfg.vocab_size))


def _batch(cfg, B=8, T=5, seed=0):
    return jlm1b.make_batch(np.random.default_rng(seed), B, T,
                            cfg.vocab_size)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_model_loss_matches_jax_own_scan(monkeypatch, dtype):
    """``lstm_impl="scan"`` (this model's plain cell loop, carries at the
    compute dtype) against the JAX model's ``"xla"`` scan: the loss of
    one batch from one set of parameters and candidates."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jcfg, tcfg = _cfgs(jdtype=jdt, tdtype=tdt)
    jmodel = jlm1b.build_model(jcfg)
    jp = jmodel.init_fn(jax.random.PRNGKey(3))
    batch = _batch(jcfg)
    key = jax.random.PRNGKey(11)
    want, wm = jmodel.loss_fn(jp, jax.tree.map(jnp.asarray, batch), key)
    _fixed_candidates(monkeypatch, [_jax_candidates(key, jcfg)])
    tp = lm1b_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    got, tm = tlm1b.build_model(tcfg).loss_fn(tp, _torch_batch(batch),
                                              torch.Generator())
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.item(), float(want), rtol=tol)
    assert tm["words"].item() == float(wm["words"]) == 40


def test_kernel_and_scan_models_agree_fp32(monkeypatch):
    """In fp32 the kernel impl (fp32 carries) and the scan impl compute
    the same loss and the same gradients."""
    _, tcfg = _cfgs()
    kcfg = tlm1b.tiny_config(**TINY, compute_dtype=torch.float32,
                             lstm_impl="kernel")
    cand = np.random.default_rng(5).integers(0, 1000, (64,))
    _fixed_candidates(monkeypatch, [cand, cand])
    batch = _torch_batch(_batch(tcfg))
    out = []
    for cfg in (tcfg, kcfg):
        model = tlm1b.build_model(cfg)
        p = model.init_fn(torch.Generator().manual_seed(0), "cpu")
        w = p["lstm"]["w"].requires_grad_()
        loss, _ = model.loss_fn(p, batch, torch.Generator())
        out.append((loss.item(), torch.autograd.grad(loss, w)[0]))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    np.testing.assert_allclose(out[0][1].numpy(), out[1][1].numpy(),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("matmul_dtype", ["bf16", "fp32"])
def test_sampled_softmax_loss_and_grads_match_jax(monkeypatch,
                                                  matmul_dtype):
    """Per-example losses and the grads of hidden, softmax_w and
    softmax_b; accidental hits are planted (a label among the
    candidates). ``bf16`` is the default logits matmul, which rounds the
    operands even for fp32 callers."""
    rng = np.random.default_rng(0)
    V, Vp, D, N, S = 300, 304, 16, 12, 40
    sw = (rng.standard_normal((Vp, D)) * 0.3).astype(np.float32)
    sb = (rng.standard_normal((Vp, 1)) * 0.1).astype(np.float32)
    h = rng.standard_normal((N, D)).astype(np.float32)
    labels = rng.integers(0, V, (N,)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    samples = np.asarray(jss.log_uniform_candidates(key, S, V))
    labels[0] = samples[3]
    jmd, tmd = ((jnp.bfloat16, torch.bfloat16) if matmul_dtype == "bf16"
                else (None, None))

    def jloss(sw, sb, h):
        return jss.sampled_softmax_loss(sw, sb, h, jnp.asarray(labels), key,
                                        S, V, matmul_dtype=jmd)
    want = jloss(sw, sb, h)
    jg = jax.grad(lambda *a: jnp.sum(jloss(*a) * jnp.arange(N)),
                  argnums=(0, 1, 2))(sw, sb, h)
    _fixed_candidates(monkeypatch, [samples])
    targs = [torch.tensor(a, requires_grad=True) for a in (sw, sb, h)]
    got = tss.sampled_softmax_loss(*targs, torch.from_numpy(labels),
                                   torch.Generator(), S, V,
                                   matmul_dtype=tmd)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    tg = torch.autograd.grad((got * torch.arange(N)).sum(), targs)
    for g, w, name in zip(tg, jg, ("softmax_w", "softmax_b", "hidden")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_full_softmax_loss_matches_jax():
    rng = np.random.default_rng(1)
    V, Vp, D, N = 50, 56, 8, 10
    sw = rng.standard_normal((Vp, D)).astype(np.float32)
    sb = rng.standard_normal((Vp, 1)).astype(np.float32)
    h = rng.standard_normal((N, D)).astype(np.float32)
    y = rng.integers(0, V, (N,)).astype(np.int32)
    want = jss.full_softmax_loss(sw, sb, h, y, V)
    got = tss.full_softmax_loss(*(torch.from_numpy(a)
                                  for a in (sw, sb, h, y)), V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_log_uniform_sampler_law():
    """The port's own sampler: ids in range, and the head of the
    distribution where the log-uniform law puts it."""
    gen = torch.Generator().manual_seed(0)
    ids = tss.log_uniform_candidates(gen, 200000, 1000)
    assert ids.dtype == torch.long
    assert 0 <= ids.min().item() and ids.max().item() < 1000
    p0 = tss.log_uniform_prob(torch.tensor([0]), 1000).item()
    assert abs((ids == 0).float().mean().item() - p0) < 0.01
    probs = tss.log_uniform_prob(torch.arange(1000), 1000)
    np.testing.assert_allclose(probs.sum().item(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("average", [False, True])
def test_slice_adagrad_matches_jax(average):
    """Duplicate ids combine before squaring; ids outside [0, V) drop."""
    rng = np.random.default_rng(2)
    V, D = 20, 6
    param = rng.standard_normal((V, D)).astype(np.float32)
    ids = np.array([3, 7, 3, -1, 19, 20, 7, 3, 0, 25], np.int32)
    drows = rng.standard_normal((len(ids), D)).astype(np.float32)
    jup = jso.SliceAdagrad(0.2, initial_accumulator_value=1.0)
    jp, ja = jup.update(jnp.asarray(param), jup.init(jnp.asarray(param)),
                        jnp.asarray(ids), jnp.asarray(drows), average=average)
    jp, ja = jup.update(jp, ja, jnp.asarray(ids[::-1].copy()),
                        jnp.asarray(drows), average=average)
    tup = tso.SliceAdagrad(0.2, initial_accumulator_value=1.0)
    tp = torch.from_numpy(param.copy())
    ta = tup.init(tp)
    tup.update(tp, ta, torch.from_numpy(ids), torch.from_numpy(drows),
               average=average)
    tup.update(tp, ta, torch.from_numpy(ids[::-1].copy()),
               torch.from_numpy(drows), average=average)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    untouched = [r for r in range(V) if r not in (0, 3, 7, 19)]
    np.testing.assert_array_equal(tp.numpy()[untouched], param[untouched])
    assert ta.dtype == torch.float32


def test_dense_chain_matches_optax():
    """clip_by_global_norm + Adagrad to optax's formulas, with the norm
    above and below the clip, over three updates."""
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
    jtx = optax.chain(optax.clip_by_global_norm(2.0),
                      optax.adagrad(0.3, initial_accumulator_value=1.0))
    ttx = toptim.chain(toptim.clip_by_global_norm(2.0),
                       toptim.adagrad(0.3, initial_accumulator_value=1.0))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for scale in (5.0, 0.1, 3.0):
        g = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
             for k, v in params.items()}
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts)
        toptim.apply_updates(tp, tu)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


def test_classifier_matches_jax_on_tiny_config():
    """Same sparse set as the JAX classifier: the three tables."""
    jcfg, tcfg = _cfgs()
    jmodel = jlm1b.build_model(jcfg)
    batch = _batch(jcfg)
    shapes = jax.eval_shape(jmodel.init_fn, jax.random.PRNGKey(0))
    jspecs = jclassify.classify_params(
        lambda p, b, r: jmodel.loss_fn(p, b, r)[0], shapes,
        jax.tree.map(jnp.asarray, batch),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    tmodel = tlm1b.build_model(tcfg)
    tspecs = tclassify.classify_params(
        tmodel.call_loss, tmodel.init_fn(torch.Generator(), "meta"),
        {k: v.to("meta") for k, v in _torch_batch(batch).items()},
        torch.Generator())
    jsparse = {p for p, s in jspecs.items() if s.is_sparse}
    tsparse = {p for p, s in tspecs.items() if s.is_sparse}
    assert tsparse == jsparse == {"emb", "softmax_w", "softmax_b"}
    assert set(tspecs) == set(jspecs)
    for p, s in tspecs.items():
        assert s.shape == tuple(jspecs[p].shape), p


def test_classifier_rules_and_overrides():
    """A gathered-and-dense-used table is dense; an index gather counts;
    the overrides win."""
    def loss(p, b, gen):
        rows = torch.nn.functional.embedding(b["ids"], p["both"])
        return (rows.sum() + p["both"].sum() + p["idx"][b["ids"]].sum()
                + p["w"].to(torch.bfloat16).float().sum())
    params = {k: torch.empty((10, 3), device="meta")
              for k in ("both", "idx", "w")}
    batch = {"ids": torch.zeros((4,), dtype=torch.long, device="meta")}
    specs = tclassify.classify_params(loss, params, batch, None)
    assert not specs["both"].is_sparse
    assert specs["both"].reason == "gathered but also used densely"
    assert specs["idx"].is_sparse and not specs["w"].is_sparse
    specs = tclassify.classify_params(loss, params, batch, None,
                                      sparse_override=("w",),
                                      dense_override=("idx",))
    assert specs["w"].is_sparse and not specs["idx"].is_sparse


def test_params_from_jax_and_padding_match():
    """The same LM1BConfig builds the same table shapes in both packages
    (vocab padding included), and the JAX tree carries across leaf for
    leaf."""
    for parts in (1, 8, 7):
        j = jlm1b.tiny_config(num_partitions=parts, vocab_size=1001)
        t = tlm1b.tiny_config(num_partitions=parts, vocab_size=1001)
        assert t.padded_vocab == j.padded_vocab
    jcfg, tcfg = _cfgs()
    jp = jlm1b.build_model(jcfg).init_fn(jax.random.PRNGKey(0))
    tp = lm1b_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jflat = {jclassify._pathname(k): np.asarray(v)
             for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = dict(tclassify.flatten(tp))
    assert set(jflat) == set(tflat)
    for path, v in jflat.items():
        np.testing.assert_array_equal(tflat[path].numpy(), v)
    meta = tlm1b.init_params(tcfg, torch.Generator(), "meta")
    assert {p: tuple(t.shape) for p, t in tclassify.flatten(meta)} == \
        {p: v.shape for p, v in jflat.items()}
    bad = dict(jax.tree.map(np.asarray, jp))
    bad["emb"] = bad["emb"][:-1]
    with pytest.raises(ValueError, match="emb has shape"):
        lm1b_params_from_jax(bad, tcfg, "cpu")


def test_config_validation():
    with pytest.raises(ValueError, match="lstm_impl"):
        tlm1b.LM1BConfig(lstm_impl="pallas")
    # max_touched_rows builds: row_sparse_adagrad for the two tables
    model = tlm1b.build_model(tlm1b.tiny_config(max_touched_rows=128))
    state = model.optimizer.init({"emb": torch.zeros(4, 2),
                                  "softmax_w": torch.zeros(4, 2),
                                  "lstm/w": torch.zeros(3)})
    assert sorted(state[1]) == ["rest", "table"]
    assert sorted(state[1]["table"].sum_of_squares) == ["emb", "softmax_w"]
    # the full-softmax baseline builds (tests/test_torch_lm1b_full.py):
    # dense Adagrad, no slice updaters
    full = tlm1b.build_model(tlm1b.tiny_config(sparse_grad_mode="slices",
                                               max_touched_rows=128),
                             full_softmax=True)
    assert not full.slice_updaters
    state = full.optimizer.init({"emb": torch.zeros(4, 2),
                                 "softmax_w": torch.zeros(4, 2)})
    assert sorted(state[1][0]) == ["emb", "softmax_w"]
