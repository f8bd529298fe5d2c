"""The port's CNN slice against the JAX package's, on the CPU in fp32.

* SAME padding: flax pads a stride-2 3x3 window on an even map (0, 1),
  not (1, 1); conv, max-pool and average pool (which counts the padded
  zeros) each against flax, exact or to 1e-5.
* BatchNorm: ``y`` and the new running statistics against
  ``nn.BatchNorm`` (biased batch variance, ``0.9 * ra + 0.1 * stat``),
  at B 2 on a 1x1 map, where an unbiased variance would be twice as
  large; the statistics to 1e-6, y to 1e-4 of flax (whose fp32
  E[x^2] - E[x]^2 loses digits) and to 1e-5 of the exact normalisation.
* A small ResNet (``stage_sizes=[1, 1, 1, 1]``, 8 filters, 10 classes,
  fp32, 32 px, batch 8) carried over by ``cnn_params_from_jax``: loss,
  every gradient and the new ``batch_stats`` against ``jax.value_and_grad``
  of the JAX ``loss_fn``, each leaf to 1e-4 of its peak; then three
  ``sess.run`` steps through both packages' ``parallel_run(Config(
  run_option="AR"))`` (the JAX session splits the batch over the
  conftest's 8 CPU devices, and its BatchNorm still reduces over the
  global batch): losses to 1e-4 relative, final params, momentum and
  ``model_state`` to 1e-4 of each leaf's peak.
* The zoo: all 14 registry names build on meta tensors and give
  [2, num_classes]; ResNet-50 has 25.4-25.7 M parameters; a forward at
  fp32, batch 2, of LeNet, VGG-11, GoogLeNet, Inception-v3 and
  DenseNet-121 against JAX at small image sizes (``ZOO`` says why each),
  logits and new statistics to 1e-4 of their peak (Inception-v3 1e-3).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import parallax_tpu as jparallax
import parallax_tpu_torch as tparallax
from parallax_tpu.core import classify as jclassify
from parallax_tpu.models import cnn as jcnn
from parallax_tpu.models import cnn_zoo as jzoo
from parallax_tpu.models import resnet as jresnet
from parallax_tpu_torch.core import classify as tclassify
from parallax_tpu_torch.core.engine import Model
from parallax_tpu_torch.models import _nn
from parallax_tpu_torch.models import cnn as tcnn
from parallax_tpu_torch.models import cnn_zoo as tzoo
from parallax_tpu_torch.models import resnet as tresnet
from parallax_tpu_torch.ops.sparse_optim import SliceAdagrad
from parallax_tpu_torch.weights import cnn_params_from_jax

TINY = "tiny_resnet"
TINY_KW = dict(stage_sizes=[1, 1, 1, 1], num_filters=8)
SIZE, BATCH, CLASSES = 32, 8, 10


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close_to_peak(got, want, rel, what):
    want = np.asarray(want)
    atol = rel * float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol,
                               err_msg=what)


def _paths(tree):
    return {jclassify._pathname(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as_jax_layout(t):
    """A port leaf in the flax layout: OIHW conv kernels back to HWIO."""
    a = t.detach().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


# -- SAME padding -------------------------------------------------------------


@pytest.mark.parametrize("size", [8, 7], ids=["even", "odd"])
@pytest.mark.parametrize("op", ["conv_s2", "max_pool_s2", "avg_pool_s1",
                                "avg_pool_s2"])
def test_same_padding_matches_flax(op, size):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    if op == "conv_s2":
        mod = nn.Conv(4, (3, 3), strides=(2, 2), dtype=jnp.float32)
        v = mod.init(jax.random.PRNGKey(0), x)
        want = np.asarray(mod.apply(v, x))
        w = torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(
            3, 2, 0, 1).copy())
        b = torch.from_numpy(np.array(v["params"]["bias"]))
        got = _nhwc(_nn.conv(_nchw(x), w, b, (2, 2), "SAME"))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        if size % 2 == 0:       # nn.Conv2d's symmetric padding differs
            sym = _nhwc(F.conv2d(_nchw(x), w, b, 2, 1))
            assert sym.shape == want.shape
            assert not np.allclose(sym, want, atol=1e-3)
        return
    if op == "max_pool_s2":
        want = np.asarray(nn.max_pool(x, (3, 3), strides=(2, 2),
                                      padding="SAME"))
        got = _nhwc(_nn.max_pool(_nchw(x), (3, 3), (2, 2), "SAME"))
        np.testing.assert_array_equal(got, want)
        return
    stride = 1 if op == "avg_pool_s1" else 2
    want = np.asarray(nn.avg_pool(x, (3, 3), strides=(stride, stride),
                                  padding="SAME"))
    got = _nhwc(_nn.avg_pool(_nchw(x), (3, 3), (stride, stride), "SAME"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_pads_follow_flax():
    assert _nn.pads("SAME", (56, 56), (3, 3), (2, 2)) == [(0, 1), (0, 1)]
    assert _nn.pads("SAME", (224, 224), (7, 7), (2, 2)) == [(2, 3), (2, 3)]
    assert _nn.pads("SAME", (56, 56), (1, 1), (2, 2)) == [(0, 0), (0, 0)]
    assert _nn.pads("SAME", (17, 17), (1, 7), (1, 1)) == [(0, 0), (3, 3)]
    assert _nn.pads("VALID", (9, 9), (3, 3), (1, 1)) == [(0, 0), (0, 0)]
    assert _nn.pads([(3, 3), (3, 3)], (9, 9), (7, 7), (2, 2)) == \
        [(3, 3), (3, 3)]
    with pytest.raises(ValueError, match="CIRCULAR"):
        _nn.pads("CIRCULAR", (9, 9), (3, 3), (1, 1))


# -- BatchNorm ----------------------------------------------------------------


@pytest.mark.parametrize("shape,eps,train", [
    ((2, 1, 1, 6), 1e-5, True),       # B 2 on 1x1: unbiased would be 2x
    ((4, 3, 3, 6), 1e-3, True),       # ConvBN's epsilon
    ((1, 1, 1, 6), 1e-5, True),       # one value per channel
    ((2, 3, 3, 6), 1e-5, False),      # running statistics
], ids=["b2_1x1", "b4_3x3_eps1e-3", "b1_1x1", "eval"])
def test_batch_norm_matches_flax(shape, eps, train):
    rng = np.random.default_rng(1)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    mean = rng.standard_normal(c).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    mod = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=eps, dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want_y, upd = mod.apply(variables, x, mutable=["batch_stats"])
    want = upd["batch_stats"]
    t = {k: torch.from_numpy(v) for k, v in
         dict(scale=scale, bias=bias, mean=mean, var=var).items()}
    y, new_mean, new_var = _nn.batch_norm(
        _nchw(x), t["scale"], t["bias"], t["mean"], t["var"], train, 0.9,
        eps)
    # flax's variance is E[x^2] - E[x]^2 in fp32, which loses digits where
    # the spread is small against the mean (here 6e-5 off in y at the
    # channel of variance 2.6e-3); the port's y is held to the exact
    # (fp64) normalisation at 1e-5, and to flax at 1e-4
    x64 = x.astype(np.float64)
    if train:
        m, v = x64.mean((0, 1, 2)), x64.var((0, 1, 2))
    else:
        m, v = mean.astype(np.float64), var.astype(np.float64)
    exact = (x64 - m) / np.sqrt(v + eps) * scale + bias
    np.testing.assert_allclose(_nhwc(y), exact, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_nhwc(y), np.asarray(want_y), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(new_mean.numpy(), np.asarray(want["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(new_var.numpy(), np.asarray(want["var"]),
                               rtol=1e-6, atol=1e-6)
    # the inputs are left as they were
    np.testing.assert_array_equal(t["mean"].numpy(), mean)
    np.testing.assert_array_equal(t["var"].numpy(), var)


def test_batch_norm_gradients_match_flax():
    """Gradients of a weighted sum of y for x, scale and bias, at B 2 on
    a 1x1 map and at B 1 (no gradient for x and scale)."""
    rng = np.random.default_rng(2)
    for shape in ((2, 1, 1, 5), (1, 1, 1, 5)):
        x = rng.standard_normal(shape).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
        bias = rng.standard_normal(5).astype(np.float32)
        dy = rng.standard_normal(shape).astype(np.float32)
        stats = {"mean": np.zeros(5, np.float32),
                 "var": np.ones(5, np.float32)}
        mod = nn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5, dtype=jnp.float32)

        def f(x, s, b):
            y, _ = mod.apply({"params": {"scale": s, "bias": b},
                              "batch_stats": stats}, x,
                             mutable=["batch_stats"])
            return jnp.sum(y * dy)

        want = jax.grad(f, argnums=(0, 1, 2))(x, scale, bias)
        tx = _nchw(x).clone().requires_grad_(True)
        ts = torch.from_numpy(scale).requires_grad_(True)
        tb = torch.from_numpy(bias).requires_grad_(True)
        y, _, _ = _nn.batch_norm(tx, ts, tb, torch.zeros(5), torch.ones(5),
                                 True, 0.9, 1e-5)
        got = torch.autograd.grad((y * _nchw(dy)).sum(), (tx, ts, tb))
        np.testing.assert_allclose(_nhwc(got[0]), np.asarray(want[0]),
                                   rtol=0, atol=1e-4)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-4)


# -- the small ResNet ------------------------------------------------------------


@pytest.fixture
def tiny(monkeypatch):
    """A ``tiny_resnet`` registry entry in both packages."""
    monkeypatch.setitem(jcnn.MODEL_REGISTRY, TINY, (
        lambda **kw: jresnet.ResNet(**TINY_KW, dtype=jnp.float32, **kw),
        SIZE))
    monkeypatch.setitem(tcnn.MODEL_REGISTRY, TINY, (
        lambda **kw: tresnet.ResNet(**TINY_KW, dtype=torch.float32, **kw),
        SIZE))


def _batches(n):
    rng = np.random.default_rng(0)
    return [jcnn.make_batch(rng, BATCH, SIZE, CLASSES) for _ in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _relu_margins(monkeypatch):
    """Records the smallest |pre-activation| of every ``relu_`` on real
    tensors."""
    seen = []
    relu_ = torch.Tensor.relu_

    def recording(t):
        if t.device.type != "meta":
            seen.append(float(t.detach().abs().min()))
        return relu_(t)

    monkeypatch.setattr(torch.Tensor, "relu_", recording)
    return seen


def test_tiny_resnet_loss_grads_and_stats_match_jax(tiny, monkeypatch):
    jmodel = jcnn.build_model(TINY, num_classes=CLASSES, image_size=SIZE)
    jparams, jstate = jax.jit(jmodel.init_fn)(jax.random.PRNGKey(0))
    # every BatchNorm scale and statistic drawn at random: the zero scale
    # of each block's last BatchNorm would zero the block's gradients
    rng = np.random.default_rng(4)

    def draw(path, a):
        name = jclassify._pathname(path)
        if name.endswith(("scale", "var")):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name.endswith("mean"):
            return rng.standard_normal(a.shape).astype(np.float32)
        return np.asarray(a)

    np_vars = {"params": jax.tree_util.tree_map_with_path(draw, jparams),
               "batch_stats": jax.tree_util.tree_map_with_path(
                   draw, jstate["batch_stats"])}
    batch = _batches(1)[0]

    def f(p):
        loss, metrics, new = jmodel.loss_fn(
            p, {"batch_stats": np_vars["batch_stats"]},
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(1))
        return loss, (metrics, new)

    (jloss, (jmetrics, jnew)), jgrads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(np_vars["params"])

    tmodel = tcnn.build_model(TINY, num_classes=CLASSES, image_size=SIZE)
    assert tmodel.stateful
    params, state = cnn_params_from_jax(np_vars, TINY, CLASSES, SIZE,
                                        device="cpu")
    flat = tclassify.flatten(params)
    for _, leaf in flat:
        leaf.requires_grad_(True)
    margins = _relu_margins(monkeypatch)
    loss, metrics, new = tmodel.call_loss(params, _torch_batch(batch),
                                          torch.Generator(), state)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in flat])
    # the comparison holds away from the ReLU kinks: the two fp32 programs'
    # pre-activations differ by up to about 5e-6, and one that close to 0
    # takes the other branch in one of them and moves every earlier
    # gradient by up to 7e-2 of its peak (a batch of seed 3 did)
    assert min(margins) > 5e-6, min(margins)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(metrics["accuracy"]) == float(jmetrics["accuracy"])
    want = _paths(jgrads)
    assert set(want) == {p for p, _ in flat}
    for (path, _), g in zip(flat, grads):
        assert float(np.abs(want[path]).max()) > 0, path
        _close_to_peak(_as_jax_layout(g), want[path], 1e-4, path)
    want = _paths(jnew)
    got = dict(tclassify.flatten(new))
    assert set(got) == set(want)
    for path, w in want.items():
        assert not got[path].requires_grad
        _close_to_peak(got[path].numpy(), w, 1e-4, path)
    # the statistics passed in are left as they were
    for path, t in tclassify.flatten(state):
        np.testing.assert_array_equal(
            t.numpy(), _paths({"batch_stats": np_vars["batch_stats"]})[path])


def _jax_config():
    return jparallax.Config(run_option="AR", search_partitions=False)


def test_tiny_resnet_three_session_steps_match_jax(tiny):
    batches = _batches(3)
    jsess, *_ = jparallax.parallel_run(
        jcnn.build_model(TINY, num_classes=CLASSES, image_size=SIZE),
        parallax_config=_jax_config(), seed=0)
    try:
        jsess.prepare(batches[0])
        init = {"params": jax.tree.map(np.asarray, jsess.state.params),
                "batch_stats": jax.tree.map(
                    np.asarray, jsess.state.model_state["batch_stats"])}
        jlosses, jacc = [], []
        for b in batches:
            loss, acc = jsess.run(["loss", "accuracy"], feed_dict=b)
            jlosses.append(float(loss))
            jacc.append(float(acc))
        jparams = _paths(jsess.state.params)
        jstats = _paths(jsess.state.model_state)
        jtrace = _paths(jsess.state.opt_state[1][0].trace)
    finally:
        jsess.close()

    tsess, *rest = tparallax.parallel_run(
        tcnn.build_model(TINY, num_classes=CLASSES, image_size=SIZE),
        parallax_config=tparallax.Config(run_option="AR"), device="cpu")
    assert rest == [1, 0, 1]
    tsess.prepare(batches[0])
    params, state = cnn_params_from_jax(init, TINY, CLASSES, SIZE, "cpu")
    with torch.no_grad():
        for (path, leaf), (_, new) in zip(
                tclassify.flatten(tsess.state.params),
                tclassify.flatten(params)):
            leaf.copy_(new)
        for (path, leaf), (_, new) in zip(
                tclassify.flatten(tsess.state.model_state),
                tclassify.flatten(state)):
            leaf.copy_(new)
    assert all(not s.is_sparse
               for s in tsess.engine.plan.var_specs.values())
    assert set(tsess.engine.plan.var_specs) == set(jparams)
    out = [tsess.run(["loss", "accuracy", "global_step"], feed_dict=b)
           for b in batches]
    np.testing.assert_allclose([float(o[0]) for o in out], jlosses,
                               rtol=1e-4)
    assert [float(o[1]) for o in out] == jacc
    assert [int(o[2]) for o in out] == [1, 2, 3]
    tparams = dict(tclassify.flatten(tsess.state.params))
    assert set(tparams) == set(jparams)
    for path, want in jparams.items():
        _close_to_peak(_as_jax_layout(tparams[path]), want, 1e-4, path)
    tstats = dict(tclassify.flatten(tsess.state.model_state))
    assert set(tstats) == set(jstats)
    for path, want in jstats.items():
        _close_to_peak(tstats[path].numpy(), want, 1e-4, path)
    # the momentum: chain(add_decayed_weights, sgd) -> (state, (trace, lr))
    ttrace = tsess.state.opt_state[1][0]
    for path, want in jtrace.items():
        _close_to_peak(_as_jax_layout(ttrace[path]), want, 1e-4, path)
    tsess.close()


def test_tiny_resnet_session_state_only_params_get_gradients(tiny):
    batches = _batches(2)
    sess, *_ = tparallax.parallel_run(
        tcnn.build_model(TINY, num_classes=CLASSES, image_size=SIZE),
        parallax_config=tparallax.Config(run_option="AR"), device="cpu")
    sess.prepare(batches[0])
    # the classifier's forward took the state as input: only params are
    # classified, and every one is dense and replicated
    plan = sess.engine.plan
    assert set(plan.var_specs) == {p for p, _ in
                                   tclassify.flatten(sess.state.params)}
    assert set(plan.placements.values()) == {"replicated"}
    before = {p: t.clone() for p, t in
              tclassify.flatten(sess.state.model_state)}
    assert all(p.startswith("batch_stats/") for p in before)
    sess.run("loss", feed_dict=batches[0])
    after = dict(tclassify.flatten(sess.state.model_state))
    assert set(after) == set(before)
    assert all(not t.requires_grad for t in after.values())
    assert all(not torch.equal(after[p], before[p]) for p in before)
    # evaluate reads the state and leaves it (and the step) as it was
    held = sess.evaluate(batches[1], fetches=["loss", "accuracy"])
    assert np.isfinite(float(held[0])) and 0 <= float(held[1]) <= 1
    assert sess.state.step == 1
    for p, t in tclassify.flatten(sess.state.model_state):
        assert torch.equal(t, after[p])
    sess.close()


def test_weight_decay_takes_the_kernels_of_more_than_one_dim(tiny):
    """The ndim > 1 mask on the port's OIHW tree picks the conv and dense
    kernels, as on the flax tree, and no BatchNorm leaf or bias."""
    model = tcnn.build_model(TINY, num_classes=CLASSES, image_size=SIZE,
                             learning_rate=1.0, momentum=0.9,
                             weight_decay=0.5)
    params, _ = model.call_init(torch.Generator().manual_seed(0), "cpu")
    flat = dict(tclassify.flatten(params))
    zero = {p: torch.zeros_like(t) for p, t in flat.items()}
    upd, _ = model.optimizer.update(zero, model.optimizer.init(flat), flat)
    decayed = {p for p, u in upd.items() if bool(u.abs().sum() > 0)}
    assert decayed == {p for p, t in flat.items() if t.dim() > 1}
    assert any(p.endswith("Dense_0/kernel") for p in decayed)
    for p in decayed:
        torch.testing.assert_close(upd[p], -0.5 * flat[p])


def test_cnn_params_from_jax_refuses_trees_that_do_not_fit(tiny):
    jmodule = jcnn.MODEL_REGISTRY[TINY][0](num_classes=CLASSES)
    shapes = jax.eval_shape(lambda r: jmodule.init(
        r, jnp.zeros((1, SIZE, SIZE, 3)), train=True), jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    np_vars = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)
    params, state = cnn_params_from_jax(np_vars, TINY, CLASSES, SIZE, "cpu")
    kernel = params["conv_init"]["kernel"]
    assert kernel.shape == (8, 3, 7, 7)
    assert kernel.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(
        kernel.numpy(), np_vars["params"]["conv_init"]["kernel"].transpose(
            3, 2, 0, 1))
    extra = {**np_vars, "params": {**np_vars["params"],
                                   "Dense_1": {"bias": np.zeros(3)}}}
    with pytest.raises(ValueError, match="does not have.*Dense_1"):
        cnn_params_from_jax(extra, TINY, CLASSES, SIZE, "cpu")
    missing = {**np_vars, "params": {k: v for k, v in
                                     np_vars["params"].items()
                                     if k != "bn_init"}}
    with pytest.raises(ValueError, match="no params/bn_init"):
        cnn_params_from_jax(missing, TINY, CLASSES, SIZE, "cpu")
    with pytest.raises(ValueError, match="shape"):
        cnn_params_from_jax(np_vars, TINY, CLASSES + 1, SIZE, "cpu")


def test_float64_resnet_computes_in_float64():
    """A float64 module keeps float64 through its head and loss (the
    bf16 and fp32 modules' heads are fp32, as flax's are)."""
    model = tcnn.module_model(tresnet.ResNet(
        stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=CLASSES,
        dtype=torch.float64), SIZE)
    params, state = model.call_init(torch.Generator().manual_seed(0), "cpu")
    params = jax.tree.map(torch.Tensor.double, params)
    state = jax.tree.map(torch.Tensor.double, state)
    batch = _torch_batch(_batches(1)[0])
    batch["images"] = batch["images"].double()
    loss, _, new = model.call_loss(params, batch, torch.Generator(), state)
    assert loss.dtype == torch.float64
    assert all(t.dtype == torch.float64
               for _, t in tclassify.flatten(new))
    assert _nn.head_dtype(torch.bfloat16) == torch.float32


def test_stateful_model_refuses_slice_updaters():
    with pytest.raises(ValueError, match="stateless"):
        Model(lambda gen, device: ({}, {}), lambda p, s, b, g: None,
              stateful=True, slice_updaters={"emb": SliceAdagrad(0.1)})


def test_lenet_trains_without_state():
    """The stateless path: LeNet has no BatchNorm, so its Model is not
    stateful and the session trains it (class-conditional mean shift,
    so SGD learns fast)."""
    model = tcnn.build_model("lenet", num_classes=10, image_size=28,
                             learning_rate=0.02)
    assert not model.stateful
    sess, *_ = tparallax.parallel_run(
        model, parallax_config=tparallax.Config(run_option="AR"),
        device="cpu")
    rng = np.random.default_rng(42)
    batches = []
    for _ in range(2):
        b = tcnn.make_batch(rng, 16, 28, 10)
        shift = (b["labels"][:, None, None, None] / 10.0) * 2.0 - 1.0
        b["images"] = (b["images"] * 0.1 + shift).astype(np.float32)
        batches.append(b)
    losses = [float(sess.run("loss", feed_dict=batches[i % 2]))
              for i in range(120)]
    assert sess.state.model_state is None
    # alternating two batches oscillates step to step: judge a late window
    # (tests/test_cnn.py's criterion)
    assert np.mean(losses[-20:]) < losses[0] * 0.5, losses
    sess.close()


# -- the zoo ------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(tcnn.MODEL_REGISTRY))
def test_registry_models_build_on_meta(name):
    module, size = tcnn.build_module(name, num_classes=10)
    model = tcnn.build_model(name, num_classes=10)
    params, state = model.call_init(torch.Generator(), "meta")
    stats = state["batch_stats"] if model.stateful else {}
    logits, _ = _nn.apply(module, params, stats,
                          torch.empty((2, size, size, 3), device="meta"),
                          train=False)
    assert logits.shape == (2, 10)
    batch = {"images": torch.empty((2, size, size, 3), device="meta"),
             "labels": torch.empty((2,), dtype=torch.int32, device="meta")}
    loss, metrics, _ = model.call_loss(params, batch, torch.Generator(),
                                       state)
    assert loss.shape == () and set(metrics) == {"accuracy"}


def test_resnet50_param_count_and_unknown_name():
    params, state = tcnn.build_model("resnet50_v1.5").call_init(
        torch.Generator(), "meta")
    n = sum(t.numel() for _, t in tclassify.flatten(params))
    assert 25.4e6 < n < 25.7e6, n
    assert len(tclassify.flatten(state)) == 2 * 53     # 53 BatchNorms
    with pytest.raises(ValueError, match="unknown model"):
        tcnn.build_model("resnet9000")


def _flax_layout(tree):
    """A port tree as flax holds it: OIHW conv kernels back to HWIO."""
    return {k: _flax_layout(v) if isinstance(v, dict) else _as_jax_layout(v)
            for k, v in tree.items()}


# Small image sizes: VGG's five pools need 32 px. At batch 2, DenseNet's
# and Inception-v3's last BatchNorms would see 2 values a channel on 1x1
# maps, where either package's fp32 forward is 1e-2 to 2e-1 of the peak
# off a float64 run; at 64 and 139 px they see 8 and 18. Inception-v3's
# 94 BatchNorms keep the JAX forward 2e-4 of its peak off float64 even
# there (the port's 8e-5), so it is held to 1e-3, the rest to 1e-4.
# ResNet-50 v1 (the stride on the first 1x1 of each block, not the 3x3)
# gives the same logits as v1.5 from one initial tree, since each block's
# last BatchNorm scale is zero; only its batch statistics tell the two
# apart, at batch 4 and 64 px.
ZOO = [("lenet", jzoo.LeNet, tzoo.LeNet, 28, 1e-4, 2),
       ("vgg11", jzoo.VGG11, tzoo.VGG11, 32, 1e-4, 2),
       ("googlenet", jzoo.GoogLeNet, tzoo.GoogLeNet, 32, 1e-4, 2),
       ("inception3", jzoo.InceptionV3, tzoo.InceptionV3, 139, 1e-3, 2),
       ("densenet121", jzoo.DenseNet, tzoo.DenseNet, 64, 1e-4, 2),
       ("resnet50", lambda **kw: jresnet.ResNet50(v1_5=False, **kw),
        lambda **kw: tresnet.ResNet50(v1_5=False, **kw), 64, 1e-4, 4)]


@pytest.mark.parametrize("name,jmod,tmod,size,tol,batch", ZOO,
                         ids=[z[0] for z in ZOO])
def test_zoo_forward_matches_jax(name, jmod, tmod, size, tol, batch):
    """The port's own initial tree, in flax's layout, runs the JAX module
    (which checks every name and shape) and comes back through
    ``cnn_params_from_jax`` unchanged."""
    jmodule = jmod(num_classes=CLASSES, dtype=jnp.float32)
    tmodule = tmod(num_classes=CLASSES, dtype=torch.float32)
    x = np.random.default_rng(4).standard_normal(
        (batch, size, size, 3)).astype(np.float32)
    params, stats = _nn.init(tmodule, torch.Generator().manual_seed(1),
                             "cpu", size)
    variables = {"params": _flax_layout(params)}
    if stats:
        variables["batch_stats"] = _flax_layout(stats)
    want, upd = jax.jit(lambda v, x: jmodule.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    carried, state = cnn_params_from_jax(variables, tmodule, CLASSES, size,
                                         "cpu")
    assert (state is not None) == bool(stats)
    for (path, a), (_, b) in zip(tclassify.flatten(params),
                                 tclassify.flatten(carried)):
        assert torch.equal(a, b), path
    with torch.no_grad():
        got, new = _nn.apply(tmodule, params, stats, torch.from_numpy(x))
    _close_to_peak(got.numpy(), want, tol, name)
    if stats:
        want_stats = _paths(upd["batch_stats"])
        got_stats = dict(tclassify.flatten(new))
        assert set(got_stats) == set(want_stats)
        for path, w in want_stats.items():
            _close_to_peak(got_stats[path].numpy(), w, tol, path)
