"""The linear-regression smoke model through both packages' sessions.

``examples/simple_driver.py``'s run: ``simple.build_model(0.1)``, 60
batches of 64 from ``default_rng(0)``, then one more ``run(None)`` whose
``w`` and ``b`` fetches are the values after the 60 updates. The port
starts from the JAX session's initial ``w`` and ``b``
(``simple_params_from_jax``). fp32 in both; the per-step losses agree to
1e-5 relative, and both end at w 10.006 and b -5.003 (to 5e-4).
"""

import jax
import numpy as np
import pytest
import torch

import parallax_tpu as jparallax
import parallax_tpu_torch as tparallax
from parallax_tpu.models import simple as jsimple
from parallax_tpu_torch.models import simple as tsimple
from parallax_tpu_torch.weights import simple_params_from_jax

STEPS, BATCH, LR = 60, 64, 0.1


def _batches():
    rng = np.random.default_rng(0)
    return [jsimple.make_batch(rng, BATCH) for _ in range(STEPS)]


@pytest.mark.parametrize("run_option", ["AR", "HYBRID"])
def test_sixty_steps_match_jax_session(run_option):
    batches = _batches()
    jsess, *_ = jparallax.parallel_run(
        jsimple.build_model(LR), parallax_config=jparallax.Config(
            run_option=run_option, search_partitions=False), seed=0)
    try:
        jsess.prepare(batches[0])
        init = jax.tree.map(np.asarray, jsess.state.params)
        jlosses = [float(jsess.run("loss", feed_dict=b)) for b in batches]
        jout = jsess.run(None, feed_dict=batches[-1])
        jw, jb = float(jout["w"]), float(jout["b"])
    finally:
        jsess.close()

    tsess, *_ = tparallax.parallel_run(
        tsimple.build_model(LR),
        parallax_config=tparallax.Config(run_option=run_option),
        device="cpu")
    tsess.prepare(batches[0])
    with torch.no_grad():
        for k, v in simple_params_from_jax(init, "cpu").items():
            tsess.state.params[k].copy_(v)
    tlosses = [float(tsess.run("loss", feed_dict=b)) for b in batches]
    tout = tsess.run(None, feed_dict=batches[-1])
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[0] > 10 and np.mean(tlosses[-10:]) < 0.02
    assert float(tout["w"]) == pytest.approx(jw, rel=1e-5)
    assert float(tout["b"]) == pytest.approx(jb, rel=1e-5)
    assert float(tout["w"]) == pytest.approx(10.006, abs=5e-4)
    assert float(tout["b"]) == pytest.approx(-5.003, abs=5e-4)
    assert int(tout["global_step"]) == STEPS + 1
    tsess.close()


def test_metric_fetch_holds_the_value_before_the_update():
    """A fetch is read after its step and after later ones; the engine
    updates parameters in place, and the fetched ``w`` stays the value
    the step saw."""
    sess, *_ = tparallax.parallel_run(tsimple.build_model(LR),
                                      device="cpu")
    batches = _batches()[:3]
    sess.prepare(batches[0])
    w0 = float(sess.state.params["w"][0].detach())
    first = sess.run("w", feed_dict=batches[0])
    sess.run("loss", feed_dict=batches[1])
    sess.run("loss", feed_dict=batches[2])
    assert float(sess.state.params["w"][0].detach()) != w0
    assert float(first) == w0
    sess.close()


def test_simple_params_from_jax_checks_shapes():
    with pytest.raises(ValueError, match="shape"):
        simple_params_from_jax({"w": np.zeros(2), "b": np.zeros(1)}, "cpu")
    out = simple_params_from_jax({"w": np.ones(1), "b": np.zeros(1)}, "cpu")
    assert out["w"].dtype == torch.float32 and out["w"].shape == (1,)
