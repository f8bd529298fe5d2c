"""The port's drivers (``parallax_tpu_torch/examples/``) against the JAX
package's (``examples/``, loaded by path and run as they are), on the CPU
at small widths.

* The training drivers whose step draws no random numbers (simple, NMT,
  long-context, CNN) resume from one checkpoint the JAX driver wrote:
  the JAX driver and the port's, each from its own copy, then log the
  same steps; every step's loss agrees to 1e-4 (absolute and relative).
  The NMT and long-context drivers build their configs with the models'
  default bf16 compute; both packages' configs are switched to fp32
  here so that 1e-4 holds (the drivers' flags are untouched). The CNN
  zoo's layers compute in bf16 with no switch: its losses agree to 2e-3
  relative (bf16's unit roundoff is 3.9e-3).
  Drivers without checkpoint flags get a ``CheckPointConfig`` through
  the packages' ``Config``.
* ``lm1b_eval`` and ``nmt_eval`` evaluate a checkpoint the JAX driver
  wrote: the port's perplexity within 1e-5 relative of the JAX eval
  script's, and the greedy and beam hypotheses and BLEU identical
  (fp32 configs); ``cnn_eval``'s top-1 accuracy equals JAX's.
* ``lm1b_driver`` (its sampled softmax draws from each package's own
  generator) and ``skip_thoughts_driver`` are held to finite, falling
  losses; the LM1B driver's checkpoint is held through ``lm1b_eval``'s
  exact-softmax perplexity computed by both eval scripts.
"""

import importlib.util
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

import parallax_tpu as jpx
import parallax_tpu_torch as tpx
from parallax_tpu import session as jsession
from parallax_tpu.models import long_context as jlc
from parallax_tpu.models import nmt as jnmt
from parallax_tpu_torch import session as tsession
from parallax_tpu_torch.examples import (cnn_benchmark_driver, cnn_eval,
                                         lm1b_driver, lm1b_eval,
                                         long_context_driver, nmt_driver,
                                         nmt_eval, simple_driver,
                                         skip_thoughts_driver)
from parallax_tpu_torch.models import long_context as tlc
from parallax_tpu_torch.models import nmt as tnmt

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4
STEP = re.compile(r"^step (\d+): loss (\S+)", re.M)


def _jax_driver(name):
    """The JAX package's ``examples/<name>.py``, loaded as it is."""
    spec = importlib.util.spec_from_file_location(
        f"jax_examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(monkeypatch, name, argv):
    monkeypatch.setattr("sys.argv", [f"{name}.py"] + list(argv))
    return _jax_driver(name).main()


def _record_losses(monkeypatch):
    """Every training step's loss, of both packages' sessions."""
    losses = {"jax": [], "torch": []}
    for key, cls in (("jax", jsession.ParallaxSession),
                     ("torch", tsession.ParallaxSession)):
        orig = cls.run

        def run(self, fetches=None, feed_dict=None, _orig=orig, _key=key):
            out = _orig(self, fetches, feed_dict)
            if isinstance(fetches, list) and fetches[:1] == ["loss"]:
                losses[_key].append(float(out[0]))
            return out
        monkeypatch.setattr(cls, "run", run)
    return losses


CONFIGS = {jpx: jpx.Config, tpx: tpx.Config}


def _with_ckpt(monkeypatch, ckpt_dir, every):
    """Both packages' ``Config`` with a checkpoint directory (for the
    drivers that have no checkpoint flags)."""
    for pkg, orig in CONFIGS.items():

        def config(*a, _orig=orig, _pkg=pkg, **kw):
            kw["ckpt_config"] = _pkg.CheckPointConfig(
                ckpt_dir=str(ckpt_dir), save_ckpt_steps=every)
            return _orig(*a, **kw)
        monkeypatch.setattr(pkg, "Config", config)


def _fp32(monkeypatch, jmod, tmod, name):
    """``<name>`` of both model modules building fp32 configs."""
    for mod, dt in ((jmod, jnp.float32), (tmod, torch.float32)):
        orig = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _o=orig, _dt=dt, **kw:
            _o(*a, **{"compute_dtype": _dt, **kw}))


def _steps(out):
    return [int(s) for s, _ in STEP.findall(out)]


def _resume_both(monkeypatch, capsys, tmp_path, name, port_main, argv,
                 ckpt_argv=None, every=None):
    """The JAX driver writes a checkpoint; the JAX and the port driver
    each resume from a copy of it. Returns (jax losses, port losses,
    jax log, port log)."""
    steps = int(argv[argv.index("--max_steps") + 1]) \
        if "--max_steps" in argv else int(argv[argv.index("--steps") + 1])
    write = tmp_path / "written"

    def ckpt(path, save):
        if ckpt_argv is not None:
            return ckpt_argv(path, save)
        _with_ckpt(monkeypatch, path, save)
        return []

    _run_jax(monkeypatch, name, argv + ckpt(write, steps))
    capsys.readouterr()
    losses = _record_losses(monkeypatch)
    for who in ("jax", "torch"):
        shutil.copytree(write, tmp_path / who)
    _run_jax(monkeypatch, name, argv + ckpt(tmp_path / "jax", 10 ** 6))
    jlog = capsys.readouterr().out
    port_main(argv + ckpt(tmp_path / "torch", 10 ** 6) + ["--device", "cpu"])
    tlog = capsys.readouterr().out
    assert _steps(tlog) == _steps(jlog) and _steps(jlog)[0] > steps, \
        (jlog, tlog)
    assert len(losses["torch"]) == len(losses["jax"]) == steps
    return losses["jax"], losses["torch"], jlog, tlog


def test_simple_driver_resumes_jax_checkpoint(monkeypatch, capsys,
                                              tmp_path):
    argv = ["--steps", "10", "--batch_size", "16"]
    jl, tl, jlog, tlog = _resume_both(monkeypatch, capsys, tmp_path,
                                      "simple_driver", simple_driver.main,
                                      argv)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert "learned w=" in tlog


def test_nmt_driver_resumes_jax_checkpoint(monkeypatch, capsys, tmp_path):
    _fp32(monkeypatch, jnmt, tnmt, "NMTConfig")
    argv = ["--vocab_size", "64", "--model_dim", "16", "--num_layers", "1",
            "--batch_size", "8", "--src_len", "8", "--tgt_len", "8",
            "--max_steps", "3", "--log_frequency", "1"]
    jl, tl, _, tlog = _resume_both(monkeypatch, capsys, tmp_path,
                                   "nmt_driver", nmt_driver.main, argv)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert "target words/sec" in tlog


def test_long_context_driver_resumes_jax_checkpoint(monkeypatch, capsys,
                                                    tmp_path):
    _fp32(monkeypatch, jlc, tlc, "LongContextConfig")
    argv = ["--vocab_size", "64", "--model_dim", "16", "--num_layers", "1",
            "--batch_size", "2", "--seq_len", "16", "--max_steps", "3",
            "--log_frequency", "1"]
    jl, tl, _, tlog = _resume_both(monkeypatch, capsys, tmp_path,
                                   "long_context_driver",
                                   long_context_driver.main, argv)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert "tokens/sec" in tlog


def test_cnn_driver_and_eval_resume_jax_checkpoint(monkeypatch, capsys,
                                                   tmp_path):
    argv = ["--model", "lenet", "--batch_size", "8", "--image_size", "28",
            "--num_classes", "10", "--max_steps", "3", "--log_frequency",
            "1"]
    jl, tl, _, tlog = _resume_both(
        monkeypatch, capsys, tmp_path, "cnn_benchmark_driver",
        cnn_benchmark_driver.main, argv,
        ckpt_argv=lambda path, save: ["--ckpt_dir", str(path),
                                      "--save_ckpt_steps", str(save)])
    # the zoo's layers compute in bf16 (unit roundoff 3.9e-3)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert "images/sec" in tlog
    eval_argv = ["--ckpt_dir", str(tmp_path / "written"), "--model",
                 "lenet", "--num_classes", "10", "--image_size", "28",
                 "--batch_size", "8", "--eval_batches", "2"]
    _run_jax(monkeypatch, "cnn_eval", eval_argv)
    jout = capsys.readouterr().out
    cnn_eval.main(eval_argv + ["--device", "cpu"])
    tout = capsys.readouterr().out
    assert "restored step 3" in tout
    assert tout.splitlines()[-1] == jout.splitlines()[-1]


LM1B_DIMS = ["--vocab_size", "64", "--emb_dim", "16", "--hidden_dim", "32",
             "--proj_dim", "16"]


def _lm1b_ppl(monkeypatch, capsys, ckpt_dir):
    """Both eval scripts' perplexity of ``ckpt_dir``."""
    argv = ["--ckpt_dir", str(ckpt_dir)] + LM1B_DIMS + [
        "--batch_size", "4", "--num_steps", "5", "--eval_batches", "2"]
    _run_jax(monkeypatch, "lm1b_eval", argv)
    jout = capsys.readouterr().out
    lm1b_eval.main(argv + ["--device", "cpu"])
    tout = capsys.readouterr().out
    assert jout.splitlines()[0] == tout.splitlines()[0]   # restored step
    ppl = [float(o.split("perplexity:")[1]) for o in (jout, tout)]
    # the printed value has two decimals: hold the functions too
    return ppl, argv


def test_lm1b_eval_reproduces_jax_on_both_drivers(monkeypatch, capsys,
                                                  tmp_path):
    # the JAX eval script restores into the dense model's template, so
    # it cannot read a checkpoint of the driver's default slices mode
    # (CheckpointTreeMismatch; ROADMAP Queue C): both drivers train dense
    # for the JAX eval, and the port's eval reads the port driver's
    # default (slices) checkpoint too
    train = LM1B_DIMS + ["--num_samples", "16", "--batch_size", "16",
                         "--num_steps", "5", "--max_steps", "40",
                         "--log_frequency", "5", "--save_ckpt_steps", "40"]
    dense = ["--sparse_grad_mode", "dense"]
    _run_jax(monkeypatch, "lm1b_driver",
             train + dense + ["--ckpt_dir", str(tmp_path / "jax")])
    capsys.readouterr()
    for mode, where in ((dense, "port"), ([], "slices")):
        losses = lm1b_driver.main(train + mode + [
            "--ckpt_dir", str(tmp_path / where), "--lstm_impl", "pallas",
            "--device", "cpu"])
        tlog = capsys.readouterr().out
        assert "words/sec" in tlog and len(losses) == 8
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    ppl = lm1b_eval.main(["--ckpt_dir", str(tmp_path / "slices")]
                         + LM1B_DIMS + ["--batch_size", "4", "--num_steps",
                                        "5", "--eval_batches", "2",
                                        "--device", "cpu"])
    assert "restored step 40" in capsys.readouterr().out
    assert np.isfinite(ppl) and 1.0 < ppl < 64.0
    jeval = _jax_driver("lm1b_eval")
    for who in ("jax", "port"):
        ppl, _ = _lm1b_ppl(monkeypatch, capsys, tmp_path / who)
        assert np.isfinite(ppl[1])
        np.testing.assert_allclose(ppl[1], ppl[0], rtol=1e-5, atol=0.01)
        # unrounded: the evaluate functions on the same params
        jcfg = jeval.lm1b.LM1BConfig(
            vocab_size=64, emb_dim=16, hidden_dim=32, proj_dim=16,
            num_partitions=jpx.get_partitioner(None), keep_prob=1.0,
            compute_dtype=jnp.float32)
        tcfg = lm1b_eval.lm1b.LM1BConfig(
            vocab_size=64, emb_dim=16, hidden_dim=32, proj_dim=16,
            keep_prob=1.0, compute_dtype=torch.float32, lstm_impl="kernel")
        rng = np.random.default_rng(9)
        batches = [jeval.lm1b.make_batch(rng, 4, 5, 64) for _ in range(2)]
        jp, _ = jeval.restore_params(str(tmp_path / who), jcfg)
        tp, _ = lm1b_eval.restore_params(str(tmp_path / who), tcfg, "cpu")
        np.testing.assert_allclose(lm1b_eval.evaluate(tp, tcfg, batches),
                                   jeval.evaluate(jp, jcfg, batches),
                                   rtol=1e-5)


def test_nmt_eval_reproduces_jax(monkeypatch, capsys, tmp_path):
    _fp32(monkeypatch, jnmt, tnmt, "NMTConfig")
    _with_ckpt(monkeypatch, tmp_path / "ckpt", 2)
    _run_jax(monkeypatch, "nmt_driver",
             ["--vocab_size", "64", "--model_dim", "16", "--num_layers",
              "1", "--batch_size", "8", "--src_len", "8", "--tgt_len", "8",
              "--max_steps", "2", "--log_frequency", "1"])
    eval_argv = ["--ckpt_dir", str(tmp_path / "ckpt"), "--vocab_size", "64",
                 "--model_dim", "16", "--num_layers", "1", "--max_len", "8",
                 "--eval_batches", "2", "--batch_size", "4"]
    capsys.readouterr()
    jeval = _jax_driver("nmt_eval")
    monkeypatch.setattr("sys.argv", ["nmt_eval.py"] + eval_argv)
    jeval.main()
    jout = capsys.readouterr().out
    bleu = nmt_eval.main(eval_argv + ["--device", "cpu"])
    tout = capsys.readouterr().out
    assert tout == jout and np.isfinite(bleu)
    jcfg = jnmt.NMTConfig(vocab_size=64, model_dim=16, num_layers=1,
                          max_len=8)
    tcfg = tnmt.NMTConfig(vocab_size=64, model_dim=16, num_layers=1,
                          max_len=8)
    jp, _ = jeval.restore_params(str(tmp_path / "ckpt"), jcfg)
    tp, _ = nmt_eval.restore_params(str(tmp_path / "ckpt"), tcfg, "cpu")
    rng = np.random.default_rng(4)
    src = rng.integers(3, 64, (4, 4)).astype(np.int32)
    pairs = [(src, np.concatenate([src, np.full((4, 1), 2, np.int32)], 1))]
    for beam in (1, 4):
        jb, jh = jeval.decode_and_bleu(jp, jcfg, pairs, beam_width=beam)
        tb, th = nmt_eval.decode_and_bleu(tp, tcfg, pairs, beam_width=beam)
        assert th == jh and tb == jb


def test_skip_thoughts_driver_losses_fall(capsys):
    # the synthetic sentences are uniform over ids [1, V): what the model
    # can learn is that 0 never comes, from ln V towards ln (V - 1), a
    # fall a vocabulary of 4 makes large
    losses = skip_thoughts_driver.main(
        ["--vocab_size", "4", "--emb_dim", "16", "--hidden_dim", "32",
         "--batch_size", "16", "--seq_len", "6", "--max_steps", "40",
         "--log_frequency", "10", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "owns 256 shards" in out and "steps/sec" in out
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert np.all(np.diff(losses) < 0) and losses[0] < np.log(4) + 1e-2
